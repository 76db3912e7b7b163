"""The port's FID/KID against the JAX package's ``metrics/fid.py``.

The distances are numpy in both packages: equal to rtol 1e-12 on the
same features. The ``random_projection_v1`` extractor is torch in the
port, with weights read from a committed file: those weights must be the
JAX package's ``key(1234)`` draws exactly, and the features the JAX
extractor's to 1e-5 of their largest magnitude (the port convolves in
float64, JAX in float32: the features' own rounding is ~1e-7 of that
scale, and a near-zero feature can differ by more than 1e-5 of itself).
"""

import jax
import numpy as np
import pytest
import torch

from one_to_many_gan_torch.data import synthetic_images
from one_to_many_gan_torch.metrics import fid as port_fid
from one_to_many_gan_tpu.metrics import fid as jax_fid

FEATURE_TOL = 1e-5


@pytest.fixture(autouse=True)
def no_inception_weights(monkeypatch):
    """The default extractor here is the projection, whatever InceptionV3
    weights lie on the machine (``tests/test_torch_inception.py`` gives it
    weights)."""
    from one_to_many_gan_torch.metrics import inception

    monkeypatch.delenv(inception.WEIGHTS_ENV, raising=False)
    monkeypatch.setattr(inception, "_find_weights", lambda: None)


def _features(n: int, d: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


@pytest.mark.parametrize(("n1", "n2", "d"), [(40, 50, 8), (6, 9, 16), (30, 30, 4)])
def test_frechet_distance_equals_jax(n1, n2, d):
    """Also with fewer samples than features (6 and 9 in 16 dimensions:
    singular covariances, the eps retry's case)."""
    a, b = _features(n1, d, 1), _features(n2, d, 2) * 1.5 + 0.3
    got = port_fid.frechet_distance(port_fid.compute_stats(a), port_fid.compute_stats(b))
    want = jax_fid.frechet_distance(jax_fid.compute_stats(a), jax_fid.compute_stats(b))
    assert np.isfinite(got)
    np.testing.assert_allclose(got, want, rtol=1e-12)


@pytest.mark.parametrize(("subset", "subsets"), [(1000, 100), (7, 5)])
def test_kernel_distance_equals_jax(subset, subsets):
    a, b = _features(20, 8, 3), _features(25, 8, 4) + 0.5
    got = port_fid.kernel_distance(a, b, subset_size=subset, num_subsets=subsets)
    want = jax_fid.kernel_distance(a, b, subset_size=subset, num_subsets=subsets)
    np.testing.assert_allclose(got, want, rtol=1e-12)


def test_compute_stats_equals_jax():
    a = _features(12, 5, 6)
    got, want = port_fid.compute_stats(a), jax_fid.compute_stats(a)
    np.testing.assert_array_equal(got.mu, want.mu)
    np.testing.assert_array_equal(got.sigma, want.sigma)


def test_committed_projection_weights_are_the_jax_draws():
    """The file equals ``random_projection_extractor``'s draws: four
    normals from ``split(key(1234), 4)``, each scaled by 1/sqrt(fan-in)."""
    keys = jax.random.split(jax.random.key(1234), 4)
    want = {
        "w0": jax.random.normal(keys[0], (5, 5, 1, 16)) / np.sqrt(25),
        "w1": jax.random.normal(keys[1], (3, 3, 16, 32)) / np.sqrt(9 * 16),
        "w2": jax.random.normal(keys[2], (3, 3, 32, 64)) / np.sqrt(9 * 32),
        "proj": jax.random.normal(keys[3], (128, 256)) / np.sqrt(128),
    }
    with np.load(port_fid.PROJECTION_WEIGHTS) as z:
        assert sorted(z.files) == sorted(want)
        assert sum(z[k].size for k in z.files) == 56_208
        for k, v in want.items():
            assert z[k].dtype == np.float32
            np.testing.assert_array_equal(z[k], np.asarray(v))


@pytest.fixture(scope="module")
def jax_extractor():
    return jax_fid.random_projection_extractor()


@pytest.mark.parametrize(("size", "channels"), [(64, 1), (256, 1), (48, 3)])
def test_projection_features_match_jax(jax_extractor, size, channels):
    """At the extractor's 64x64 (66 images: batches of 64 and 2), and
    resized from 256x256 and from a 48x48 RGB image (channel mean)."""
    images = synthetic_images(66 if size == 64 else 2, (size, size), channels, seed=size)
    got = port_fid.random_projection_extractor("cpu")(images)
    want = jax_extractor(images)
    assert got.dtype == np.float32 and got.shape == want.shape == (len(images), 256)
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= FEATURE_TOL * scale


def test_compute_fid_and_kid_from_directories(tmp_path, jax_extractor):
    """Directories of PNGs through ``_load_dir``; the port's extractor
    against the JAX one on the same files: FID and KID agree to 1e-4
    (the features' 1e-6-relative difference moves them no more)."""
    from one_to_many_gan_torch.data import write_synthetic_dataset_dirs

    write_synthetic_dataset_dirs(tmp_path / "a", n_train=12, n_test=1, image_size=(64, 64),
                                 seed=0)
    write_synthetic_dataset_dirs(tmp_path / "b", n_train=12, n_test=1, image_size=(64, 64),
                                 seed=5)
    a, b = tmp_path / "a" / "train", tmp_path / "b" / "train"
    np.testing.assert_array_equal(port_fid._load_dir(a), jax_fid._load_dir(a))
    extractor = port_fid.random_projection_extractor("cpu")
    fid = port_fid.compute_fid(a, b, extractor)
    assert fid > 0
    np.testing.assert_allclose(fid, jax_fid.compute_fid(a, b, jax_extractor), rtol=1e-4)
    kid = port_fid.compute_kid(str(a), str(b), extractor, subset_size=10, num_subsets=4)
    want = jax_fid.compute_kid(str(a), str(b), jax_extractor, subset_size=10, num_subsets=4)
    np.testing.assert_allclose(kid, want, rtol=1e-4)
    # one array and one directory; the default extractor is the projection
    np.testing.assert_allclose(port_fid.compute_fid(port_fid._load_dir(a), b, device="cpu"), fid,
                               rtol=1e-12)


def test_default_extractor_is_the_projection_or_refuses():
    extractor, name = port_fid.default_extractor(device="cpu")
    assert name == "random_projection_v1"
    assert extractor(synthetic_images(2, (64, 64))).shape == (2, 256)
    with pytest.raises(port_fid.InceptionUnavailableError, match="require_inception_fid"):
        port_fid.default_extractor(require_inception=True)


def test_fid_entry_points_default_to_cuda_and_raise_without_it(tmp_path):
    """The package's rule: None means ``cuda``, and no GPU raises."""
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: the default device is usable")
    images = synthetic_images(2, (64, 64))
    for call in (
        port_fid.random_projection_extractor,
        port_fid.default_extractor,
        lambda: port_fid.compute_fid(images, images),
        lambda: port_fid.compute_kid(images, images, subset_size=2, num_subsets=1),
    ):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
