"""The port's InceptionV3 FID extractor against the JAX package's.

On one random torchvision-format state dict (the repository ships no
weights; parity is about the graph, the fold and the preprocessing):

- ``InceptionV3`` against JAX ``inception_v3_features`` in both variants
  on [2, 299, 299, 3] in [-1, 1]: rtol 1e-3, atol 1e-3 of the mean
  |feature|, the JAX package's own tolerance for its graph against a
  torch oracle (``tests/test_metrics.py``);
- ``pil_bicubic_resize`` against JAX's and against PIL at the JAX test's
  three shapes, atol 2e-3 on the 0..255 scale;
- the extractor end to end on uint8 one-channel images against JAX
  ``make_extractor``: rtol 2e-3 (atol 2e-3 of the mean |feature|);
- weights from a ``.npz`` and from a torch checkpoint through
  ``OTM_INCEPTION_WEIGHTS``, equal to the state dict folded in memory; an
  unusable file falls back;
- ``default_extractor``'s three branches, and a Trainer with
  ``tpu.require_inception_fid = true`` evaluating with Inception, the
  extractor's name in its log and ``metrics.jsonl``.
"""

import json

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from one_to_many_gan_torch.config import load_config
from one_to_many_gan_torch.core.trainer import Trainer
from one_to_many_gan_torch.data import synthetic_images
from one_to_many_gan_torch.metrics import fid as port_fid
from one_to_many_gan_torch.metrics import inception as port_inception
from one_to_many_gan_torch.metrics import inception_v3 as port_iv3
from one_to_many_gan_torch.ops.resample import pil_bicubic_resize
from one_to_many_gan_tpu.metrics import inception_jax
from one_to_many_gan_tpu.ops.resample import pil_bicubic_resize as jax_pil_bicubic_resize
from tests.helpers import write_tiny_config

SEED = 7
VARIANTS = ("clean_fid", "torchvision")
GRAPH_TOL = 1e-3
EXTRACTOR_TOL = 2e-3
RESIZE_ATOL = 2e-3


@pytest.fixture(scope="module")
def state():
    return port_iv3.random_state_dict(SEED)


@pytest.fixture(scope="module")
def images():
    return np.random.default_rng(0).uniform(-1, 1, (2, 299, 299, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def jax_features(state, images):
    """JAX ``inception_v3_features`` of ``images`` per variant, each
    variant compiled once."""
    params = inception_jax.fold_state_dict(state)
    out = {}
    for variant in VARIANTS:
        forward = jax.jit(lambda p, x, v=variant: inception_jax.inception_v3_features(p, x, v))
        out[variant] = np.asarray(forward(params, images))
    return out


def _close(got, want, tol):
    scale = np.abs(want).mean()
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale)


@pytest.mark.parametrize("variant", VARIANTS)
def test_inception_v3_matches_jax(state, images, jax_features, variant):
    model = port_iv3.from_torchvision_state(state, variant)
    with torch.no_grad():
        got = model(torch.from_numpy(images).permute(0, 3, 1, 2)).numpy()
    assert got.shape == (2, 2048) and got.dtype == np.float32
    _close(got, jax_features[variant], GRAPH_TOL)
    other = VARIANTS[1 - VARIANTS.index(variant)]
    assert np.abs(jax_features[variant] - jax_features[other]).max() > 0  # the variants differ


def test_fold_checks_shapes_and_keys(state):
    bad = dict(state, **{"Mixed_5b.branch1x1.conv.weight": np.zeros((64, 191, 1, 1), np.float32)})
    with pytest.raises(ValueError, match=r"Mixed_5b.branch1x1: expected \(64, 192, 1, 1\)"):
        port_iv3.from_torchvision_state(bad)
    with pytest.raises(KeyError):
        port_iv3.from_torchvision_state({k: v for k, v in state.items() if "Mixed_7c" not in k})
    with pytest.raises(ValueError, match="unknown inception variant"):
        port_iv3.InceptionV3("tf")


@pytest.mark.parametrize(("h", "w", "oh", "ow"), [(64, 48, 299, 299), (299, 299, 64, 64),
                                                  (100, 70, 37, 81)])
def test_pil_bicubic_resize_matches_jax_and_pil(h, w, oh, ow):
    x = (np.random.default_rng(h + w).random((h, w)) * 255).astype(np.float32)
    pil = np.asarray(Image.fromarray(x, mode="F").resize((ow, oh), Image.Resampling.BICUBIC))
    want = np.asarray(jax_pil_bicubic_resize(x[None, :, :, None], oh, ow))[0, :, :, 0]
    got = pil_bicubic_resize(torch.from_numpy(x)[None, None], oh, ow)[0, 0].numpy()
    np.testing.assert_allclose(got, want, atol=RESIZE_ATOL)
    np.testing.assert_allclose(got, pil, atol=RESIZE_ATOL)


@pytest.fixture(scope="module")
def u8_images():
    return (np.random.default_rng(3).random((3, 64, 48, 1)) * 255).astype(np.uint8)


@pytest.fixture(scope="module")
def port_features(state, u8_images):
    """The port's extractor on ``u8_images``, two images a forward."""
    model = port_iv3.from_torchvision_state(state)
    return port_iv3.make_extractor(model, batch=2, device="cpu")(u8_images)


def test_extractor_matches_jax_end_to_end(state, u8_images, port_features):
    want = inception_jax.make_extractor(inception_jax.fold_state_dict(state))(u8_images)
    assert port_features.shape == (3, 2048) and port_features.dtype == np.float32
    _close(port_features, want, EXTRACTOR_TOL)


def test_extractor_leaves_tf32_as_it_found_it(state, u8_images):
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
        model = port_iv3.from_torchvision_state(state)
        port_iv3.make_extractor(model, device="cpu")(u8_images[:1])
        assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


@pytest.fixture(scope="module")
def weight_files(state, tmp_path_factory):
    root = tmp_path_factory.mktemp("weights")
    npz, pt = root / "inception_v3.npz", root / "inception_v3.pt"
    np.savez(npz, **state)
    torch.save({k: torch.from_numpy(v) for k, v in state.items()}, pt)
    return {"npz": npz, "pt": pt}


@pytest.mark.parametrize("kind", ["npz", "pt"])
def test_weights_load_through_the_environment(state, weight_files, u8_images, port_features,
                                              monkeypatch, kind):
    loaded = port_iv3.load_state_dict_file(weight_files[kind])
    assert loaded.keys() == state.keys()
    assert all(np.array_equal(loaded[k], state[k]) for k in state)
    monkeypatch.setenv(port_inception.WEIGHTS_ENV, str(weight_files[kind]))
    extractor = port_inception.try_load_inception("cpu")
    assert extractor is not None
    np.testing.assert_array_equal(extractor(u8_images), port_features)


def test_unusable_weights_fall_back(tmp_path, monkeypatch, capsys):
    bad = tmp_path / "inception_bad.npz"
    np.savez(bad, nonsense=np.zeros(3))
    monkeypatch.setenv(port_inception.WEIGHTS_ENV, str(bad))
    assert port_inception.try_load_inception("cpu") is None
    assert "unusable" in capsys.readouterr().out
    not_a_checkpoint = tmp_path / "inception_bad.pt"
    not_a_checkpoint.write_bytes(b"not a checkpoint")
    monkeypatch.setenv(port_inception.WEIGHTS_ENV, str(not_a_checkpoint))
    assert port_inception.try_load_inception("cpu") is None


def test_weights_are_found_in_the_hub_cache(tmp_path, monkeypatch, weight_files):
    monkeypatch.delenv(port_inception.WEIGHTS_ENV, raising=False)
    monkeypatch.setenv("HOME", str(tmp_path))
    assert port_inception._find_weights() is None
    cache = tmp_path / ".cache/torch/hub/checkpoints"
    cache.mkdir(parents=True)
    (cache / "pt_inception-2015-12-05.pth").write_bytes(b"")
    assert port_inception._find_weights() == cache / "pt_inception-2015-12-05.pth"
    (cache / "inception_v3_google.pth").write_bytes(b"")
    assert port_inception._find_weights() == cache / "inception_v3_google.pth"
    monkeypatch.setenv(port_inception.WEIGHTS_ENV, str(weight_files["npz"]))
    assert port_inception._find_weights() == weight_files["npz"]


def test_default_extractor_branches(weight_files, u8_images, port_features, monkeypatch):
    monkeypatch.delenv(port_inception.WEIGHTS_ENV, raising=False)
    # with weights: Inception, under require_inception too
    monkeypatch.setattr(port_inception, "_find_weights", lambda: weight_files["npz"])
    for require in (False, True):
        extractor, name = port_fid.default_extractor(require_inception=require, device="cpu")
        assert name == "inception_v3_pool3"
        np.testing.assert_array_equal(extractor(u8_images), port_features)
    # without: the projection, or the refusal
    monkeypatch.setattr(port_inception, "_find_weights", lambda: None)
    extractor, name = port_fid.default_extractor(device="cpu")
    assert name == "random_projection_v1"
    assert extractor(u8_images).shape == (3, 256)
    with pytest.raises(port_fid.InceptionUnavailableError, match="require_inception_fid"):
        port_fid.default_extractor(require_inception=True, device="cpu")


def test_trainer_evaluates_with_inception_under_require_inception(tmp_path, weight_files,
                                                                   monkeypatch):
    """A config with ``require_inception_fid = true`` trains and evaluates
    on the port once weights are given; the extractor's name reaches the
    log and ``metrics.jsonl`` (TensorBoard takes their numbers only, as
    in the JAX package). The Fréchet distance's matrix square root of
    2048 features takes ~20 s on a CPU: here it is the means' term alone,
    on the same 2048-feature statistics (``tests/test_torch_metrics.py``
    holds ``frechet_distance`` itself to the JAX package's)."""
    dims = []

    def means_term(stats1, stats2):
        dims.append((stats1.sigma.shape, stats2.sigma.shape))
        return float(np.sum((stats1.mu - stats2.mu) ** 2))

    monkeypatch.setattr(port_fid, "frechet_distance", means_term)
    monkeypatch.setenv(port_inception.WEIGHTS_ENV, str(weight_files["pt"]))
    config = load_config(write_tiny_config(
        tmp_path, tpu_section="\n[tpu]\nrequire_inception_fid = true\n", training_steps=1,
        checkpoint_interval=1, log_interval=1, n_evaluation_images=4))
    threads = torch.get_num_threads()
    try:
        torch.set_num_threads(1)
        trainer = Trainer(config, shoeprint_images=synthetic_images(8, (32, 32), seed=0),
                          shoemark_images=synthetic_images(8, (32, 32), seed=1),
                          verbose=False, device="cpu")
        assert trainer.run().step == 1
    finally:
        torch.set_num_threads(threads)
    assert dims == [((2048, 2048), (2048, 2048))]
    run = config["training"]["checkpoint_directory"] / config["training"]["training_run"]
    fid_lines = [ln for ln in (run / "log").read_text().splitlines() if " | fid: " in ln]
    assert len(fid_lines) == 1 and fid_lines[0].endswith("[inception_v3_pool3]")
    records = [json.loads(ln) for ln in (run / "metrics.jsonl").read_text().splitlines()]
    evals = [r for r in records if "fid" in r]
    assert [r["fid_extractor"] for r in evals] == ["inception_v3_pool3"]
    assert np.isfinite(evals[0]["fid"]) and np.isfinite(evals[0]["kid"])
