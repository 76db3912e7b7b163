"""The port's C++ image loader (``data/native.py``) against the JAX
package's native runtime, byte for byte, on the CPU.

Both build the same C++ source (the port's copy in ``csrc/loader.cpp``)
and link libjpeg and libpng, whose headers the host must have. On
``write_synthetic_dataset_dirs`` folders: ``load_images`` at the images'
own size and resized, grayscale and RGB, with one thread and several;
``assemble_batch`` with and without flips; the datasets built with
``native=True``; the same errors for files that are missing or are no
image. The port builds into ``build/kernels/`` and, where it cannot build,
raises with the compiler's message instead of falling back to PIL.
"""

import importlib

import numpy as np
import pytest

from one_to_many_gan_torch import data as port_data
from one_to_many_gan_torch.data import native
from one_to_many_gan_tpu import data as jax_data
from one_to_many_gan_tpu import runtime as jax_runtime

build = importlib.import_module("one_to_many_gan_torch.ops.cuda.build")


@pytest.fixture(scope="module")
def folders(tmp_path_factory):
    root = tmp_path_factory.mktemp("native")
    for channels in (1, 3):
        port_data.write_synthetic_dataset_dirs(root / f"c{channels}", n_train=5, n_test=2,
                                               image_size=(40, 36), channels=channels,
                                               seed=channels)
    return root


def _files(root):
    return sorted((root / "train").glob("*.png"))


@pytest.mark.parametrize("threads", [1, 3])
@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("size", [(40, 36), (24, 20), (64, 48)])
def test_load_images_equals_jax_runtime(folders, size, channels, threads):
    files = _files(folders / f"c{channels}")
    got = native.load_images(files, size, channels, threads=threads)
    want = jax_runtime.load_images(files, size, channels, threads=threads)
    assert got.dtype == np.uint8 and got.shape == (len(files), *size, channels)
    np.testing.assert_array_equal(got, want)
    if size == (40, 36):  # at their own size the decode is PIL's too
        np.testing.assert_array_equal(
            got, port_data.ShoeDataset(folders / f"c{channels}", mode="train", image_size=size,
                                       channels=channels).images)


@pytest.mark.parametrize("size", [(40, 36), (20, 18)])
def test_native_datasets_equal_jax(folders, size):
    kw = {"mode": "train", "image_size": size, "channels": 1, "native": True}
    np.testing.assert_array_equal(port_data.ShoeDataset(folders / "c1", **kw).images,
                                  jax_data.ShoeDataset(folders / "c1", **kw).images)


def test_assemble_batch_equals_jax_runtime(folders):
    images = native.load_images(_files(folders / "c3"), (24, 20), 3)
    for idx, flips in (([4, 0, 2], [1, 0, 1]), ([1, 1], [0, 0])):
        idx, flips = np.asarray(idx), np.asarray(flips, bool)
        got = native.assemble_batch(images, idx, flips)
        np.testing.assert_array_equal(got, jax_runtime.assemble_batch(images, idx, flips))
        # x * (1 / 127.5) - 1 in float32 (not normalize_u8's x / 127.5 - 1)
        batch = images[idx].copy()
        batch[flips] = batch[flips, :, ::-1]
        np.testing.assert_array_equal(got, batch.astype(np.float32) * np.float32(1 / 127.5)
                                      - np.float32(1))
        np.testing.assert_allclose(got, port_data.normalize_u8(batch), rtol=0, atol=1.2e-7)


def test_missing_and_broken_files_raise_as_jax(folders, tmp_path):
    (tmp_path / "broken.png").write_bytes(b"not an image")
    paths = [*_files(folders / "c1")[:2], tmp_path / "gone.png", tmp_path / "broken.png"]
    for mod in (native, jax_runtime):
        with pytest.raises(RuntimeError, match=r"failed to decode 2/4 images, e.g. .*gone.png"):
            mod.load_images(paths, (8, 8), 1)


def test_out_of_range_inputs_raise_before_the_native_call():
    images = np.zeros((3, 4, 4, 1), np.uint8)
    with pytest.raises(IndexError, match=r"in \[0, 3\)"):
        native.assemble_batch(images, np.array([0, 3]), np.zeros(2, bool))
    with pytest.raises(IndexError, match="as many flips"):
        native.assemble_batch(images, np.array([0, 1]), np.zeros(3, bool))
    with pytest.raises(ValueError, match="expected uint8"):
        native.assemble_batch(images.astype(np.float32), np.array([0]), np.zeros(1, bool))
    with pytest.raises(ValueError, match="channels must be 1 or 3"):
        native.load_images([], (4, 4), 2)


def test_the_library_is_built_outside_the_source_tree():
    path = build.library_path("loader")
    native.library()
    assert path.is_file() and path.parent == build.BUILD_DIR
    assert not list(build.CSRC.glob("*.so")) and native.available() is None


def test_no_fallback_without_a_compiler_or_headers(folders, tmp_path, monkeypatch):
    """No compiler: the datasets and iterators raise, naming it; a source
    the compiler refuses (here a missing header, as on a host without
    libjpeg's) raises with the compiler's message."""
    monkeypatch.setattr(build, "_loaded", {})
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setenv("CXX", "no-such-compiler")
    kw = {"mode": "train", "image_size": (8, 8), "channels": 1, "native": True}
    with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
        port_data.ShoeDataset(folders / "c1", **kw)
    with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
        port_data.BatchIterator(np.zeros((4, 8, 8, 1), np.uint8), 2, native=True)
    assert "no C++ compiler" in native.available()
    monkeypatch.delenv("CXX")
    (tmp_path / "loader.cpp").write_text("#include <no_such_header.h>\n")
    monkeypatch.setattr(build, "CSRC", tmp_path)
    with pytest.raises(RuntimeError, match="no_such_header.h"):
        port_data.ShoeDataset(folders / "c1", **kw)
    assert not list((tmp_path / "kernels").glob("*"))
