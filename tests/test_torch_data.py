"""The port's data modules against the JAX package's, byte for byte.

Both are numpy and PIL code, so the same seed and the same folder must
give the same bytes: the synthetic images and the PNG files written from
them, the datasets read from one folder, and every batch of the
``BatchIterator`` streams (shuffled and sequential, flips, host shards,
uint8 and float, the C++ assembler's, ``skip(n)`` against ``n`` batches
taken), and the same errors.
"""

import numpy as np
import pytest
from PIL import Image

from one_to_many_gan_torch import data as port_data
from one_to_many_gan_torch.data import datasets as port_datasets
from one_to_many_gan_tpu import data as jax_data
from one_to_many_gan_tpu.data import datasets as jax_datasets


@pytest.mark.parametrize(("n", "size", "channels", "seed"),
                         [(3, (32, 32), 1, 0), (2, (24, 40), 3, 7), (4, (64, 64), 1, 10_000)])
def test_synthetic_images_equal_jax(n, size, channels, seed):
    got = port_data.synthetic_images(n, size, channels, seed=seed)
    want = jax_data.synthetic_images(n, size, channels, seed=seed)
    assert got.dtype == np.uint8 and got.shape == (n, *size, channels)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("channels", [1, 3])
def test_synthetic_dataset_dirs_write_the_same_png_bytes(tmp_path, channels):
    kw = {"n_train": 3, "n_test": 2, "image_size": (32, 24), "channels": channels, "seed": 5}
    port_data.write_synthetic_dataset_dirs(tmp_path / "port", **kw)
    jax_data.write_synthetic_dataset_dirs(tmp_path / "jax", **kw)
    port_files = sorted(p.relative_to(tmp_path / "port") for p in (tmp_path / "port").rglob("*"))
    jax_files = sorted(p.relative_to(tmp_path / "jax") for p in (tmp_path / "jax").rglob("*"))
    assert port_files == jax_files and len(port_files) == 2 + 3 + 2
    for rel in port_files:
        if (tmp_path / "port" / rel).is_file():
            assert (tmp_path / "port" / rel).read_bytes() == (tmp_path / "jax" / rel).read_bytes()


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    """A domain folder: train/ PNGs at 40x30, a nested JPEG, test/ PNGs."""
    root = tmp_path_factory.mktemp("domain")
    port_data.write_synthetic_dataset_dirs(root, n_train=5, n_test=2, image_size=(40, 30),
                                           seed=3)
    nested = root / "train" / "more"
    nested.mkdir()
    rgb = port_data.synthetic_images(1, (20, 50), 3, seed=9)[0]
    Image.fromarray(rgb).save(nested / "extra.jpg", quality=90)
    return root


@pytest.mark.parametrize(("mode", "size", "channels"),
                         [("train", (32, 32), 1), ("train", (24, 16), 3), ("test", (40, 30), 1)])
def test_shoe_dataset_equals_jax(folder, mode, size, channels):
    got = port_data.ShoeDataset(folder, mode=mode, image_size=size, channels=channels)
    want = jax_data.ShoeDataset(folder, mode=mode, image_size=size, channels=channels)
    assert got.files == want.files and len(got) == len(want)
    assert got.images.dtype == np.uint8 and got.images.shape == (len(want), *size, channels)
    np.testing.assert_array_equal(got.images, want.images)


@pytest.mark.parametrize("kind", ["edge", "shoe"])
def test_edges2shoes_dataset_equals_jax(tmp_path, kind):
    (tmp_path / "train").mkdir()
    pairs = port_data.synthetic_images(2, (256, 512), 3, seed=4)
    for i, img in enumerate(pairs):
        Image.fromarray(img).save(tmp_path / "train" / f"{i}.png")
    kw = {"mode": "train", "kind": kind, "image_size": (64, 48), "channels": 1}
    got = port_datasets.Edges2ShoesDataset(tmp_path, **kw)
    want = jax_datasets.Edges2ShoesDataset(tmp_path, **kw)
    np.testing.assert_array_equal(got.images, want.images)
    with pytest.raises(ValueError, match="kind must be edge|shoe"):
        port_datasets.Edges2ShoesDataset(tmp_path, **{**kw, "kind": "both"})


def test_dataset_errors_match_jax(tmp_path):
    for mod in (port_data, jax_data):
        with pytest.raises(FileNotFoundError, match="no images under"):
            mod.ShoeDataset(tmp_path, mode="train", image_size=(8, 8), channels=1)
        with pytest.raises(ValueError, match="expected uint8"):
            mod.ArrayDataset(np.zeros((2, 4, 4, 1), np.float32))
        with pytest.raises(ValueError, match="expected uint8"):
            mod.ArrayDataset(np.zeros((4, 4, 1), np.uint8))
    assert len(port_data.ArrayDataset(np.zeros((3, 4, 4, 1), np.uint8))) == 3
    for mod in (port_data, jax_data):  # the C++ loader finds the same files
        with pytest.raises(FileNotFoundError, match="no images under"):
            mod.ShoeDataset(tmp_path, mode="train", image_size=(8, 8), channels=1, native=True)


# ------------------------------------------------------------- BatchIterator

IMAGES = port_data.synthetic_images(11, (8, 6), 1, seed=2)

STREAMS = {
    "shuffle_uint8": {"batch_size": 3, "shuffle": True, "seed": 4, "as_float": False},
    "shuffle_float": {"batch_size": 3, "shuffle": True, "seed": 4, "as_float": True},
    "val": {"batch_size": 4, "shuffle": False, "flip_prob": 0.5, "seed": 42},
    "no_flip": {"batch_size": 2, "shuffle": True, "flip_prob": 0.0, "seed": 1},
    "host_0_of_2": {"batch_size": 2, "seed": 5, "host_id": 0, "host_count": 2,
                    "as_float": False},
    "host_1_of_2": {"batch_size": 2, "seed": 5, "host_id": 1, "host_count": 2,
                    "as_float": False},
    # the C++ assembler (float batches) against the JAX package's
    "native_float": {"batch_size": 3, "seed": 6, "native": True, "as_float": True},
    "native_uint8": {"batch_size": 3, "seed": 6, "native": True, "as_float": False},
}


@pytest.mark.parametrize("name", list(STREAMS))
def test_batch_iterator_streams_equal_jax(name):
    kw = STREAMS[name]
    got = port_data.BatchIterator(IMAGES, **kw)
    want = jax_data.BatchIterator(IMAGES, **kw)
    flipped = False
    for _ in range(9):  # several epochs of 11 images, drop-last
        a, b = next(got), next(want)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
        flipped |= not any(np.array_equal(a[0], img) for img in
                           (port_data.normalize_u8(IMAGES) if kw.get("as_float", True)
                            else IMAGES))
    assert flipped == (kw.get("flip_prob", 0.5) > 0)


@pytest.mark.parametrize("n", [0, 1, 3, 7])
def test_skip_consumes_exactly_n_batches(n):
    kw = {"batch_size": 3, "seed": 8, "as_float": False}
    skipped = port_data.BatchIterator(IMAGES, **kw)
    skipped.skip(n)
    taken = port_data.BatchIterator(IMAGES, **kw)
    jax_skipped = jax_data.BatchIterator(IMAGES, **kw)
    jax_skipped.skip(n)
    for _ in range(n):
        next(taken)
    for _ in range(5):
        a = next(skipped)
        np.testing.assert_array_equal(a, next(taken))
        np.testing.assert_array_equal(a, next(jax_skipped))


def test_batch_iterator_errors_match_jax():
    for mod in (port_data, jax_data):
        with pytest.raises(ValueError, match="shard has 5 images < batch size 6"):
            mod.BatchIterator(IMAGES, 6, host_id=1, host_count=2)
        with pytest.raises(ValueError, match=r"expected \[N,H,W,C\]"):
            mod.BatchIterator(IMAGES[0], 2)
    # native=True now assembles float batches in C++, the JAX package's bytes
    got, want = port_data.BatchIterator(IMAGES, 2, native=True), jax_data.BatchIterator(
        IMAGES, 2, native=True)
    assert got.native and want.native
    np.testing.assert_array_equal(next(got), next(want))


def test_normalize_u8_equals_jax():
    x = np.arange(256, dtype=np.uint8).reshape(1, 16, 16, 1)
    got = port_data.normalize_u8(x)
    assert got.dtype == np.float32 and got.min() == -1.0 and got.max() == 1.0
    np.testing.assert_array_equal(got, jax_data.normalize_u8(x))
