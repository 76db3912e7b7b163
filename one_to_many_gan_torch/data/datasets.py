"""Datasets: eager in-RAM uint8 image stores, and synthetic stand-in data.

The JAX package's ``data/datasets.py``, copied: every ``*.jpg`` and
``*.png`` under ``<root>/<mode>/`` (recursive, sorted, jpgs first) is
decoded once at construction through ``_load_image`` (convert to L or
RGB, PIL bilinear resize to ``image_size``) into one [N, H, W, C] uint8
array. The normalisation to [-1, 1] and the per-sample flip happen per
batch (``pipeline.py``), on the host for the flip and on the device for
the normalisation (``core/trainer.py``).

The C++ loader of the JAX package (``native=True``) is not ported:
``ShoeDataset`` refuses it.
"""

from __future__ import annotations

from pathlib import Path
from typing import BinaryIO

import numpy as np
from PIL import Image


def _load_image(
    source: Path | BinaryIO, image_size: tuple[int, int], channels: int
) -> np.ndarray:
    """Decode + resize + layout one image (a path or a binary file) to
    [H, W, C] uint8."""
    h, w = image_size
    img = Image.open(source)
    img = img.convert("L" if channels == 1 else "RGB")
    img = img.resize((w, h), Image.BILINEAR)
    arr = np.asarray(img, dtype=np.uint8)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    return arr


def _image_files(path: Path | str, mode: str) -> list[Path]:
    root = Path(path).expanduser() / mode
    files = sorted(root.rglob("*.jpg")) + sorted(root.rglob("*.png"))
    if not files:
        raise FileNotFoundError(f"no images under {root}")
    return files


class ShoeDataset:
    """Eager uint8 image store for one domain.

    Args:
        path: dataset root; images are found under ``<path>/<mode>/``
            (recursive, .jpg + .png).
        mode: "train" | "test" | "val".
        image_size: (height, width) resize target.
        channels: 1 (grayscale) or 3.
        native: the JAX package's C++ loader; not ported, refused.
    """

    def __init__(
        self,
        path: Path | str,
        *,
        mode: str,
        image_size: tuple[int, int],
        channels: int,
        native: bool = False,
    ):
        if native:
            msg = "the native C++ image loader is not ported to PyTorch yet (see ROADMAP.md)"
            raise NotImplementedError(msg)
        files = _image_files(path, mode)
        self.images = np.stack(
            [_load_image(f, image_size, channels) for f in files]
        )  # [N, H, W, C] uint8
        self.files = files

    def __len__(self) -> int:
        return self.images.shape[0]


class Edges2ShoesDataset:
    """Paired edges2shoes loader: each image holds the edge map in the left
    256px and the photo in the right 256px; ``kind`` selects the half."""

    def __init__(
        self,
        path: Path | str,
        *,
        mode: str,
        kind: str,  # "edge" | "shoe"
        image_size: tuple[int, int],
        channels: int,
    ):
        if kind not in ("edge", "shoe"):
            msg = f"kind must be edge|shoe, got {kind}"
            raise ValueError(msg)
        files = _image_files(path, mode)
        h, w = image_size
        box = (0, 0, 256, 256) if kind == "edge" else (256, 0, 512, 256)
        images = []
        for f in files:
            img = Image.open(f)
            img = img.crop(box).convert("L" if channels == 1 else "RGB")
            img = img.resize((w, h), Image.BILINEAR)
            arr = np.asarray(img, dtype=np.uint8)
            if arr.ndim == 2:
                arr = arr[:, :, None]
            images.append(arr)
        self.images = np.stack(images)
        self.files = files

    def __len__(self) -> int:
        return self.images.shape[0]


class ArrayDataset:
    """Dataset wrapping a pre-built uint8 array (synthetic data, tests)."""

    def __init__(self, images: np.ndarray):
        if images.dtype != np.uint8 or images.ndim != 4:
            msg = f"expected uint8 [N,H,W,C], got {images.dtype} {images.shape}"
            raise ValueError(msg)
        self.images = images

    def __len__(self) -> int:
        return self.images.shape[0]


def synthetic_images(
    n: int, image_size: tuple[int, int], channels: int = 1, seed: int = 0
) -> np.ndarray:
    """Structured synthetic images (blobs + ridges + noise) for tests and
    benchmarks, where the forensic dataset is absent: spatial structure
    keeps the training signals and the FID features non-degenerate. The
    same numpy draws as the JAX package's, so the same bytes."""
    h, w = image_size
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    out = np.empty((n, h, w, channels), dtype=np.uint8)
    for i in range(n):
        img = np.zeros((h, w), dtype=np.float32)
        for _ in range(rng.integers(2, 6)):
            cy, cx = rng.uniform(0, h), rng.uniform(0, w)
            sy, sx = rng.uniform(h / 16, h / 3), rng.uniform(w / 16, w / 3)
            img += rng.uniform(0.3, 1.0) * np.exp(
                -((yy - cy) ** 2 / (2 * sy**2) + (xx - cx) ** 2 / (2 * sx**2))
            )
        freq = rng.uniform(0.1, 0.5)
        phase = rng.uniform(0, 2 * np.pi)
        angle = rng.uniform(0, np.pi)
        img += 0.3 * np.sin(
            freq * (np.cos(angle) * xx + np.sin(angle) * yy) + phase
        )
        img += rng.normal(0, 0.05, size=img.shape)
        img = (img - img.min()) / (img.max() - img.min() + 1e-8)
        arr = (img * 255).astype(np.uint8)
        out[i] = np.repeat(arr[:, :, None], channels, axis=2)
    return out


def write_synthetic_dataset_dirs(
    root: Path | str,
    *,
    n_train: int = 16,
    n_test: int = 4,
    image_size: tuple[int, int] = (64, 64),
    channels: int = 1,
    seed: int = 0,
) -> Path:
    """Write a synthetic dataset tree: ``<root>/train/00000.png``... from
    ``synthetic_images(seed)`` and ``<root>/test/...`` from
    ``seed + 10_000``."""
    root = Path(root)
    for mode, n, offset in (("train", n_train, 0), ("test", n_test, 10_000)):
        d = root / mode
        d.mkdir(parents=True, exist_ok=True)
        imgs = synthetic_images(n, image_size, channels, seed=seed + offset)
        for i, arr in enumerate(imgs):
            Image.fromarray(arr.squeeze(-1) if channels == 1 else arr).save(
                d / f"{i:05d}.png"
            )
    return root
