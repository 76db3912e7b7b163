"""Image loading with the dataset loader's convert/resize contract."""

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
