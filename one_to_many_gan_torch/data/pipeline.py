"""Batch normalization of uint8 images."""

from __future__ import annotations

import numpy as np


def normalize_u8(batch_u8: np.ndarray) -> np.ndarray:
    """uint8 [0,255] -> float32 [-1, 1] (ToTensor + Normalize((0.5,),(0.5,)))."""
    return batch_u8.astype(np.float32) / 127.5 - 1.0
