"""Data helpers the serving path needs: image decode and normalization."""

from one_to_many_gan_torch.data.datasets import _load_image
from one_to_many_gan_torch.data.pipeline import normalize_u8

__all__ = ["_load_image", "normalize_u8"]
