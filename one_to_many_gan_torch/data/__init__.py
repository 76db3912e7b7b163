"""Data: eager uint8 datasets, synthetic data, the batch pipeline."""

from one_to_many_gan_torch.data.datasets import (
    ArrayDataset,
    ShoeDataset,
    _load_image,
    synthetic_images,
    write_synthetic_dataset_dirs,
)
from one_to_many_gan_torch.data.pipeline import BatchIterator, normalize_u8

__all__ = [
    "ArrayDataset",
    "BatchIterator",
    "ShoeDataset",
    "_load_image",
    "normalize_u8",
    "synthetic_images",
    "write_synthetic_dataset_dirs",
]
