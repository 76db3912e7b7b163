"""Evaluation metrics: FID / KID with a pluggable feature extractor
(InceptionV3 pool3 where its weights are found, else a random projection)."""

from one_to_many_gan_torch.metrics.fid import (
    InceptionUnavailableError,
    compute_fid,
    compute_kid,
    compute_stats,
    default_extractor,
    frechet_distance,
    kernel_distance,
    random_projection_extractor,
)
from one_to_many_gan_torch.metrics.inception import try_load_inception

__all__ = [
    "InceptionUnavailableError",
    "compute_fid",
    "compute_kid",
    "compute_stats",
    "default_extractor",
    "frechet_distance",
    "kernel_distance",
    "random_projection_extractor",
    "try_load_inception",
]
