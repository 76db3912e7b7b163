"""Evaluation metrics: FID / KID with a pluggable feature extractor."""

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

__all__ = [
    "InceptionUnavailableError",
    "compute_fid",
    "compute_kid",
    "compute_stats",
    "default_extractor",
    "frechet_distance",
    "kernel_distance",
    "random_projection_extractor",
]
