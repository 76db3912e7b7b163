"""Adaptive discriminator augmentation: the pipeline and its controller."""

from one_to_many_gan_torch.augment.controller import AdaState, init_ada_state, make_ada_update
from one_to_many_gan_torch.augment.pipeline import (
    AugmentDraws,
    ColorDraws,
    GeometricDraws,
    augment,
    draw_augment,
)

__all__ = [
    "AdaState",
    "AugmentDraws",
    "ColorDraws",
    "GeometricDraws",
    "augment",
    "draw_augment",
    "init_ada_state",
    "make_ada_update",
]
