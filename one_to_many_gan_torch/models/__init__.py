"""Model families of the serving path: generator and mapping network."""

from one_to_many_gan_torch.models.blocks import ModulatedResnetBlock, ResnetBlock
from one_to_many_gan_torch.models.generator import Generator, generator_arithmetic
from one_to_many_gan_torch.models.mapping import MappingNetwork, StyleRngs, apply_domain

__all__ = [
    "Generator",
    "MappingNetwork",
    "ModulatedResnetBlock",
    "ResnetBlock",
    "StyleRngs",
    "apply_domain",
    "generator_arithmetic",
]
