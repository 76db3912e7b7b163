"""Model families: generator, mapping network and discriminator."""

from one_to_many_gan_torch.models.blocks import ModulatedResnetBlock, ResnetBlock
from one_to_many_gan_torch.models.discriminator import Discriminator
from one_to_many_gan_torch.models.generator import Generator, generator_arithmetic
from one_to_many_gan_torch.models.mapping import (
    MappingNetwork,
    StyleRngs,
    apply_domain,
    draw_style_rngs,
)

__all__ = [
    "Discriminator",
    "Generator",
    "MappingNetwork",
    "ModulatedResnetBlock",
    "ResnetBlock",
    "StyleRngs",
    "apply_domain",
    "draw_style_rngs",
    "generator_arithmetic",
]
