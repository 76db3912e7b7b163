"""Mapping network: latent z -> style w, with the continuous domain variable.

- forward: L2-normalize z over features, then ``n_layers`` equalized
  linear layers with LeakyReLU(0.2), the LAST activation swapped for ReLU
  so the style vector can be exactly zero.
- the "shoeprint style" (domain θ=0) is the all-zeros vector, so the
  domain interpolation ``lerp(0, s, θ)`` reduces to ``θ * s``.
- style mixing: two z's are mapped and crossed over at a block index
  along the per-generator-block axis, as a mask over that axis.

The draws are injected as tensors (``StyleRngs``): torch cannot
reproduce ``jax.random`` streams, so tests hand both packages the same
draws, and serving draws them from a ``torch.Generator``. All style math
runs in float32 (float64 in a float64 copy). Style stacks are
[n_blocks, B, w_dim].
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from one_to_many_gan_torch.ops import EqualizedLinear, l2_normalize
from one_to_many_gan_torch.ops.activations import leaky_relu, relu


class StyleRngs(NamedTuple):
    """Random draws consumed by one style-vector sample."""

    z1: torch.Tensor  # [B, w_dim] standard normal
    z2: torch.Tensor  # [B, w_dim] standard normal
    mix: torch.Tensor  # scalar bool: use style mixing this draw
    crossover: torch.Tensor  # scalar int in [0, n_blocks)


def draw_style_rngs(
    generator: torch.Generator, b: int, w_dim: int, n_blocks: int, mixing_prob: float
) -> StyleRngs:
    """One style sample's draws from ``generator``, with the JAX package's
    distributions (``sample_style_rngs``)."""
    device = generator.device
    return StyleRngs(
        z1=torch.randn((b, w_dim), generator=generator, device=device),
        z2=torch.randn((b, w_dim), generator=generator, device=device),
        mix=torch.rand((), generator=generator, device=device) < mixing_prob,
        crossover=torch.randint(0, n_blocks, (), generator=generator, device=device),
    )


def apply_domain(style: torch.Tensor, domain: torch.Tensor | float) -> torch.Tensor:
    """Interpolate between the zero "shoeprint style" and ``style`` by θ.

    ``domain`` may be a scalar or a per-sample [B] vector.
    """
    d = torch.as_tensor(domain, dtype=style.dtype, device=style.device)
    return style * d.reshape(1, -1, 1)


class MappingNetwork(nn.Module):
    def __init__(self, features: int, n_layers: int = 2):
        super().__init__()
        self.layers = nn.ModuleList(
            EqualizedLinear(features, features) for _ in range(n_layers)
        )

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        x = l2_normalize(z.to(self.layers[0].dtype), dim=1)
        for i, layer in enumerate(self.layers):
            x = layer(x)
            x = relu(x) if i == len(self.layers) - 1 else leaky_relu(x, 0.2)
        return x

    def style_vector(
        self, rngs: StyleRngs, n_blocks: int, *, mix_styles: bool = True
    ) -> torch.Tensor:
        """Per-block style stack [n_blocks, B, features] with optional mixing."""
        s1 = self(rngs.z1)
        plain = s1[None].expand(n_blocks, *s1.shape)
        if not mix_styles:
            return plain
        s2 = self(rngs.z2)
        block_idx = torch.arange(n_blocks, device=s1.device)[:, None, None]
        mixed = torch.where(block_idx < rngs.crossover, s1[None], s2[None])
        return torch.where(rngs.mix, mixed, plain)
