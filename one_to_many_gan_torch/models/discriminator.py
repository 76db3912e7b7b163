"""Discriminator (NCHW): the PatchGAN trunk and a 1-channel patch-logit head.

Trunk: four equalized 4x4 convs (zero pad 1, stride 1) to 64, 128, 256
and 512 channels; an anti-aliased ``downsample2x`` after each of the first
three; LeakyReLU(0.2) after each; an instance norm before the LeakyReLU
of the last three. Head: an equalized 4x4 conv to 1 channel, no sigmoid
(LSGAN). A 256x256 input gives 29x29 patch logits.

The three instance norms run the CUDA kernel (``fused_instance_norm``,
mode none), then the LeakyReLU: the TPU kernel it replaces has no
LeakyReLU mode. The LeakyReLU is ``where(x >= 0, x, 0.2 x)``, as JAX's
``leaky_relu``: its derivative at exactly 0 is 1, where ``F.leaky_relu``'s
is 0.2. Augmented images are 0 outside the frame, so the first conv's
output sits at exactly its bias there (0 at initialisation), and
``F.leaky_relu`` gave that bias a gradient 70 % off the JAX package's
(measured on the CPU, 64x64 D phase).
The style extractor, which shares the trunk, comes with the generator
phase of training.
"""

from __future__ import annotations

import torch
from torch import nn

from one_to_many_gan_torch.ops import EqualizedConv, downsample2x, fused_instance_norm

TRUNK_FEATURES = (64, 128, 256, 512)


def leaky_relu(x: torch.Tensor, slope: float = 0.2) -> torch.Tensor:
    """LeakyReLU with JAX's derivative at 0 (1, the identity branch)."""
    return torch.where(x >= 0, x, x * slope)


class Discriminator(nn.Module):
    def __init__(self, channels: int, *, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        fins = (channels, *TRUNK_FEATURES[:-1])
        self.trunk = nn.ModuleList(
            EqualizedConv(fin, fout, 4, padding=1, dtype=dtype)
            for fin, fout in zip(fins, TRUNK_FEATURES, strict=True)
        )
        self.head = EqualizedConv(TRUNK_FEATURES[-1], 1, 4, padding=1, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Images [B,C,H,W] -> patch logits [B,1,H',W'] in the compute dtype."""
        x = x.to(self.dtype)
        for i, conv in enumerate(self.trunk):
            x = conv(x)
            if i > 0:
                x = fused_instance_norm(x)
            x = leaky_relu(x)
            if i < len(self.trunk) - 1:
                x = downsample2x(x)
        return self.head(x)
