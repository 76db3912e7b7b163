"""Discriminator and style extractor (NCHW), on one shared trunk.

Trunk (``Trunk``): four equalized 4x4 convs (zero pad 1, stride 1) to 64,
128, 256 and 512 channels; an anti-aliased ``downsample2x`` after each of
the first three; LeakyReLU(0.2) after each; an instance norm before the
LeakyReLU of the last three. The discriminator's head is an equalized
4x4 conv to 1 channel, no sigmoid (LSGAN): a 256x256 input gives 29x29
patch logits. The style extractor's head is the spatial mean and an
equalized linear layer to ``w_dim``, in float32 on float32 input.

The three instance norms run the CUDA kernel (``fused_instance_norm``,
mode none), then the LeakyReLU: the TPU kernel it replaces has no
LeakyReLU mode. The LeakyReLU is ``ops/activations.py``'s
``where(x >= 0, x, 0.2 x)``, as JAX's ``leaky_relu``: its derivative at
exactly 0 is 1, where ``F.leaky_relu``'s is 0.2. Augmented images are 0
outside the frame, so the first conv's output sits at exactly its bias
there (0 at initialisation), and ``F.leaky_relu`` gave that bias a
gradient 70 % off the JAX package's (measured on the CPU, 64x64 D
phase).
"""

from __future__ import annotations

import torch
from torch import nn

from one_to_many_gan_torch.ops import (
    EqualizedConv,
    EqualizedLinear,
    downsample2x,
    fused_instance_norm,
)
from one_to_many_gan_torch.ops.activations import leaky_relu

TRUNK_FEATURES = (64, 128, 256, 512)


class Trunk(nn.ModuleList):
    """The PatchGAN trunk both heads share: its four convs, in order."""

    def __init__(self, channels: int, *, dtype: torch.dtype = torch.float32):
        fins = (channels, *TRUNK_FEATURES[:-1])
        super().__init__(
            EqualizedConv(fin, fout, 4, padding=1, dtype=dtype)
            for fin, fout in zip(fins, TRUNK_FEATURES, strict=True)
        )
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Images [B,C,H,W] -> features [B,512,H',W'] in the compute dtype."""
        x = x.to(self.dtype)
        for i, conv in enumerate(self):
            x = conv(x)
            if i > 0:
                x = fused_instance_norm(x)
            x = leaky_relu(x)
            if i < len(self) - 1:
                x = downsample2x(x)
        return x


class Discriminator(nn.Module):
    def __init__(self, channels: int, *, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.trunk = Trunk(channels, dtype=dtype)
        self.head = EqualizedConv(TRUNK_FEATURES[-1], 1, 4, padding=1, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Images [B,C,H,W] -> patch logits [B,1,H',W'] in the compute dtype."""
        return self.head(self.trunk(x))


class StyleExtractor(nn.Module):
    def __init__(self, channels: int, w_dim: int, *, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.trunk = Trunk(channels, dtype=dtype)
        # float32 in a float32 or bfloat16 extractor (float64 in a float64 one)
        self.head = EqualizedLinear(
            TRUNK_FEATURES[-1], w_dim, dtype=torch.promote_types(dtype, torch.float32)
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Images [B,C,H,W] -> styles [B, w_dim] in the head's dtype."""
        return self.head(self.trunk(x).mean(dim=(2, 3)))
