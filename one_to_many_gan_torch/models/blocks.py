"""Residual blocks (NCHW).

- ``ResnetBlock``: reflect-pad 1 -> eq-conv3 -> InstanceNorm -> ReLU ->
  reflect-pad 1 -> eq-conv3 -> InstanceNorm, residual add. Both instance
  norms run the CUDA kernel (the first with its fused ReLU).
- ``ModulatedResnetBlock``: reflect-pad 1 -> modulated conv3 -> ReLU ->
  reflect-pad 1 -> modulated conv3, residual add; the SAME style vector w
  feeds both convs (``int8``: both on int8 codes, inference only).
"""

from __future__ import annotations

import torch
from torch import nn

from one_to_many_gan_torch.ops import EqualizedConv, ModulatedConv, fused_instance_norm
from one_to_many_gan_torch.ops.activations import relu


class ResnetBlock(nn.Module):
    def __init__(self, dim: int, *, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv0 = EqualizedConv(
            dim, dim, 3, padding=1, pad_mode="reflect", use_bias=False, dtype=dtype
        )
        self.conv1 = EqualizedConv(
            dim, dim, 3, padding=1, pad_mode="reflect", use_bias=False, dtype=dtype
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = fused_instance_norm(self.conv0(x), relu=True)
        y = fused_instance_norm(self.conv1(y))
        return x + y


class ModulatedResnetBlock(nn.Module):
    def __init__(self, dim: int, w_dim: int, *, dtype: torch.dtype = torch.float32,
                 int8: bool = False):
        super().__init__()
        self.conv0 = ModulatedConv(dim, dim, w_dim, padding=1, pad_mode="reflect", dtype=dtype,
                                   int8=int8)
        self.conv1 = ModulatedConv(dim, dim, w_dim, padding=1, pad_mode="reflect", dtype=dtype,
                                   int8=int8)

    def forward(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        y = relu(self.conv0(x, w))
        y = self.conv1(y, w)
        return x + y
