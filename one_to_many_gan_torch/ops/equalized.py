"""Equalized-learning-rate layers (NCHW).

Weights are stored N(0, 1) in float32 and scaled at use by the He
constant ``1/sqrt(fan_in)``. The constant is applied after the cast to
the compute dtype, rounded to that dtype first, as the JAX package does
(its Python-scalar constant is weakly typed).

Layouts are PyTorch's: linear weights ``[out, in]``, conv weights OIHW.
``convert.py`` transposes the JAX package's ``[in, out]`` and HWIO.
Convolutions go through ``F.conv2d``; the JAX package's space-to-depth
forms of the same convs are TPU layout tricks, exact reassociations of
this math, and are not ported.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from one_to_many_gan_torch.ops.pad import pad as pad_op
from one_to_many_gan_torch.ops.remat import conv_out


def he_constant(fan_in: int, dtype: torch.dtype) -> float:
    """``1/sqrt(fan_in)`` rounded to ``dtype`` (exact as a Python float)."""
    return float(torch.tensor(1.0 / math.sqrt(fan_in), dtype=dtype))


def pad2d(x: torch.Tensor, pad: int, mode: str) -> torch.Tensor:
    """Pad H and W of an NCHW tensor by ``pad`` with zeros or reflection
    (``ops/pad.py``: a deterministic backward)."""
    if pad == 0:
        return x
    if mode == "zero":
        return F.pad(x, (pad, pad, pad, pad))
    if mode == "reflect":
        return pad_op(x, (pad, pad, pad, pad), "reflect")
    msg = f"unknown pad mode {mode}"
    raise ValueError(msg)


class EqualizedLinear(nn.Module):
    """Linear layer with equalized learning rate; ``bias_init`` is the
    constant bias initialisation (1.0 for the modulated conv's style
    affine, so an all-zero style maps to unit modulation)."""

    def __init__(
        self,
        in_features: int,
        out_features: int,
        *,
        bias_init: float = 0.0,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.weight = nn.Parameter(torch.randn(out_features, in_features))
        self.bias = nn.Parameter(torch.full((out_features,), float(bias_init)))
        self.dtype = dtype
        self.c = he_constant(in_features, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        y = F.linear(x, self.weight.to(self.dtype) * self.c)
        return y + self.bias.to(self.dtype)


class EqualizedConv(nn.Module):
    """2D convolution with equalized learning rate, NCHW, with the zero or
    reflection padding folded in (``pad_mode`` "zero" or "reflect")."""

    def __init__(
        self,
        in_features: int,
        out_features: int,
        kernel_size: int,
        *,
        padding: int = 0,
        pad_mode: str = "zero",
        use_bias: bool = True,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        k = kernel_size
        self.weight = nn.Parameter(torch.randn(out_features, in_features, k, k))
        self.bias = nn.Parameter(torch.zeros(out_features)) if use_bias else None
        self.padding = padding
        self.pad_mode = pad_mode
        self.dtype = dtype
        self.c = he_constant(in_features * k * k, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        w = self.weight.to(self.dtype) * self.c
        if self.pad_mode == "zero":
            padding = self.padding
        else:
            x, padding = pad2d(x, self.padding, self.pad_mode), 0
        with conv_out():  # the save point of tpu.remat = "conv"
            y = F.conv2d(x, w, padding=padding)
        if self.bias is not None:
            y = y + self.bias.to(self.dtype)[:, None, None]
        return y
