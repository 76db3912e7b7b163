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

Under a spatial group (``parallel/halo.py``) a conv takes its input's
global height ``h`` and runs on this rank's band of rows (``conv_band``):
the rows its output band reads, fetched from the neighbouring bands, H
padded only at the true top and bottom of the map, W padded as on one
process, and the conv itself with no H padding.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from one_to_many_gan_torch.ops.pad import pad as pad_op
from one_to_many_gan_torch.ops.remat import conv_out
from one_to_many_gan_torch.parallel import halo


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


def conv_rows(h: int, k: int, pad: int) -> int:
    """The output height of a stride-1 ``k`` x ``k`` conv padded by ``pad``."""
    return h + 2 * pad - k + 1


def conv_band(x: torch.Tensor, w: torch.Tensor, h: int, pad: int, mode: str) -> torch.Tensor:
    """This rank's band of ``F.conv2d(pad2d(X, pad, mode), w)``, where ``x``
    is its band of a map ``X`` of ``h`` rows (``parallel/halo.py``): the
    input rows its output band reads, fetched from the other bands, padded
    by ``mode`` where they run past the map (its true top and bottom)."""
    k = w.shape[-2]
    win = halo.window(x, h, conv_rows(h, k, pad), lambda a, b: (a - pad, b - pad + k - 1), mode)
    rows = win.rows
    if mode != "zero" and pad:
        rows = pad_op(rows, (pad, pad, 0, 0), mode)
    with conv_out():  # the save point of tpu.remat = "conv"
        y = F.conv2d(rows, w, padding=(0, pad) if mode == "zero" else 0)
    return y[:, :, : win.keep]


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

    def out_rows(self, h: int) -> int:
        return conv_rows(h, self.weight.shape[-2], self.padding)

    def forward(self, x: torch.Tensor, h: int | None = None) -> torch.Tensor:
        """``x`` [B,C,H,W]; under a spatial group, this rank's band of a map
        of ``h`` rows -> its band of the output."""
        x = x.to(self.dtype)
        w = self.weight.to(self.dtype) * self.c
        if halo.current() is not None:
            y = conv_band(x, w, h, self.padding, self.pad_mode)
        else:
            if self.pad_mode == "zero":
                padding = self.padding
            else:
                x, padding = pad2d(x, self.padding, self.pad_mode), 0
            with conv_out():  # the save point of tpu.remat = "conv"
                y = F.conv2d(x, w, padding=padding)
        if self.bias is not None:
            y = y + self.bias.to(self.dtype)[:, None, None]
        return y
