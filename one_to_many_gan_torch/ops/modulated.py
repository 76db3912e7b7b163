"""StyleGAN2 weight-modulated convolution (NCHW), activation-scaling form.

Per-sample style ``s = affine(w)`` scales the conv weights per input
channel, and the result is demodulated by ``rsqrt(sum(w^2) + eps)`` over
(in, kh, kw). Convolution is linear in the weights, so the same math is

    y[b, o] = conv(x[b] * s[b, :], W)[o] * d[b, o]
    d[b, o] = rsqrt( sum_i s[b,i]^2 * sum_kk (c W[o,i,kk])^2 + eps )

one ordinary batched conv between a per-(batch, in) activation scale and
a per-(batch, out) rescale. The demodulation statistics are float32 even
under a bf16 activation policy. The int8 serving path of the JAX package
is not ported.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from one_to_many_gan_torch.ops.equalized import EqualizedLinear, he_constant, pad2d
from one_to_many_gan_torch.ops.remat import conv_out


class ModulatedConv(nn.Module):
    """Style-modulated kxk conv with folded zero or reflection padding."""

    def __init__(
        self,
        in_features: int,
        out_features: int,
        w_dim: int,
        kernel_size: int = 3,
        *,
        padding: int = 1,
        pad_mode: str = "zero",
        eps: float = 1e-8,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        k = kernel_size
        self.to_style = EqualizedLinear(w_dim, in_features, bias_init=1.0)
        self.weight = nn.Parameter(torch.randn(out_features, in_features, k, k))
        self.padding = padding
        self.pad_mode = pad_mode
        self.eps = eps
        self.dtype = dtype
        self.c32 = he_constant(in_features * k * k, torch.float32)
        self.c = he_constant(in_features * k * k, dtype)

    def forward(self, x: torch.Tensor, w_style: torch.Tensor) -> torch.Tensor:
        """x: [B, in, H, W]; w_style: [B, w_dim] -> [B, out, H, W]."""
        s = self.to_style(w_style)  # [B, in], float32 (float64 in a float64 copy)
        x = x.to(self.dtype) * s[:, :, None, None].to(self.dtype)
        w = self.weight.to(self.dtype) * self.c
        if self.pad_mode == "zero":
            padding = self.padding
        else:
            x, padding = pad2d(x, self.padding, self.pad_mode), 0
        with conv_out():  # the save point of tpu.remat = "conv"
            y = F.conv2d(x, w, padding=padding)
        wsq = (self.weight * self.c32).square().sum(dim=(2, 3))  # [out, in]
        d = torch.rsqrt(s.square() @ wsq.T + self.eps)  # [B, out], as s
        return y * d[:, :, None, None].to(self.dtype)
