"""StyleGAN2 weight-modulated convolution (NCHW), activation-scaling form.

Per-sample style ``s = affine(w)`` scales the conv weights per input
channel, and the result is demodulated by ``rsqrt(sum(w^2) + eps)`` over
(in, kh, kw). Convolution is linear in the weights, so the same math is

    y[b, o] = conv(x[b] * s[b, :], W)[o] * d[b, o]
    d[b, o] = rsqrt( sum_i s[b,i]^2 * sum_kk (c W[o,i,kk])^2 + eps )

one ordinary batched conv between a per-(batch, in) activation scale and
a per-(batch, out) rescale. The demodulation statistics are float32 even
under a bf16 activation policy.

``int8=True`` (inference only: serving and generation) runs the conv on
int8 codes (``ops/quantize.py``): the factorisation keeps the conv's
weights static, so they quantise per output channel, and the modulated,
padded activations quantise per sample. The result is cast to the
activation dtype and demodulated as the float conv's is. The whole site,
from the unpadded input to the demodulated output, is one call of
``ops/cuda/int8_conv.py::modulated_int8_conv``: on the card an amax
pre-pass and one fused conv kernel, with no torch pass over the
activations.

Under a spatial group (``parallel/halo.py``) the float conv runs on this
rank's band of rows, its input's global height ``h`` given
(``ops/equalized.py::conv_band``); the int8 path is serving's, which has
no spatial axis.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from one_to_many_gan_torch.ops.cuda.int8_conv import modulated_int8_conv
from one_to_many_gan_torch.ops.equalized import (
    EqualizedLinear,
    conv_band,
    he_constant,
    pad2d,
)
from one_to_many_gan_torch.ops.quantize import quantize_weight
from one_to_many_gan_torch.ops.remat import conv_out
from one_to_many_gan_torch.parallel import halo


class ModulatedConv(nn.Module):
    """Style-modulated kxk conv with folded zero or reflection padding;
    ``int8``: the conv on int8 codes (module docstring)."""

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
        int8: bool = False,
    ):
        super().__init__()
        k = kernel_size
        self.to_style = EqualizedLinear(w_dim, in_features, bias_init=1.0)
        self.weight = nn.Parameter(torch.randn(out_features, in_features, k, k))
        self.padding = padding
        self.pad_mode = pad_mode
        self.eps = eps
        self.dtype = dtype
        self.int8 = int8
        self.c32 = he_constant(in_features * k * k, torch.float32)
        self.c = he_constant(in_features * k * k, dtype)

    def forward(self, x: torch.Tensor, w_style: torch.Tensor,
                h: int | None = None) -> torch.Tensor:
        """x: [B, in, H, W]; w_style: [B, w_dim] -> [B, out, H, W] (under a
        spatial group: bands of maps of ``h`` rows)."""
        s = self.to_style(w_style)  # [B, in], float32 (float64 in a float64 copy)
        if halo.current() is not None:
            if self.int8:
                msg = "int8 modulated convs serve only; the spatial axis trains"
                raise NotImplementedError(msg)
            x = x.to(self.dtype) * s[:, :, None, None].to(self.dtype)
            y = conv_band(x, self.weight.to(self.dtype) * self.c, h, self.padding,
                          self.pad_mode)
            return y * self._demodulation(s)[:, :, None, None].to(self.dtype)
        if self.int8:
            w_q, w_scale = quantize_weight(self.weight * self.c32)
            return modulated_int8_conv(x, s, w_q, w_scale, self._demodulation(s),
                                       padding=self.padding, pad_mode=self.pad_mode,
                                       dtype=self.dtype)
        x = x.to(self.dtype) * s[:, :, None, None].to(self.dtype)
        w = self.weight.to(self.dtype) * self.c
        if self.pad_mode == "zero":
            padding = self.padding
        else:
            x, padding = pad2d(x, self.padding, self.pad_mode), 0
        with conv_out():  # the save point of tpu.remat = "conv"
            y = F.conv2d(x, w, padding=padding)
        return y * self._demodulation(s)[:, :, None, None].to(self.dtype)

    def _demodulation(self, s: torch.Tensor) -> torch.Tensor:
        """d [B, out], as s: rsqrt(s^2 @ sum_kk (c W)^2 + eps)."""
        wsq = (self.weight * self.c32).square().sum(dim=(2, 3))  # [out, in]
        return torch.rsqrt(s.square() @ wsq.T + self.eps)
