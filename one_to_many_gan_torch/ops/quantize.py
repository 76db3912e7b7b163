"""Dynamic int8 quantisation and the int8 convolution of the serving path.

Inference only (``serve --int8``, ``generate --int8``): the decoder's
modulated convs run on int8 codes with int32 accumulation. The scheme is
the JAX package's (its ``ops/quantize.py``), step for step, so both give
the same codes from the same values:

- weights: symmetric, per output channel, ``scale = max(amax, 1e-12) /
  127`` over (in, kh, kw);
- activations: symmetric, per sample, computed at each call (a GAN
  decode's range moves with the style), over (C, H, W), in float32 whatever
  the activations' dtype;
- codes ``round(v / scale)`` (a division; round half to even), clipped to
  [-127, 127];
- ``y = float32(sum) * (x_scale[b] * w_scale[o])``, the scale product
  formed first.

``round`` has no useful gradient: training refuses int8 models
(``core/train_step.py``).
"""

from __future__ import annotations

import torch

_QMAX = 127.0


def _scale(amax: torch.Tensor) -> torch.Tensor:
    # Divided by a tensor on amax's device: PyTorch's CUDA division by a
    # Python number multiplies by its rounded reciprocal instead, which
    # can land one ulp off the JAX package's quotient (and the CPU's).
    return amax.clamp_min(1e-12) / torch.full_like(amax, _QMAX)


def _codes(v: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.div(v, scale).round_().clamp_(-_QMAX, _QMAX).to(torch.int8)


def quantize_weight(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel int8 codes of an OIHW weight: -> (``w_q`` int8
    OIHW, ``w_scale`` float32 [O]) with ``w_q * w_scale ~= w``."""
    w = w.to(torch.float32)
    scale = _scale(w.abs().amax(dim=(1, 2, 3)))
    return _codes(w, scale[:, None, None, None]), scale


def activation_scale(x: torch.Tensor) -> torch.Tensor:
    """The per-sample scale (float32 [B]) of an NCHW batch of any float
    dtype. The largest |x| of a sample is the larger of |min| and |max|,
    one pass."""
    lo, hi = torch.aminmax(x.to(torch.float32).reshape(x.shape[0], -1), dim=1)
    return _scale(torch.maximum(lo.neg(), hi))


def activation_codes(x: torch.Tensor, x_scale: torch.Tensor) -> torch.Tensor:
    """The int8 codes (NCHW) of ``x`` at the per-sample scales ``x_scale``."""
    return _codes(x.to(torch.float32), x_scale[:, None, None, None])


def quantize_activations(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-sample int8 codes of an NCHW batch of any float dtype: -> (``x_q``
    int8 NCHW, ``x_scale`` float32 [B]) with ``x_q * x_scale ~= x``."""
    scale = activation_scale(x)
    return activation_codes(x, scale), scale


def int8_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The VALID 3x3 conv of an already padded NCHW ``x`` with the OIHW
    float32 weight ``w`` (the equalized-LR constant applied), on int8
    codes, the result float32 NCHW: the fused modulated int8 conv
    (``ops/cuda/int8_conv.py``) with no modulation, no padding and no
    demodulation. CUDA tensors launch its kernels, CPU tensors take its
    plain version."""
    # imported here: ops/cuda/int8_conv.py builds its plain version from this module
    from one_to_many_gan_torch.ops.cuda.int8_conv import modulated_int8_conv

    w_q, w_scale = quantize_weight(w)
    return modulated_int8_conv(x, None, w_q, w_scale, None, padding=0, pad_mode="zero",
                               dtype=torch.float32)
