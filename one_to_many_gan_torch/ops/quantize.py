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

from one_to_many_gan_torch.ops.cuda.int8_conv import int8_conv_codes

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


def quantize_activations(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-sample int8 codes of an NCHW batch of any float dtype: -> (``x_q``
    int8 NCHW, ``x_scale`` float32 [B]) with ``x_q * x_scale ~= x``. The
    largest |x| of a sample is the larger of |min| and |max|, one pass."""
    x = x.to(torch.float32)
    lo, hi = torch.aminmax(x.reshape(x.shape[0], -1), dim=1)
    scale = _scale(torch.maximum(lo.neg(), hi))
    return _codes(x, scale[:, None, None, None]), scale


def kernel_operands(x: torch.Tensor, w: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """The int8 conv kernel's operands of a padded NCHW ``x`` and an OIHW
    ``w``: (channels-last activation codes [B, Hp, Wp, C], weight codes
    [O, KH, KW, C], ``x_scale``, ``w_scale``)."""
    x_q, x_scale = quantize_activations(x)
    w_q, w_scale = quantize_weight(w)
    return (x_q.permute(0, 2, 3, 1).contiguous(), w_q.permute(0, 2, 3, 1).contiguous(),
            x_scale, w_scale)


def int8_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The VALID conv of an already padded NCHW ``x`` with the OIHW float32
    weight ``w`` (the equalized-LR constant applied), on int8 codes: both
    quantised, the codes laid out for the kernel (``kernel_operands``,
    ``ops/cuda/int8_conv.py``), the result float32 NCHW. CUDA tensors
    launch the kernel, CPU tensors take its plain version."""
    return int8_conv_codes(*kernel_operands(x, w))
