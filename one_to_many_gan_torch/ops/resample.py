"""Anti-aliased resampling ops (NCHW).

- ``blur3``: 3x3 binomial blur [[1,2,1],[2,4,2],[1,2,1]]/16 per channel
  after a 1-pixel replication (edge) pad.
- ``upsample2x``: bilinear 2x (half-pixel centers), then blur.
- ``downsample2x``: blur, then bilinear resize to (H//2, W//2).

Bilinear sampling follows torch's ``align_corners=False, antialias=False``
convention: source coordinate ``max(0, (dst+0.5)*in/out - 0.5)``, two-tap
lerp, upper index clamped.

The even-size 2x paths fuse the blur and the resample into separable
FIR filters per axis on the edge-padded input, depthwise ``F.conv2d``
calls with the JAX package's taps:

- blur+halve = 4-tap [1,3,3,1]/8, stride 2;
- double+blur = the [1,5,10,10,5,1]/16 stride-2 transposed filter
  (polyphase: even outputs [5,10,1]/16, odd [1,10,5]/16 on
  x[k-1], x[k], x[k+1]), here one depthwise ``conv_transpose2d``.

``bilinear_resize`` (the odd-size fallback) applies dense per-axis
interpolation matrices.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from one_to_many_gan_torch.ops.pad import pad

_BLUR = (0.25, 0.5, 0.25)
_BLUR_HALVE = (0.125, 0.375, 0.375, 0.125)
_DOUBLE_BLUR = (1 / 16, 5 / 16, 10 / 16, 10 / 16, 5 / 16, 1 / 16)


@functools.lru_cache(maxsize=64)
def _taps(
    taps: tuple[float, ...], dim: int, channels: int, dtype: torch.dtype, device: torch.device
) -> torch.Tensor:
    """Depthwise kernel [C, 1, k, 1] (dim 2, along H) or [C, 1, 1, k] (dim 3).

    Built as a normal tensor even under ``torch.inference_mode`` (serving):
    the cache hands the same tensor to training's autograd, which refuses
    inference tensors."""
    with torch.inference_mode(False):
        k = torch.tensor(taps, dtype=dtype, device=device)
        shape = (1, 1, len(taps), 1) if dim == 2 else (1, 1, 1, len(taps))
        return k.reshape(shape).expand(channels, 1, *shape[2:]).contiguous()


def _edge_pad(x: torch.Tensor, dim: int) -> torch.Tensor:
    """1-pixel replication pad along H (dim 2) or W (dim 3), with a
    deterministic backward (``ops/pad.py``)."""
    return pad(x, (0, 0, 1, 1) if dim == 2 else (1, 1, 0, 0), "replicate")


def _fir(x: torch.Tensor, taps: tuple[float, ...], dim: int, stride: int = 1) -> torch.Tensor:
    """Depthwise 1D FIR along H (dim 2) or W (dim 3) of the edge-padded x."""
    c = x.shape[1]
    k = _taps(taps, dim, c, x.dtype, x.device)
    strides = (stride, 1) if dim == 2 else (1, stride)
    return F.conv2d(_edge_pad(x, dim), k, stride=strides, groups=c)


def _double_blur(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Fused 2x bilinear upsample + [1,2,1]/4 blur along one axis.

    Stride-2 transposed conv of the edge-padded input, cropped by 4 on
    each side: output m = sum_t k[t] * dilated(xp)[m + t - 1], which is
    the JAX package's lhs-dilated conv with pad (1, 1); the kernel is
    symmetric, so the transposed conv's flip changes nothing.
    """
    c = x.shape[1]
    k = _taps(_DOUBLE_BLUR, dim, c, x.dtype, x.device)
    strides = (2, 1) if dim == 2 else (1, 2)
    padding = (4, 0) if dim == 2 else (0, 4)
    return F.conv_transpose2d(
        _edge_pad(x, dim), k, stride=strides, padding=padding, groups=c
    )


def blur3(x: torch.Tensor) -> torch.Tensor:
    """Depthwise 3x3 binomial blur with replication padding: separable
    [1,2,1]/4 along H, then W."""
    return _fir(_fir(x, _BLUR, 2), _BLUR, 3)


@functools.lru_cache(maxsize=64)
def _interp_matrix(in_size: int, out_size: int) -> np.ndarray:
    """Dense [out, in] two-tap bilinear interpolation matrix (torch
    half-pixel convention, negative source clamped to 0)."""
    a = np.zeros((out_size, in_size), dtype=np.float32)
    scale = in_size / out_size
    dst = np.arange(out_size, dtype=np.float64)
    src = np.maximum((dst + 0.5) * scale - 0.5, 0.0)
    lo = np.floor(src).astype(np.int64)
    lo = np.minimum(lo, in_size - 1)
    hi = np.minimum(lo + 1, in_size - 1)
    frac = (src - lo).astype(np.float32)
    rows = np.arange(out_size)
    np.add.at(a, (rows, lo), 1.0 - frac)
    np.add.at(a, (rows, hi), frac)
    return a


def _matrix(in_size: int, out_size: int, x: torch.Tensor) -> torch.Tensor:
    return torch.from_numpy(_interp_matrix(in_size, out_size)).to(x.device, x.dtype)


def bilinear_resize(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Bilinear resize of NCHW images; no anti-aliasing (torch semantics)."""
    h, w = x.shape[2], x.shape[3]
    if h != out_h:
        x = _matrix(h, out_h, x) @ x
    if w != out_w:
        x = x @ _matrix(w, out_w, x).T
    return x


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """Bilinear 2x upsample, then smooth."""
    return _double_blur(_double_blur(x, 2), 3)


def downsample2x(x: torch.Tensor) -> torch.Tensor:
    """Smooth, then bilinear downsample to (H//2, W//2)."""
    h, w = x.shape[2], x.shape[3]
    if h % 2 == 0 and w % 2 == 0:
        return _fir(_fir(x, _BLUR_HALVE, 2, stride=2), _BLUR_HALVE, 3, stride=2)
    return bilinear_resize(blur3(x), h // 2, w // 2)
