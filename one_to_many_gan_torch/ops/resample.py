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
interpolation matrices; ``pil_bicubic_resize`` (the FID extractor's
resize) does the same with PIL's antialiased bicubic weights.

The FIRs' depthwise convs (``_fir``) run inside a pair of
``autograd.Function``s, each the other's backward (the conv and its
transpose by the same constant taps), so that a derivative of any order
is one depthwise conv. R1 differentiates the discriminator's
downsampling twice, and PyTorch's own double backward of a grouped conv
runs one conv per channel: at 512x512 it made R1's step 18.8 s instead
of about 0.1 s.

``upsample2x`` of a whole map is one ``autograd.Function``,
``_Upsample2x``: on the card one launch of the hand-written kernel
``ops/cuda/upsample.py`` (both axes and the edge pads in one pass), on
the CPU its plain version ``upsample2x_plain`` (the two transposed FIRs
above). Its backward is the exact adjoint from this module's ops: per
axis, in reverse order, the stride-2 depthwise conv by the same six taps
(``_DepthwiseConv``, padding 4: the transposed conv's crop), then the
fold of the edge pad (``ops/pad.py``); so every derivative order stays
depthwise convs.

Under a spatial group (``parallel/halo.py``) ``upsample2x`` and
``downsample2x`` take their input's global height ``h`` and run on this
rank's band of rows: each H pass fetches the input rows its output band
reads and edge-pads them only at the map's true top and bottom; the odd
size's interpolation matrix is banded (the rows of the output band, the
columns they read); the W passes are those of one process.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from one_to_many_gan_torch.ops.cuda import upsample as upsample_kernel
from one_to_many_gan_torch.ops.pad import _fold, pad
from one_to_many_gan_torch.parallel import halo

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


class _DepthwiseConv(torch.autograd.Function):
    """``F.conv2d(x, k, stride, padding, groups=C)`` by constant taps ``k``
    (zero ``padding``); its backward is ``_DepthwiseConvT`` (module
    docstring)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, k: torch.Tensor, stride: tuple[int, int],
                padding: tuple[int, int] = (0, 0)):
        ctx.save_for_backward(k)
        ctx.stride, ctx.padding, ctx.size = stride, padding, tuple(x.shape[-2:])
        return F.conv2d(x, k, stride=stride, padding=padding, groups=x.shape[1])

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        (k,) = ctx.saved_tensors
        return _DepthwiseConvT.apply(g, k, ctx.stride, ctx.size, ctx.padding), None, None, None


class _DepthwiseConvT(torch.autograd.Function):
    """The transpose of ``_DepthwiseConv`` onto an input of ``size``; its
    backward is ``_DepthwiseConv``."""

    @staticmethod
    def forward(ctx, g: torch.Tensor, k: torch.Tensor, stride: tuple[int, int],
                size: tuple[int, int], padding: tuple[int, int]):
        ctx.save_for_backward(k)
        ctx.stride, ctx.padding = stride, padding
        extra = [n - ((m - 1) * s - 2 * p + t)
                 for n, m, s, p, t in zip(size, g.shape[-2:], stride, padding, k.shape[-2:],
                                          strict=True)]
        return F.conv_transpose2d(g, k, stride=stride, padding=padding, output_padding=extra,
                                  groups=g.shape[1])

    @staticmethod
    def backward(ctx, gg: torch.Tensor):
        (k,) = ctx.saved_tensors
        return _DepthwiseConv.apply(gg, k, ctx.stride, ctx.padding), None, None, None, None


def _fir(x: torch.Tensor, taps: tuple[float, ...], dim: int, stride: int = 1) -> torch.Tensor:
    """Depthwise 1D FIR along H (dim 2) or W (dim 3) of the edge-padded x."""
    c = x.shape[1]
    k = _taps(taps, dim, c, x.dtype, x.device)
    strides = (stride, 1) if dim == 2 else (1, stride)
    return _DepthwiseConv.apply(_edge_pad(x, dim), k, strides)


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


def upsample2x_plain(x: torch.Tensor) -> torch.Tensor:
    """``_double_blur`` along H, then W: the upsample kernel's plain
    version, which CPU tensors take."""
    return _double_blur(_double_blur(x, 2), 3)


def _double_blur_adjoint(g: torch.Tensor, dim: int) -> torch.Tensor:
    """The input gradient of ``_double_blur(x, dim)`` for its output
    gradient ``g``: the stride-2 conv by the same (symmetric) taps, padded
    by the 4 the transposed conv crops, then the edge pad folded back."""
    k = _taps(_DOUBLE_BLUR, dim, g.shape[1], g.dtype, g.device)
    strides, padding = ((2, 1), (4, 0)) if dim == 2 else ((1, 2), (0, 4))
    gp = _DepthwiseConv.apply(g, k, strides, padding)
    return _fold(gp, (0, 0, 1, 1) if dim == 2 else (1, 1, 0, 0), "replicate")


class _Upsample2x(torch.autograd.Function):
    """``upsample2x_plain`` of a whole map: the kernel on the card, the
    plain version on the CPU; backward the adjoint of its two passes, W
    first (module docstring)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor) -> torch.Tensor:
        if x.device.type == "cpu":
            return upsample2x_plain(x)
        return upsample_kernel.upsample2x(x.contiguous())

    @staticmethod
    def backward(ctx, g: torch.Tensor) -> torch.Tensor:
        return _double_blur_adjoint(_double_blur_adjoint(g, 3), 2)


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


def _pil_bicubic_kernel(t: np.ndarray, a: float = -0.5) -> np.ndarray:
    """PIL's bicubic (Keys, a = -0.5), support 2."""
    t = np.abs(t)
    return np.where(
        t < 1.0,
        ((a + 2.0) * t - (a + 3.0)) * t * t + 1.0,
        np.where(t < 2.0, a * (((t - 5.0) * t + 8.0) * t - 4.0), 0.0),
    )


@functools.lru_cache(maxsize=16)
def _pil_bicubic_matrix(in_size: int, out_size: int) -> np.ndarray:
    """Dense [out, in] float32 matrix of PIL's ``Image.resize`` with
    ``Resampling.BICUBIC``, antialiasing included: on a reduction the
    filter's support widens by the ratio, and each row's weights are
    normalised to sum to 1 (PIL's ``precompute_coeffs``)."""
    a = np.zeros((out_size, in_size), dtype=np.float64)
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale
    for i in range(out_size):
        center = (i + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size)
        taps = np.arange(xmin, xmax)
        w = _pil_bicubic_kernel((taps - center + 0.5) / filterscale)
        a[i, xmin:xmax] = w / w.sum()
    return a.astype(np.float32)


def pil_bicubic_resize(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """PIL-exact antialiased bicubic resize of NCHW images (clean-fid's
    299x299 evaluation resize, on the 0..255 scale): one matmul per axis
    by the matrices above, on ``x``'s device and in its dtype."""
    h, w = x.shape[2], x.shape[3]
    if (h, w) == (out_h, out_w):
        return x
    mh = torch.from_numpy(_pil_bicubic_matrix(h, out_h)).to(x.device, x.dtype)
    mw = torch.from_numpy(_pil_bicubic_matrix(w, out_w)).to(x.device, x.dtype)
    return torch.matmul(torch.matmul(mh, x), mw.T)


def _fir_band(x: torch.Tensor, h: int, taps: tuple[float, ...],
              stride: int) -> halo.Window:
    """This rank's band of ``_fir(X, taps, 2, stride)`` for its band ``x``
    of a map ``X`` of ``h`` rows (an output row ``o`` reads rows
    ``o * stride - 1 .. o * stride - 2 + len(taps)`` of the edge-padded
    map), as a ``Window`` of the output: its ``span``, then ``keep``."""
    t = len(taps)
    win = halo.window(x, h, (h + 2 - t) // stride + 1,
                      lambda a, b: (a * stride - 1, (b - 1) * stride - 1 + t), "replicate")
    k = _taps(taps, 2, x.shape[1], x.dtype, x.device)
    return win._replace(rows=_DepthwiseConv.apply(win.rows, k, (stride, 1)))


def _double_blur_band(x: torch.Tensor, h: int) -> halo.Window:
    """This rank's band of ``_double_blur(X, 2)`` (``2 h`` rows) for its
    band ``x`` of ``X``: output rows ``[lo, hi)`` read input rows
    ``lo // 2 - 1 .. (hi - 1) // 2 + 1``, and the transposed conv of those
    (edge-padded at the map's border) gives output rows from
    ``2 (lo // 2)``."""
    win = halo.window(x, h, 2 * h, lambda a, b: (a // 2 - 1, (b - 1) // 2 + 2), "replicate")
    c = x.shape[1]
    k = _taps(_DOUBLE_BLUR, 2, c, x.dtype, x.device)
    y = F.conv_transpose2d(win.rows, k, stride=(2, 1), padding=(4, 0), groups=c)
    lo, hi = win.span
    first = 2 * (lo // 2)
    return win._replace(rows=y[:, :, lo - first : hi - first])


@functools.lru_cache(maxsize=256)
def _band_columns(in_size: int, out_size: int, lo: int, hi: int) -> tuple[int, int]:
    """The input rows ``[ia, ib)`` that output rows ``[lo, hi)`` of the
    interpolation matrix weigh."""
    cols = np.nonzero(_interp_matrix(in_size, out_size)[lo:hi].any(axis=0))[0]
    return int(cols[0]), int(cols[-1]) + 1


def _resize_band(x: torch.Tensor, h: int) -> torch.Tensor:
    """This rank's band of ``bilinear_resize(blur3(X), h // 2, W // 2)``
    for its band ``x`` of ``X`` (``h`` rows): the interpolation matrix's
    rows of the output band and the columns they weigh, on those input
    rows blurred (which read one row more on each side)."""
    n_out = h // 2
    w = x.shape[3]

    def reads(a: int, b: int) -> tuple[int, int]:
        ia, ib = _band_columns(h, n_out, a, b)
        return ia - 1, ib + 1

    win = halo.window(x, h, n_out, reads, "replicate")
    k = _taps(_BLUR, 2, x.shape[1], x.dtype, x.device)
    blurred = _fir(_DepthwiseConv.apply(win.rows, k, (1, 1)), _BLUR, 3)
    lo, hi = win.span
    ia, ib = _band_columns(h, n_out, lo, hi)
    y = _matrix(h, n_out, x)[lo:hi, ia:ib] @ blurred
    if w != w // 2:
        y = y @ _matrix(w, w // 2, x).T
    return y[:, :, : win.keep]


def upsample2x(x: torch.Tensor, h: int | None = None) -> torch.Tensor:
    """Bilinear 2x upsample, then smooth (under a spatial group: this
    rank's band of a map of ``h`` rows -> its band of ``2 h``)."""
    if halo.current() is not None:
        win = _double_blur_band(x, h)
        return _double_blur(win.rows, 3)[:, :, : win.keep]
    return _Upsample2x.apply(x)


def downsample2x(x: torch.Tensor, h: int | None = None) -> torch.Tensor:
    """Smooth, then bilinear downsample to (H//2, W//2) (under a spatial
    group: this rank's band of a map of ``h`` rows -> its band of
    ``h // 2``)."""
    w = x.shape[3]
    if halo.current() is not None:
        if h % 2 == 0 and w % 2 == 0:
            win = _fir_band(x, h, _BLUR_HALVE, 2)
            return _fir(win.rows, _BLUR_HALVE, 3, stride=2)[:, :, : win.keep]
        return _resize_band(x, h)
    h = x.shape[2]
    if h % 2 == 0 and w % 2 == 0:
        return _fir(_fir(x, _BLUR_HALVE, 2, stride=2), _BLUR_HALVE, 3, stride=2)
    return bilinear_resize(blur3(x), h // 2, w // 2)
