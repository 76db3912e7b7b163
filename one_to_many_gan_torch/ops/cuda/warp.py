"""The ADA warp, forward and backward, through hand-written CUDA kernels.

Replaces the JAX package's TPU kernels in ``ops/pallas/warp.py``: the
forward ``_warp_fwd_impl`` (public ``warp_pallas``, body ``_fwd_kernel``)
and the image cotangent ``_warp_bwd`` (body ``_bwd_kernel``). Source:
``csrc/warp.cu``, which reads only the taps in each tent's support where
the TPU kernels contract dense tent matrices.

Bound: bytes. The forward's least time is one read of the image, the two
coordinate planes and the widths, and one write of the output, at the
card's memory rate; the backward's the same with the cotangent in place
of the image. Both do 4 to 81 multiply-adds per pixel. Every block of the
kernels lies in one image, reads its widths once and runs a fully
unrolled loop of ``tap_count`` taps per axis (the longer axis's) from
``first_tap(c, width)``, each weight computed once.

The forward runs one thread per output pixel. The backward gathers: each
pixel of ``dimg`` sums its terms in a fixed order, with no atomics, so
two launches give the same bits (and it runs under
``torch.use_deterministic_algorithms(True)``). A pre-pass fits each
image's coordinates to an affine hint and measures their deviation from
it; each block of the gather stages the output pixels that can reach its
32x32 tile of ``dimg`` (the tile mapped back through the hint, widened
by the tents and the deviation) and each thread sums a 2x2 quad over its
box of them. Any coordinates stay exact: far from affine they are
merely slow.

``warp`` is differentiable in the images only: coordinates and widths
come from the augmentation's draws and get no gradient (the JAX package
gives them zero cotangents). ``warp`` and ``warp_bwd`` take the plain
versions only for tensors on the CPU; for CUDA tensors they launch the
kernels or raise. ``warp.launches`` and ``warp_bwd.launches`` count the
kernels' launches (one per call of ``warp_bwd``: its pre-pass and gather).
"""

from __future__ import annotations

import ctypes

import torch

from one_to_many_gan_torch.ops.cuda import build

# Widest antialiasing tent (input pixels), the JAX package's _AA_MAX_WIDTH;
# the normaliser runs over the extended tap range [-RADIUS, n + RADIUS).
AA_MAX_WIDTH = 4.0
RADIUS = 2 * int(AA_MAX_WIDTH)
# Fewest antialias taps per axis the kernels' loops run (widths <= 1).
AA_MIN_TAPS = 3
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# Elements of the plain versions' largest intermediate per row chunk.
_PLAIN_BUDGET = 2**24
# The backward's pre-pass: one block per HINT_PIXELS pixels of an image,
# at most MAX_HINT_BLOCKS (csrc/warp.cu: kMaxHintBlocks), each thread of
# a block two batches of 4 (PERF.md, the gather's sweep).
HINT_PIXELS = 2048
MAX_HINT_BLOCKS = 128


def _lib() -> ctypes.CDLL:
    lib = build.load("warp")
    dims = [ctypes.c_longlong] * 3
    lib.otm_warp_fwd.argtypes = [*[ctypes.c_void_p] * 6, *dims, *[ctypes.c_int] * 3,
                                 ctypes.c_void_p]
    lib.otm_warp_bwd.argtypes = [*[ctypes.c_void_p] * 7, *dims, *[ctypes.c_int] * 4,
                                 ctypes.c_void_p]
    lib.otm_warp_fwd.restype = lib.otm_warp_bwd.restype = ctypes.c_int
    lib.otm_cuda_error_string.argtypes = [ctypes.c_int]
    lib.otm_cuda_error_string.restype = ctypes.c_char_p
    return lib


def tap_count(width: torch.Tensor) -> torch.Tensor:
    """Taps per axis the kernels' unrolled loops visit for antialias tents
    of float32 ``width``: ``ceil(2 width) + 1``, at least ``AA_MIN_TAPS``;
    0 where the width is above ``AA_MAX_WIDTH``, not positive or NaN (the
    kernels write NaN there). The kernels' ``tap_count``."""
    n = (torch.ceil(2.0 * width.float()) + 1).clamp_min(AA_MIN_TAPS).to(torch.int64)
    ok = (width > 0) & (width <= AA_MAX_WIDTH)
    return torch.where(ok, n, torch.zeros_like(n))


def first_tap(coords: torch.Tensor, width: torch.Tensor) -> torch.Tensor:
    """The first tap ``floor(fl32(c - width))`` of the kernels' loops for
    coordinates ``c`` and widths broadcast against them."""
    return torch.floor(coords.float() - width.float()).to(torch.int64)


def _tent_k(coords: torch.Tensor, n: int, width: torch.Tensor) -> torch.Tensor:
    """[B, R, W, n + 2 RADIUS] antialias tents ``relu(1 - |(c - i) / width|)``
    of ``coords`` [B, R, W] at the taps ``i`` of the extended range
    [-RADIUS, n + RADIUS), before normalisation."""
    idx = torch.arange(-RADIUS, n + RADIUS, dtype=torch.float32, device=coords.device)
    return torch.relu(1.0 - ((coords[..., None] - idx) / width[:, None, None, None]).abs())


def _tent(coords: torch.Tensor, n: int, width: torch.Tensor, antialias: bool) -> torch.Tensor:
    """[B, R, W, n] tent weights of ``coords`` [B, R, W] over the taps of
    [0, n), extended-range normalised when antialiasing (the Pallas
    kernel's ``_tent``)."""
    if not antialias:
        idx = torch.arange(n, dtype=torch.float32, device=coords.device)
        return torch.relu(1.0 - (coords[..., None] - idx).abs())
    k = _tent_k(coords, n, width)
    # Every nonzero k is a multiple of 2^-24 in (0, 1]: their sum is exact
    # in float64, so it rounds once to the kernel's float32 normaliser.
    norm = k.double().sum(dim=-1, keepdim=True).float()
    k = k / norm.clamp_min(1e-8)
    return k[..., RADIUS : RADIUS + n]


def hint_blocks(h: int, w: int) -> int:
    """Blocks per image of the backward's pre-pass for [h, w] images."""
    return max(1, min(MAX_HINT_BLOCKS, -(-h * w // HINT_PIXELS)))


def _row_chunk(b: int, h: int, w: int) -> int:
    return max(1, min(h, _PLAIN_BUDGET // (b * w * (max(h, w) + 2 * RADIUS))))


def _dense_plain(images, sx, sy, width_x, width_y, antialias: bool) -> torch.Tensor:
    """The dense tent contraction of ``warp_plain``, in chunks of output rows."""
    b, h, w = images.shape
    img = images.double()
    chunk = _row_chunk(b, h, w)
    out = []
    for r0 in range(0, h, chunk):
        wx = _tent(sx[:, r0 : r0 + chunk], w, width_x, antialias)
        wy = _tent(sy[:, r0 : r0 + chunk], h, width_y, antialias)
        g = torch.einsum("brxp,byp->brxy", wx.to(images.dtype).double(), img)
        out.append((g * wy.double()).sum(dim=-1))
    return torch.cat(out, dim=1).to(images.dtype)


def _bilinear_taps(coords: torch.Tensor, n: int):
    """The two taps ``floor(c)`` and ``floor(c) + 1`` of width-1 tents at
    ``coords`` on an axis of ``n`` pixels: [(index, weight)], each weight
    ``relu(1 - |c - i|)`` in float32 as ``_tent`` computes it, 0 outside
    [0, n) (the index then clamped into it), NaN at a NaN coordinate."""
    c = coords.float()
    first = torch.floor(c).nan_to_num(0.0).clamp(-2.0, float(n))
    taps = []
    for i in (first, first + 1.0):
        weight = torch.relu(1.0 - (c - i).abs())
        weight = torch.where((i >= 0) & (i < n), weight, torch.zeros_like(weight))
        taps.append((i.clamp(0, n - 1).long(), weight))
    return taps


def _bilinear_plain(images: torch.Tensor, sx: torch.Tensor, sy: torch.Tensor) -> torch.Tensor:
    """``warp_plain`` without antialiasing, by gathering each pixel's two
    taps per axis: the dense contraction's every other term is an exact 0,
    so the same float64 products and sums give the same bits."""
    b, h, w = images.shape
    flat = images.reshape(b, h * w)
    out = None
    for iy, wy in _bilinear_taps(sy, h):
        g = None
        for ix, wx in _bilinear_taps(sx, w):
            px = torch.gather(flat, 1, (iy * w + ix).reshape(b, -1)).reshape(b, h, w)
            term = wx.to(images.dtype).double() * px.double()
            g = term if g is None else g + term
        term = g * wy.double()
        out = term if out is None else out + term
    return out.to(images.dtype)


def warp_plain(
    images: torch.Tensor,
    sx: torch.Tensor,
    sy: torch.Tensor,
    width_x: torch.Tensor,
    width_y: torch.Tensor,
    *,
    antialias: bool,
) -> torch.Tensor:
    """The forward kernel's plain PyTorch version: the dense tent
    contraction, in chunks of output rows. The weights are the Pallas
    kernel's (``wx`` rounded to the image dtype, ``wy`` float32); the sums
    run in float64 and round once to the image dtype, so the result does
    not depend on the order in which a GEMM sums, and the kernel's float32
    sums differ from it by their own rounding alone. Without antialiasing
    the same terms are gathered (``_bilinear_plain``), which costs the
    pixels' count rather than its square."""
    if not antialias:
        return _bilinear_plain(images, sx, sy)
    return _dense_plain(images, sx, sy, width_x, width_y, antialias)


def warp_bwd_plain(
    dout: torch.Tensor,
    sx: torch.Tensor,
    sy: torch.Tensor,
    width_x: torch.Tensor,
    width_y: torch.Tensor,
    *,
    antialias: bool,
) -> torch.Tensor:
    """The backward kernel's plain PyTorch version: the image cotangent
    ``dimg[b, y', x'] = sum_{y, x} wy(y, x; y') * dout[b, y, x] * wx(y, x; x')``,
    the dense transposed contraction in chunks of output rows.

    Rounding follows the Pallas ``_bwd_kernel``, not autograd of the
    forward: ``wx`` stays float32 (the forward rounds it to the image
    dtype), ``dout`` is cast to float32 and ``wy * dout`` is formed in
    float32; the sums run in float64 and round once to ``dout``'s dtype.
    A float64 ``dout`` (a reference, on the CPU) stays float64 throughout."""
    b, h, w = dout.shape
    d = dout.to(torch.promote_types(dout.dtype, torch.float32))
    chunk = _row_chunk(b, h, w)
    acc = torch.zeros((b, h, w), dtype=torch.float64, device=dout.device)
    for r0 in range(0, h, chunk):
        wx = _tent(sx[:, r0 : r0 + chunk], w, width_x, antialias)
        wy = _tent(sy[:, r0 : r0 + chunk], h, width_y, antialias)
        a = wy * d[:, r0 : r0 + chunk, :, None]
        acc += torch.einsum("brxy,brxp->byp", a.double(), wx.double())
    return acc.to(dout.dtype)


def _check_args(fn: str, t: torch.Tensor, sx, sy, width_x, width_y) -> None:
    """Raise unless the kernel takes these tensors: ``t`` contiguous
    non-empty [B,H,W] float32 or bfloat16 on a CUDA device, coordinates
    float32 [B,H,W] and widths float32 [B], contiguous, on its device."""
    if t.dtype not in _DTYPE_CODES:
        msg = f"{fn}: dtype {t.dtype} (float32 or bfloat16 only)"
        raise TypeError(msg)
    if t.dim() != 3 or t.numel() == 0:
        msg = f"{fn}: expected non-empty [B,H,W], got {tuple(t.shape)}"
        raise ValueError(msg)
    b = t.shape[0]
    for name, c, shape in (
        ("sx", sx, t.shape), ("sy", sy, t.shape),
        ("width_x", width_x, (b,)), ("width_y", width_y, (b,)),
    ):
        if c.dtype != torch.float32 or c.shape != shape or c.device != t.device:
            msg = (f"{fn}: {name} must be float32 {tuple(shape)} on {t.device}, "
                   f"got {c.dtype} {tuple(c.shape)} on {c.device}")
            raise ValueError(msg)
    if not all(c.is_contiguous() for c in (t, sx, sy, width_x, width_y)):
        msg = f"{fn}: the tensor, coordinates and widths must be contiguous"
        raise ValueError(msg)


def _check_device(fn: str, t: torch.Tensor) -> None:
    if t.device.type not in ("cpu", "cuda"):
        msg = f"{fn}: unsupported device {t.device}"
        raise ValueError(msg)


def _raise_on(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        reason = lib.otm_cuda_error_string(err).decode()
        msg = f"{what} kernel launch failed: CUDA error {err} ({reason})"
        raise RuntimeError(msg)


def _launch_fwd(images, sx, sy, width_x, width_y, antialias: bool) -> torch.Tensor:
    _check_args("warp", images, sx, sy, width_x, width_y)
    b, h, w = images.shape
    out = torch.empty_like(images)
    lib = _lib()
    with torch.cuda.device(images.device):
        stream = torch.cuda.current_stream(images.device).cuda_stream
        err = lib.otm_warp_fwd(
            images.data_ptr(), sx.data_ptr(), sy.data_ptr(), width_x.data_ptr(),
            width_y.data_ptr(), out.data_ptr(), b, h, w,
            _DTYPE_CODES[images.dtype], int(antialias), RADIUS, stream,
        )
    _raise_on(lib, err, "warp")
    warp.launches += 1
    return out


def warp_bwd(
    dout: torch.Tensor,
    sx: torch.Tensor,
    sy: torch.Tensor,
    width_x: torch.Tensor,
    width_y: torch.Tensor,
    *,
    antialias: bool,
) -> torch.Tensor:
    """The image cotangent of ``warp`` for the output cotangent ``dout``
    ``[B,H,W]``, in ``dout``'s dtype.

    CPU tensor: the plain version. CUDA tensor: the pre-pass and the
    gather, which take a contiguous float32 or bfloat16 ``dout`` and
    contiguous float32 coordinates and widths; anything else raises. The
    gather sums each pixel's terms in a fixed order, so two calls give the
    same bits. With ``antialias``, an image with a NaN coordinate, or a
    width the dispatch refuses (``tap_count`` 0), gets a NaN cotangent over
    the whole image (the plain version computes any width).
    """
    _check_device("warp_bwd", dout)
    if dout.device.type == "cpu":
        return warp_bwd_plain(dout, sx, sy, width_x, width_y, antialias=antialias)
    _check_args("warp_bwd", dout, sx, sy, width_x, width_y)
    b, h, w = dout.shape
    blocks = hint_blocks(h, w)
    # the pre-pass's record per image: the hint, then each block's maxima;
    # written before it is read
    rec = torch.empty((b, 12 + 3 * blocks), dtype=torch.float64, device=dout.device)
    dimg = torch.empty_like(dout)
    lib = _lib()
    with torch.cuda.device(dout.device):
        stream = torch.cuda.current_stream(dout.device).cuda_stream
        err = lib.otm_warp_bwd(
            dout.data_ptr(), sx.data_ptr(), sy.data_ptr(), width_x.data_ptr(),
            width_y.data_ptr(), rec.data_ptr(), dimg.data_ptr(), b, h, w,
            _DTYPE_CODES[dout.dtype], int(antialias), RADIUS, blocks, stream,
        )
    _raise_on(lib, err, "warp_bwd")
    warp_bwd.launches += 1
    return dimg


class _Warp(torch.autograd.Function):
    """Forward: the forward kernel (CUDA) or its plain version (CPU).
    Backward: ``warp_bwd`` on the contiguous cotangent (autograd may hand
    over an expanded or strided one); no gradient for the coordinates and
    widths."""

    @staticmethod
    def forward(ctx, images, sx, sy, width_x, width_y, antialias: bool) -> torch.Tensor:
        if images.device.type == "cpu":
            out = warp_plain(images, sx, sy, width_x, width_y, antialias=antialias)
        else:
            out = _launch_fwd(images, sx, sy, width_x, width_y, antialias)
        ctx.antialias = antialias
        ctx.save_for_backward(sx, sy, width_x, width_y)
        return out

    @staticmethod
    def backward(ctx, dout: torch.Tensor):
        sx, sy, width_x, width_y = ctx.saved_tensors
        dimg = warp_bwd(dout.contiguous(), sx, sy, width_x, width_y, antialias=ctx.antialias)
        return dimg, None, None, None, None, None


def warp(
    images: torch.Tensor,
    sx: torch.Tensor,
    sy: torch.Tensor,
    width_x: torch.Tensor,
    width_y: torch.Tensor,
    *,
    antialias: bool,
) -> torch.Tensor:
    """Sample single-channel images ``[B,H,W]`` at source positions
    ``sx, sy [B,H,W]`` (input pixel units, zero outside the frame) with
    separable tents of per-image widths ``width_x, width_y [B]`` in [1, 4].
    Differentiable in ``images`` (through ``warp_bwd``) only.

    CPU tensor: the plain version. CUDA tensor: the kernel, which takes
    contiguous float32 or bfloat16 images and contiguous float32
    coordinates and widths; anything else raises.
    """
    _check_device("warp", images)
    return _Warp.apply(images, sx, sy, width_x, width_y, antialias)


warp.launches = 0
warp_bwd.launches = 0


def warp_bwd_sum_bound(
    dout: torch.Tensor,
    sx: torch.Tensor,
    sy: torch.Tensor,
    width_x: torch.Tensor,
    width_y: torch.Tensor,
    *,
    antialias: bool,
) -> torch.Tensor:
    """A bound [B,H,W] (float64) on how far the backward kernel's float32
    sum may lie from the exact ``dimg``, proven for every order of its
    terms: ``(n + 2) * 2^-24 * s``, where ``n`` counts the pixel's terms
    of nonzero weight and ``s`` is the sum of their magnitudes. Each of
    the ``n - 1`` rounded adds errs by at most 2^-24 of a partial sum (at
    most ``s``), and each term's two float32 products by 2^-24 of the term
    (3 * 2^-24 * s for all of them, with room for second-order terms).
    The tolerances of the kernel against ``warp_bwd_plain`` in bfloat16
    rest on it: one bfloat16 ulp (the two roundings) plus this bound."""
    b, h, w = dout.shape
    d = dout.float().abs()
    chunk = _row_chunk(b, h, w)
    n = torch.zeros((b, h, w), dtype=torch.float64, device=dout.device)
    s = torch.zeros_like(n)
    for r0 in range(0, h, chunk):
        wx = _tent(sx[:, r0 : r0 + chunk], w, width_x, antialias)
        wy = _tent(sy[:, r0 : r0 + chunk], h, width_y, antialias)
        dr = d[:, r0 : r0 + chunk, :, None]
        s += torch.einsum("brxy,brxp->byp", (wy * dr).double(), wx.double())
        n += torch.einsum("brxy,brxp->byp", ((wy > 0) & (dr > 0)).double(), (wx > 0).double())
    return (n + 2) * 2.0**-24 * s
