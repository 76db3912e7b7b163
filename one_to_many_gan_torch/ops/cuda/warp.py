"""The ADA warp forward through the hand-written CUDA kernel.

Replaces the JAX package's TPU kernel ``ops/pallas/warp.py``
(``_warp_fwd_impl``; public ``warp_pallas``, body ``_fwd_kernel``).
Source: ``csrc/warp.cu``, which reads only the taps in each tent's
support where the TPU kernel contracts dense tent matrices.

Bound: bytes. The least time is one read of the image, the two
coordinate planes and the widths, and one write of the output, at the
card's memory rate; the kernel does 4 to 81 multiply-adds per pixel.

``warp`` takes the plain version only for a tensor on the CPU. For a
CUDA tensor it launches the kernel or raises. Either way it raises for
images that require a gradient: the backward kernel has not been ported
yet, and no autograd path may quietly run the plain version meanwhile.
``warp.launches`` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes

import torch

from one_to_many_gan_torch.ops.cuda import build

# Widest antialiasing tent (input pixels), the JAX package's _AA_MAX_WIDTH;
# the normaliser runs over the extended tap range [-RADIUS, n + RADIUS).
AA_MAX_WIDTH = 4.0
RADIUS = 2 * int(AA_MAX_WIDTH)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# Elements of the plain version's largest intermediate per row chunk.
_PLAIN_BUDGET = 2**24


def _lib() -> ctypes.CDLL:
    lib = build.load("warp")
    fn = lib.otm_warp_fwd
    fn.argtypes = [
        *[ctypes.c_void_p] * 6,
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    lib.otm_cuda_error_string.argtypes = [ctypes.c_int]
    lib.otm_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _tent(coords: torch.Tensor, n: int, width: torch.Tensor, antialias: bool) -> torch.Tensor:
    """[B, R, W, n] tent weights of ``coords`` [B, R, W] over the taps of
    [0, n), extended-range normalised when antialiasing (the Pallas
    kernel's ``_tent``)."""
    r = RADIUS if antialias else 0
    idx = torch.arange(-r, n + r, dtype=torch.float32, device=coords.device)
    if not antialias:
        return torch.relu(1.0 - (coords[..., None] - idx).abs())
    k = torch.relu(1.0 - ((coords[..., None] - idx) / width[:, None, None, None]).abs())
    # Every nonzero k is a multiple of 2^-24 in (0, 1]: their sum is exact
    # in float64, so it rounds once to the kernel's float32 normaliser.
    norm = k.double().sum(dim=-1, keepdim=True).float()
    k = k / norm.clamp_min(1e-8)
    return k[..., r : r + n]


def warp_plain(
    images: torch.Tensor,
    sx: torch.Tensor,
    sy: torch.Tensor,
    width_x: torch.Tensor,
    width_y: torch.Tensor,
    *,
    antialias: bool,
) -> torch.Tensor:
    """The kernel's plain PyTorch version: the dense tent contraction, in
    chunks of output rows. The weights are the Pallas kernel's (``wx``
    rounded to the image dtype, ``wy`` float32); the sums run in float64
    and round once to the image dtype, so the result does not depend on
    the order in which a GEMM sums, and the kernel's float32 sums differ
    from it by their own rounding alone."""
    b, h, w = images.shape
    img = images.double()
    chunk = max(1, min(h, _PLAIN_BUDGET // (b * w * (max(h, w) + 2 * RADIUS))))
    out = []
    for r0 in range(0, h, chunk):
        wx = _tent(sx[:, r0 : r0 + chunk], w, width_x, antialias)
        wy = _tent(sy[:, r0 : r0 + chunk], h, width_y, antialias)
        g = torch.einsum("brxp,byp->brxy", wx.to(images.dtype).double(), img)
        out.append((g * wy.double()).sum(dim=-1))
    return torch.cat(out, dim=1).to(images.dtype)


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

    CPU tensor: the plain version. CUDA tensor: the kernel, which takes
    contiguous float32 or bfloat16 images and contiguous float32
    coordinates and widths; anything else raises.
    """
    if images.requires_grad:
        msg = "warp: images require a gradient, but the warp backward is not ported yet"
        raise RuntimeError(msg)
    if images.device.type == "cpu":
        return warp_plain(images, sx, sy, width_x, width_y, antialias=antialias)
    if images.device.type != "cuda":
        msg = f"warp: unsupported device {images.device}"
        raise ValueError(msg)
    if images.dtype not in _DTYPE_CODES:
        msg = f"warp: image dtype {images.dtype} (float32 or bfloat16 only)"
        raise TypeError(msg)
    if images.dim() != 3 or images.numel() == 0:
        msg = f"warp: expected non-empty [B,H,W] images, got {tuple(images.shape)}"
        raise ValueError(msg)
    b = images.shape[0]
    for name, t, shape in (
        ("sx", sx, images.shape), ("sy", sy, images.shape),
        ("width_x", width_x, (b,)), ("width_y", width_y, (b,)),
    ):
        if t.dtype != torch.float32 or t.shape != shape or t.device != images.device:
            msg = (f"warp: {name} must be float32 {tuple(shape)} on {images.device}, "
                   f"got {t.dtype} {tuple(t.shape)} on {t.device}")
            raise ValueError(msg)
    if not all(t.is_contiguous() for t in (images, sx, sy, width_x, width_y)):
        msg = "warp: images, coordinates and widths must be contiguous"
        raise ValueError(msg)
    _, h, w = images.shape
    out = torch.empty_like(images)
    lib = _lib()
    with torch.cuda.device(images.device):
        stream = torch.cuda.current_stream(images.device).cuda_stream
        err = lib.otm_warp_fwd(
            images.data_ptr(), sx.data_ptr(), sy.data_ptr(), width_x.data_ptr(),
            width_y.data_ptr(), out.data_ptr(), b, h, w,
            _DTYPE_CODES[images.dtype], int(antialias), RADIUS, stream,
        )
    if err != 0:
        reason = lib.otm_cuda_error_string(err).decode()
        msg = f"warp kernel launch failed: CUDA error {err} ({reason})"
        raise RuntimeError(msg)
    warp.launches += 1
    return out


warp.launches = 0
