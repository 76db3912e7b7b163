"""The decoder's 2x upsample through the hand-written CUDA kernel.

``ops/resample.py::upsample2x`` of a whole NCHW map (bilinear doubling,
then the [1, 2, 1] / 4 blur, along H and W, with edge padding) as one
launch of ``csrc/upsample.cu``, in place of two edge pads and two cuDNN
grouped transposed convolutions. Replaces no TPU kernel: the JAX package
computes it with XLA's lhs-dilated conv (``ops/resample.py``,
``_double_blur_axis``).

Bound: bytes. The least time is one read of the input and one write of
the 4x larger output at the card's memory rate (``bound_bytes``); the
kernel does ~10 flops an output. Each thread walks a strip of ``ROWS``
input rows of four columns, three rows in registers, and writes each
output row's eight values with 16-byte stores (the source's note).

``upsample2x`` launches the kernel on a contiguous float32 or bfloat16
CUDA tensor, or raises; it has no CPU mode. ``ops/resample.py`` holds
the plain version (``upsample2x_plain``), which CPU tensors take, and
the ``autograd.Function`` around both. ``upsample2x.launches`` counts
the kernel's launches.
"""

from __future__ import annotations

import ctypes
import math

import torch

from one_to_many_gan_torch.ops.cuda import build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# Input rows a thread walks, by dtype, and threads a block: the fastest
# pair at both serving sites in a sweep of 1-16 rows and 128-1024 threads
# (scripts/sweep_torch_kernels.py up-plans on an H100; PERF.md). Short strips
# put more threads, so more loads, in flight; that gains more than a long
# strip's reuse of its rows saves (which L1 catches anyway).
ROWS = {torch.bfloat16: 2, torch.float32: 1}
THREADS = 512


def _lib() -> ctypes.CDLL:
    lib = build.load("upsample")
    lib.otm_upsample2x.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                                   *[ctypes.c_int] * 5, ctypes.c_void_p]
    lib.otm_upsample2x.restype = ctypes.c_int
    lib.otm_cuda_error_string.argtypes = [ctypes.c_int]
    lib.otm_cuda_error_string.restype = ctypes.c_char_p
    return lib


def bound_bytes(shape: tuple[int, ...], esize: int) -> int:
    """The least bytes ``upsample2x`` of an NCHW ``shape`` moves: one read
    of the input and one write of the output, 4x the input."""
    return 5 * math.prod(shape) * esize


def upsample2x(x: torch.Tensor, *, rows: int | None = None,
               threads: int = THREADS) -> torch.Tensor:
    """``ops/resample.py::upsample2x_plain`` of a contiguous, non-empty
    float32 or bfloat16 NCHW CUDA tensor, in one launch: [B, C, H, W] ->
    [B, C, 2H, 2W]. Anything else raises. ``rows`` (default
    ``ROWS[dtype]``) and ``threads`` set the kernel's strip height and
    block size (sweeps only)."""
    if x.device.type != "cuda":
        msg = (f"upsample2x kernel: a CUDA tensor, got one on {x.device} (the plain version "
               "is ops/resample.py::upsample2x_plain)")
        raise ValueError(msg)
    if x.dtype not in _DTYPE_CODES:
        msg = f"upsample2x kernel: dtype {x.dtype} (float32 or bfloat16 only)"
        raise TypeError(msg)
    if x.dim() != 4 or x.numel() == 0:
        msg = f"upsample2x kernel: a non-empty NCHW tensor, got shape {tuple(x.shape)}"
        raise ValueError(msg)
    if not x.is_contiguous():
        msg = (f"upsample2x kernel: the input must be contiguous NCHW, got strides "
               f"{x.stride()} for shape {tuple(x.shape)}")
        raise ValueError(msg)
    b, c, h, w = x.shape
    if rows is None:
        rows = ROWS[x.dtype]
    y = torch.empty((b, c, 2 * h, 2 * w), dtype=x.dtype, device=x.device)
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.otm_upsample2x(x.data_ptr(), y.data_ptr(), b * c, h, w,
                                 _DTYPE_CODES[x.dtype], rows, threads, stream)
    if err != 0:
        reason = lib.otm_cuda_error_string(err).decode()
        msg = f"upsample2x kernel launch failed: CUDA error {err} ({reason})"
        raise RuntimeError(msg)
    upsample2x.launches += 1
    return y


upsample2x.launches = 0
