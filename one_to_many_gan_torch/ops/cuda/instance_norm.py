"""Instance norm (+ReLU) through the hand-written CUDA kernel.

Replaces the JAX package's TPU kernel ``ops/pallas/instance_norm.py``
(``_instance_norm_pallas``; public ``instance_norm_pallas`` and
``instance_norm_relu_pallas``), forward only as that kernel is. Source:
``csrc/instance_norm.cu``.

Bound: bytes. The least time is one read of the input and one write of
the output at the card's memory rate; the kernel does a few flops per
element. Its design (one block per (b, c) plane, vector loads, a
block-wide f32 reduction, a centered second pass, a normalize-and-write
pass) is described in the source; it reads each plane three times, the
re-reads served from L2 as far as they fit.

``fused_instance_norm`` takes the plain version only for a tensor on the
CPU. For a CUDA tensor it launches the kernel or raises.
``fused_instance_norm.launches`` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes

import torch

from one_to_many_gan_torch.ops.cuda import build
from one_to_many_gan_torch.ops.norm import instance_norm

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _lib() -> ctypes.CDLL:
    lib = build.load("instance_norm")
    fn = lib.otm_instance_norm
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
        ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    lib.otm_cuda_error_string.argtypes = [ctypes.c_int]
    lib.otm_cuda_error_string.restype = ctypes.c_char_p
    return lib


def instance_norm_plain(
    x: torch.Tensor, *, relu: bool = False, eps: float = 1e-5
) -> torch.Tensor:
    """The kernel's plain PyTorch version: ``ops/norm.py`` + ReLU."""
    y = instance_norm(x, eps)
    return torch.relu(y) if relu else y


def fused_instance_norm(
    x: torch.Tensor, *, relu: bool = False, eps: float = 1e-5
) -> torch.Tensor:
    """Instance norm over (H, W) of an NCHW tensor, optional fused ReLU.

    CPU tensor: the plain version. CUDA tensor: the kernel, which takes a
    contiguous, non-empty float32 or bfloat16 NCHW tensor; anything else
    raises.
    """
    if x.device.type == "cpu":
        return instance_norm_plain(x, relu=relu, eps=eps)
    if x.device.type != "cuda":
        msg = f"fused_instance_norm: unsupported device {x.device}"
        raise ValueError(msg)
    if x.dtype not in _DTYPE_CODES:
        msg = f"fused_instance_norm: dtype {x.dtype} (float32 or bfloat16 only)"
        raise TypeError(msg)
    if x.dim() != 4:
        msg = f"fused_instance_norm: expected NCHW, got shape {tuple(x.shape)}"
        raise ValueError(msg)
    if not x.is_contiguous():
        msg = "fused_instance_norm: input must be contiguous NCHW"
        raise ValueError(msg)
    if x.numel() == 0:
        msg = f"fused_instance_norm: empty input {tuple(x.shape)}"
        raise ValueError(msg)
    b, c, h, w = x.shape
    y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.otm_instance_norm(
            x.data_ptr(), y.data_ptr(), b * c, h * w,
            _DTYPE_CODES[x.dtype], int(relu), float(eps), stream,
        )
    if err != 0:
        reason = lib.otm_cuda_error_string(err).decode()
        msg = f"instance_norm kernel launch failed: CUDA error {err} ({reason})"
        raise RuntimeError(msg)
    fused_instance_norm.launches += 1
    return y


fused_instance_norm.launches = 0
