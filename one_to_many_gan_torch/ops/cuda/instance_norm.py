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

Gradient: the kernel fills its output through ``ctypes``, outside
autograd, so both paths run inside ``_InstanceNorm``, a
``torch.autograd.Function`` whose backward is the closed-form instance
norm gradient in float32 torch ops,
``dx = rstd * (g - mean(g) - xhat * mean(g * xhat))`` (ReLU's mask
applied to ``g`` first), cast to the input dtype (float64 inputs, a
reference on the CPU, keep float64 throughout). The Pallas kernel has
no backward of its own (JAX differentiates the plain ops), so there is
no backward kernel to port; one written by hand is later performance
work (ROADMAP.md).
"""

from __future__ import annotations

import ctypes

import torch

from one_to_many_gan_torch.ops import activations
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


def _launch(x: torch.Tensor, relu: bool, eps: float) -> torch.Tensor:
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


class _InstanceNorm(torch.autograd.Function):
    """Forward: the kernel (CUDA) or the plain version (CPU). Backward:
    the closed-form gradient from the saved input (and output, for
    ReLU's mask), statistics recomputed in float32 (float64 for a float64
    input, which only the CPU takes: a reference for the card)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, relu: bool, eps: float) -> torch.Tensor:
        if x.device.type == "cpu":
            y = instance_norm_plain(x, relu=relu, eps=eps)
        else:
            y = _launch(x, relu, eps)
        ctx.relu, ctx.eps = relu, eps
        ctx.save_for_backward(x, y if relu else None)
        return y

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        x, y = ctx.saved_tensors
        acc = torch.promote_types(x.dtype, torch.float32)
        xf = x.to(acc)
        mean = xf.mean(dim=(2, 3), keepdim=True)
        var = (xf - mean).square().mean(dim=(2, 3), keepdim=True)
        rstd = torch.rsqrt(var + ctx.eps)
        xhat = (xf - mean) * rstd
        g = grad.to(acc)
        if ctx.relu:
            g = g * (y > 0)
        dx = rstd * (
            g - g.mean(dim=(2, 3), keepdim=True)
            - xhat * (g * xhat).mean(dim=(2, 3), keepdim=True)
        )
        return dx.to(x.dtype), None, None


def fused_instance_norm(
    x: torch.Tensor, *, relu: bool = False, eps: float = 1e-5
) -> torch.Tensor:
    """Instance norm over (H, W) of an NCHW tensor, optional fused ReLU,
    differentiable in ``x``.

    CPU tensor: the plain version. CUDA tensor: the kernel, which takes a
    contiguous, non-empty float32 or bfloat16 NCHW tensor; anything else
    raises. While a kink pattern is recorded or pinned
    (``ops/activations.py``), the ReLU runs there, after the norm.
    """
    if x.device.type not in ("cpu", "cuda"):
        msg = f"fused_instance_norm: unsupported device {x.device}"
        raise ValueError(msg)
    if relu and activations.kinks_open():
        return activations.relu(_InstanceNorm.apply(x, False, eps))
    return _InstanceNorm.apply(x, relu, eps)


fused_instance_norm.launches = 0
