"""Instance norm (+ReLU) through the hand-written CUDA kernel.

Replaces the JAX package's TPU kernel ``ops/pallas/instance_norm.py``
(``_instance_norm_pallas``; public ``instance_norm_pallas`` and
``instance_norm_relu_pallas``), forward only as that kernel is. Source:
``csrc/instance_norm.cu``.

Bound: bytes. The least time is one read of the input and one write of
the output at the card's memory rate; the kernel does a few flops per
element. It reads each plane from device memory once into shared memory
(bulk copies of aligned 16-byte chunks), takes its statistics there (the
centred variance in float32; in bfloat16 the moment form
``max(E[x^2] - E[x]^2, 0)`` of the Pallas kernel and of the plain
version) and writes the output with 16-byte stores. ``plan`` picks
the block layout from ``(planes, hw, dtype)``: several small planes per
block (``packed``), one plane per block (``resident``), or one plane per
thread-block cluster whose blocks each hold a slice (``cluster``); the
kernel's entry validates the plan and never picks another.

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
from dataclasses import dataclass

import torch

from one_to_many_gan_torch.ops import activations
from one_to_many_gan_torch.ops.cuda import build
from one_to_many_gan_torch.ops.norm import instance_norm

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# The card's limits (H100): shared memory per block, of which the kernel's
# static arrays take 1 KB, and the largest portable cluster.
SMEM_PER_BLOCK = 232448
MAX_DYNAMIC_SMEM = SMEM_PER_BLOCK - 1024
MAX_CLUSTER = 8
# Layout choices, from a sweep of the plans on the card (PERF.md, PR 5):
# a plane of at most PACK_BYTES is packed, several to a block of at most
# PACK_BYTES; one of at most RESIDENT_BYTES is resident, 256 threads up to
# SMALL_PLANE_BYTES and 512 above; a larger one is split over a cluster
# of MAX_CLUSTER blocks of 256 threads (BLOCK_THREADS). Clusters for planes that fit one
# block, to fill the SMs when the planes are few, measured slower.
PACK_BYTES = 16384
SMALL_PLANE_BYTES = 32768
RESIDENT_BYTES = 131072
BLOCK_THREADS = 256


@dataclass(frozen=True)
class Plan:
    """How the kernel lays ``planes`` planes of ``hw`` elements on blocks.

    ``packed``: ``planes_per_block`` consecutive planes per block,
    ``threads // planes_per_block`` threads per plane. ``resident``: one
    plane per block. ``cluster``: one plane per cluster of ``cluster``
    blocks, block ``r`` of a cluster holding elements
    ``[r * slice, (r + 1) * slice)`` of its plane (``slice`` =
    ``ceil(hw / cluster)``). ``smem_bytes`` is the dynamic shared memory
    of one block: its range of elements at any 16-byte offset."""

    variant: str
    planes_per_block: int
    cluster: int
    threads: int
    smem_bytes: int
    grid: int


def _range_smem(elems: int, esize: int) -> int:
    return (elems * esize + 30) // 16 * 16


def plan(planes: int, hw: int, dtype: torch.dtype) -> Plan:
    """The kernel's block layout for ``planes`` planes of ``hw`` elements
    of ``dtype``; raises ``ValueError`` for a shape the kernel cannot
    take (a plane over ``MAX_CLUSTER`` blocks' shared memory, a grid over
    2^31 - 1 blocks)."""
    if dtype not in _DTYPE_CODES:
        msg = f"instance norm plan: dtype {dtype} (float32 or bfloat16 only)"
        raise TypeError(msg)
    if planes <= 0 or hw <= 0:
        msg = f"instance norm plan: {planes} planes of {hw} elements"
        raise ValueError(msg)
    esize = torch.finfo(dtype).bits // 8
    plane_bytes = hw * esize
    if plane_bytes <= PACK_BYTES:
        ppb = 8
        while ppb > 1 and ppb * plane_bytes > PACK_BYTES:
            ppb //= 2
        return _checked(Plan("packed", ppb, 1, BLOCK_THREADS,
                             _range_smem(ppb * hw, esize), -(-planes // ppb)), hw)
    if plane_bytes <= RESIDENT_BYTES:
        threads = BLOCK_THREADS if plane_bytes <= SMALL_PLANE_BYTES else 2 * BLOCK_THREADS
        return _checked(Plan("resident", 1, 1, threads, _range_smem(hw, esize), planes), hw)
    smem = _range_smem(-(-hw // MAX_CLUSTER), esize)
    return _checked(Plan("cluster", 1, MAX_CLUSTER, BLOCK_THREADS, smem, planes * MAX_CLUSTER),
                    hw)


def _checked(p: Plan, hw: int) -> Plan:
    if p.smem_bytes > MAX_DYNAMIC_SMEM:
        msg = (f"instance norm plan: a plane of {hw} elements needs {p.smem_bytes} bytes of "
               f"shared memory per block even over a cluster of {p.cluster} "
               f"(at most {MAX_DYNAMIC_SMEM})")
        raise ValueError(msg)
    if p.grid > 2**31 - 1:
        msg = f"instance norm plan: {p.grid} blocks (at most 2^31 - 1)"
        raise ValueError(msg)
    return p


def _lib() -> ctypes.CDLL:
    lib = build.load("instance_norm")
    fn = lib.otm_instance_norm
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
        ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p,
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


def _launch(x: torch.Tensor, relu: bool, eps: float, layout: Plan | None = None) -> torch.Tensor:
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
    if layout is None:
        layout = plan(b * c, h * w, x.dtype)
    y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.otm_instance_norm(
            x.data_ptr(), y.data_ptr(), b * c, h * w,
            _DTYPE_CODES[x.dtype], int(relu), float(eps),
            layout.planes_per_block, layout.cluster, layout.threads, stream,
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
