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

**Split form.** Under the spatial axis (``parallel/halo.py``) a rank
holds one band of rows of each plane. ``fused_instance_norm`` then runs
``_SplitInstanceNorm``: ``instance_norm_partials`` (the band's float32
mean and centred sum of squares, or in bfloat16 its sum and sum of
squares, per plane, then the band's element count: ``[planes + 1, 2]``),
one all-gather of those partials over the spatial group, and
``instance_norm_apply``, which combines the ``[S, planes + 1, 2]``
partials in band order (Chan's pairwise update in float32; summed sums
and the moment form in bfloat16), so that every rank holds bitwise the
same statistics, and normalises the band: two launches of the same
kernel in two more modes, on the same plans, and one small collective
per site. ``partials_plain`` and ``apply_plain`` are their plain
versions (torch ops on the band and its partials, the same combination
in the same order), which CPU tensors take. The backward is the closed
form below, its plane sums (the statistics, and the means of ``g`` and
``g * xhat``) summed over the group by a differentiable all-reduce, so
that R1 differentiates it again.

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
from one_to_many_gan_torch.parallel import halo

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
    part = lib.otm_instance_norm_partials
    part.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    part.restype = ctypes.c_int
    apply = lib.otm_instance_norm_apply
    apply.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    apply.restype = ctypes.c_int
    lib.otm_cuda_error_string.argtypes = [ctypes.c_int]
    lib.otm_cuda_error_string.restype = ctypes.c_char_p
    return lib


def instance_norm_plain(
    x: torch.Tensor, *, relu: bool = False, eps: float = 1e-5
) -> torch.Tensor:
    """The kernel's plain PyTorch version: ``ops/norm.py`` + ReLU."""
    y = instance_norm(x, eps)
    return torch.relu(y) if relu else y


def _check(x: torch.Tensor, name: str, *, empty_ok: bool = False) -> None:
    if x.dtype not in _DTYPE_CODES:
        msg = f"{name}: dtype {x.dtype} (float32 or bfloat16 only)"
        raise TypeError(msg)
    if x.dim() != 4:
        msg = f"{name}: expected NCHW, got shape {tuple(x.shape)}"
        raise ValueError(msg)
    if not x.is_contiguous():
        msg = f"{name}: input must be contiguous NCHW"
        raise ValueError(msg)
    if x.numel() == 0 and not (empty_ok and x.shape[0] * x.shape[1] > 0):
        msg = f"{name}: empty input {tuple(x.shape)}"
        raise ValueError(msg)


def _raise_for(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        reason = lib.otm_cuda_error_string(err).decode()
        msg = f"{what} kernel launch failed: CUDA error {err} ({reason})"
        raise RuntimeError(msg)


def _launch(x: torch.Tensor, relu: bool, eps: float, layout: Plan | None = None) -> torch.Tensor:
    _check(x, "fused_instance_norm")
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
    _raise_for(lib, err, "instance_norm")
    fused_instance_norm.launches += 1
    return y


# ------------------------------------------------------------- split form


def partials_plain(x: torch.Tensor) -> torch.Tensor:
    """The partials kernel's plain version: ``[planes + 1, 2]`` in float32
    (float64 for a float64 band): per plane its band's mean and centred sum
    of squares, or for bfloat16 its sum and sum of squares; then (element
    count, 0). An empty band gives zeros."""
    acc = torch.promote_types(x.dtype, torch.float32)
    b, c, h, w = x.shape
    out = torch.zeros((b * c + 1, 2), dtype=acc, device=x.device)
    out[-1, 0] = float(h * w)
    if h * w == 0:
        return out
    xf = x.to(acc).reshape(b * c, h * w)
    if x.dtype == torch.bfloat16:
        out[:-1, 0] = xf.sum(dim=1)
        out[:-1, 1] = xf.square().sum(dim=1)
    else:
        mean = xf.mean(dim=1)
        out[:-1, 0] = mean
        out[:-1, 1] = (xf - mean[:, None]).square().sum(dim=1)
    return out


def combine_plain(gathered: torch.Tensor, moments: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """(mean, biased variance) per plane from every band's partials
    ``[S, planes + 1, 2]``, combined in band order as the apply kernel
    does: Chan's update (float32), or the summed sums and the moment form
    ``max(E[x^2] - E[x]^2, 0)`` (``moments``, bfloat16)."""
    planes = gathered.shape[1] - 1
    n = gathered.new_zeros(())
    a = gathered.new_zeros(planes)
    b = gathered.new_zeros(planes)
    for t in range(gathered.shape[0]):
        nt, pa, pb = gathered[t, planes, 0], gathered[t, :planes, 0], gathered[t, :planes, 1]
        if moments:
            a, b, n = a + pa, b + pb, n + nt
        else:
            nn = n + nt
            f = nt / nn.clamp_min(1.0)
            delta = pa - a
            a = a + delta * f
            b = (b + pb) + (delta * delta) * (n * f)
            n = nn
    if moments:
        mean = a / n
        return mean, (b / n - mean * mean).clamp_min(0.0)
    return a, b / n


def apply_plain(x: torch.Tensor, gathered: torch.Tensor, *, relu: bool = False,
                eps: float = 1e-5) -> torch.Tensor:
    """The apply kernel's plain version: the band ``x`` normalised by the
    statistics ``combine_plain`` takes from ``gathered``, rounded as
    ``ops/norm.py`` rounds each dtype, then the ReLU."""
    b, c = x.shape[:2]
    mean, var = combine_plain(gathered, x.dtype == torch.bfloat16)
    mean, var = mean.reshape(b, c, 1, 1), var.reshape(b, c, 1, 1)
    y = (x - mean.to(x.dtype)) * torch.rsqrt(var + eps).to(x.dtype)
    return torch.relu(y) if relu else y


def instance_norm_partials(x: torch.Tensor, layout: Plan | None = None) -> torch.Tensor:
    """The partials of a band ``x`` (NCHW): the plain version on the CPU,
    the kernel on the card (an empty band launches nothing)."""
    if x.device.type == "cpu":
        return partials_plain(x)
    _check(x, "instance_norm_partials", empty_ok=True)
    b, c, h, w = x.shape
    out = torch.zeros((b * c + 1, 2), dtype=torch.float32, device=x.device)
    if h * w == 0:
        return out
    if layout is None:
        layout = plan(b * c, h * w, x.dtype)
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.otm_instance_norm_partials(
            x.data_ptr(), out.data_ptr(), b * c, h * w, _DTYPE_CODES[x.dtype],
            layout.planes_per_block, layout.cluster, layout.threads, stream)
    _raise_for(lib, err, "instance_norm_partials")
    instance_norm_partials.launches += 1
    return out


instance_norm_partials.launches = 0


def instance_norm_apply(x: torch.Tensor, gathered: torch.Tensor, *, relu: bool = False,
                        eps: float = 1e-5, layout: Plan | None = None) -> torch.Tensor:
    """The band ``x`` normalised by every band's partials ``gathered``
    ``[S, planes + 1, 2]`` (float32, band order): the plain version on the
    CPU, the kernel on the card (an empty band launches nothing)."""
    if x.device.type == "cpu":
        return apply_plain(x, gathered, relu=relu, eps=eps)
    _check(x, "instance_norm_apply", empty_ok=True)
    b, c, h, w = x.shape
    if gathered.dtype != torch.float32 or gathered.shape[1:] != (b * c + 1, 2):
        msg = (f"instance_norm_apply: partials {tuple(gathered.shape)} {gathered.dtype}, "
               f"expected [S, {b * c + 1}, 2] float32")
        raise ValueError(msg)
    y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    if h * w == 0:
        return y
    if layout is None:
        layout = plan(b * c, h * w, x.dtype)
    gathered = gathered.contiguous()
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.otm_instance_norm_apply(
            x.data_ptr(), y.data_ptr(), gathered.data_ptr(), gathered.shape[0], b * c, h * w,
            _DTYPE_CODES[x.dtype], int(relu), float(eps), layout.planes_per_block,
            layout.cluster, layout.threads, stream)
    _raise_for(lib, err, "instance_norm_apply")
    instance_norm_apply.launches += 1
    return y


instance_norm_apply.launches = 0


def gather_partials(part: torch.Tensor, sp: halo.Spatial) -> torch.Tensor:
    """Every band's partials, ``[S, planes + 1, 2]`` in band order: one
    all-gather over the spatial group."""
    out = part.new_empty((sp.size * part.shape[0], *part.shape[1:]))
    torch.distributed.all_gather_into_tensor(out, part.contiguous(), group=sp.pg)
    out = out.view(sp.size, *part.shape)
    sp.note("in_partials", out)
    return out


class _SplitInstanceNorm(torch.autograd.Function):
    """The instance norm of planes split into bands over ``sp``: forward
    the partials, their all-gather and the apply (kernels on the card,
    plain versions on the CPU); backward the closed form, its plane sums
    over the group (``halo.all_reduce``), differentiable again."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, relu: bool, eps: float, sp: halo.Spatial):
        gathered = gather_partials(instance_norm_partials(x), sp)
        y = instance_norm_apply(x, gathered, relu=relu, eps=eps)
        ctx.relu, ctx.eps, ctx.sp = relu, eps, sp
        ctx.save_for_backward(x, y if relu else None, gathered)
        return y

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        x, y, gathered = ctx.saved_tensors
        sp = ctx.sp
        acc = torch.promote_types(x.dtype, torch.float32)
        b, c = x.shape[:2]
        count = gathered[:, -1, 0].sum().to(acc)
        xf = x.to(acc)
        mean = halo.all_reduce(xf.sum(dim=(2, 3)), sp) / count
        d = xf - mean[:, :, None, None]
        g = grad.to(acc)
        if ctx.relu:
            g = g * (y > 0)
        sums = halo.all_reduce(torch.stack(
            [d.square().sum(dim=(2, 3)), g.sum(dim=(2, 3)), (g * d).sum(dim=(2, 3))]), sp)
        rstd = torch.rsqrt(sums[0] / count + ctx.eps)[:, :, None, None]
        g_mean = (sums[1] / count)[:, :, None, None]
        gx_mean = rstd * (sums[2] / count)[:, :, None, None]
        dx = rstd * (g - g_mean - d * rstd * gx_mean)
        return dx.to(x.dtype), None, None, None


class _InstanceNorm(torch.autograd.Function):
    """Forward: the kernel (CUDA) or the plain version (CPU). Backward:
    the closed-form gradient from the saved input (and output, for
    ReLU's mask), statistics recomputed in float32 (float64 for a float64
    input, which only the CPU takes: a reference for the card).

    The backward is plain differentiable torch ops of the saved input, so
    it differentiates again (lazy R1 takes its gradient): a second-order
    pass differentiates the closed form, while the forward stays the
    kernel. With ReLU the ``y > 0`` mask is a constant there, which is
    right: ReLU's second derivative is 0."""

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
    (``ops/activations.py``), the ReLU runs there, after the norm. Under a
    spatial group (``halo.banded``) ``x`` is a band of each plane and the
    split form runs (module docstring).
    """
    if x.device.type not in ("cpu", "cuda"):
        msg = f"fused_instance_norm: unsupported device {x.device}"
        raise ValueError(msg)
    sp = halo.current()

    def norm(fuse: bool) -> torch.Tensor:
        if sp is not None:
            return _SplitInstanceNorm.apply(x.contiguous(), fuse, eps, sp)
        return _InstanceNorm.apply(x, fuse, eps)

    if relu and activations.kinks_open():
        return activations.relu(norm(False))
    return norm(relu)


fused_instance_norm.launches = 0
