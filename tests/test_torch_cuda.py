"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and skips without one: a CUDA kernel
has no CPU mode. The file imports neither JAX nor the JAX package, so it
runs on a GPU host that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -m cuda

Tolerances are the JAX package's own: instance norm 2e-5 in float32 and
0.05 in bfloat16, the warp 2e-6 in float32 (tests/test_pallas_kernels.py).
The warp in bfloat16 is held to one bfloat16 ulp of the output plus 2^-19
of the largest |image| value: kernel and plain version use the same
weights and form the same exact products; the plain version sums them in
float64 and rounds once, the kernel sums in float32, which errs by at
most (nx + ny) * 2^-24 * max|x| * 1.03 for nx, ny <= 12 taps per axis
whose weights sum to at most 1.03: 25 * 2^-24 < 2^-19. That term is more
than a bf16 ulp where the taps cancel to an output near 0. The warp's
backward (a pre-pass and a gather) in float32 is held to the same 2e-6,
and in bfloat16 to one bfloat16 ulp plus ``warp_bwd_sum_bound``, a proven
bound on the error of the kernel's float32 sums in any order; under a 4x
magnification and on random coordinates, float32 to 2e-6 plus that bound. The instance
norm's gradient on the card is held to the plain version's autograd
gradient at 1e-4 relative to its largest entry in float32 (the two sum
over the plane in different orders, and the closed form and autograd's
chain of plain ops round differently; 1.2e-7 measured on the CPU) and at
the JAX package's 0.05 in bfloat16 (autograd rounds every step of the
plain chain to bfloat16; 0.016 measured on the CPU on gradients of
magnitude 2). The split instance norm (partials, then apply,
of a plane cut into bands of rows: the spatial axis) is held to its plain
version and to the whole-plane kernel at the same 2e-5 / 0.05, and two
launches give the same bits. The int8 pre-pass and the fused int8 conv are held to
their plain versions bitwise (the largest |value| is exact in any order,
integer sums are exact in any order, and every rounding is the plain
version's), and two launches give the same bits.
"""

import math

import pytest
import torch

import chip_smoke

from one_to_many_gan_torch.augment.pipeline import (
    draw_augment,
    geometric_matrix,
    source_coords,
    tent_widths,
)
from one_to_many_gan_torch.ops.cuda import (
    fused_instance_norm,
    instance_norm_plain,
    fused_int8_conv,
    int8_prepass,
    modulated_int8_conv,
    modulated_int8_conv_plain,
    warp,
    warp_bwd,
    warp_bwd_plain,
    warp_bwd_sum_bound,
    warp_plain,
)
from one_to_many_gan_torch.ops.cuda import instance_norm as in_module
from one_to_many_gan_torch.ops.cuda.warp import AA_MAX_WIDTH, RADIUS
from one_to_many_gan_torch.ops.cuda.int8_conv import int8_prepass_plain
from one_to_many_gan_torch.ops.quantize import (
    int8_conv,
    quantize_activations,
    quantize_weight,
)

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 2e-5, torch.bfloat16: 0.05}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.Generator("cuda").manual_seed(0)


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "shape",
    [
        (2, 64, 33, 17),  # H*W no multiple of a 16-byte vector: planes start mid-vector
        (2, 16, 62, 62),  # a D-trunk plane: packed, mid-vector in bf16
        (1, 8, 64, 32),  # packed, several planes a block
        (3, 5, 128, 64),  # one plane a block (f32) / packed (bf16)
        (1, 1, 1, 3),  # fewer elements than a vector
    ],
)
def test_instance_norm_kernel_matches_plain(cuda, shape, dtype, relu):
    x = (torch.randn(shape, generator=cuda, device="cuda") * 2 + 0.5).to(dtype)
    before = fused_instance_norm.launches
    got = fused_instance_norm(x, relu=relu)
    assert fused_instance_norm.launches == before + 1
    want = instance_norm_plain(x, relu=relu)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == x.shape
    assert (got.float() - want.float()).abs().max().item() <= TOL[dtype]
    if relu:
        assert (got >= 0).all()


def _in_boundary_cases():
    """(planes, hw, dtype) at each size where ``plan`` changes variant, planes
    per block or cluster size, and one element to either side."""
    cases = []
    for dtype, esize in ((torch.float32, 4), (torch.bfloat16, 2)):
        edges = [in_module.PACK_BYTES // k for k in (8, 4, 2, 1)]
        edges += [in_module.SMALL_PLANE_BYTES, in_module.RESIDENT_BYTES]
        for edge in edges:
            for hw in (edge // esize - 1, edge // esize, edge // esize + 1):
                cases.append((3, hw, dtype))
        largest = (in_module.MAX_DYNAMIC_SMEM - 16) // esize * in_module.MAX_CLUSTER
        cases += [(1, largest, dtype), (1, largest - 1, dtype)]
        cases += [(5, 1, dtype), (7, 3, dtype), (1, 900, dtype), (2 * 512, 900, dtype)]
    return cases


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize(("planes", "hw", "dtype"), _in_boundary_cases())
def test_instance_norm_every_plan_matches_plain(cuda, planes, hw, dtype, relu):
    """Every layout of the plan (packed at each planes-per-block, resident,
    cluster of 2, 4 and 8) at its edges, hw = 1, hw no multiple of 4, one
    plane, 30^2 planes; also from a pointer one element off 16 bytes."""
    layout = in_module.plan(planes, hw, dtype)
    flat = (torch.randn(planes * hw + 1, generator=cuda, device="cuda") * 2 + 0.5).to(dtype)
    for x in (flat[: planes * hw].view(1, planes, 1, hw), flat[1:].view(1, planes, 1, hw)):
        assert x.is_contiguous()
        got = fused_instance_norm(x, relu=relu)
        want = instance_norm_plain(x, relu=relu)
        torch.cuda.synchronize()
        assert (got.float() - want.float()).abs().max().item() <= TOL[dtype], layout
    assert flat[1:].data_ptr() % 16 != 0


@pytest.mark.parametrize("cluster", [2, 4, 8])
@pytest.mark.parametrize("hw", [30 * 30, 256 * 256 + 3])
def test_instance_norm_every_cluster_size_matches_plain(cuda, cluster, hw):
    """The entry runs clusters of 2, 4 and 8 blocks (the plan takes 8)."""
    x = torch.randn((1, 6, 1, hw), generator=cuda, device="cuda")
    smem = in_module._range_smem(-(-hw // cluster), 4)
    layout = in_module.Plan("cluster", 1, cluster, 256, smem, 6 * cluster)
    got = in_module._launch(x, True, 1e-5, layout)
    want = instance_norm_plain(x, relu=True)
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= TOL[torch.float32]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(32, 512, 30, 30), (2, 64, 256, 256), (1, 4, 512, 256)])
def test_instance_norm_two_launches_are_bitwise_equal(cuda, shape, dtype):
    """Fixed summation order and no atomics, also across a cluster's ranks."""
    x = (torch.randn(shape, generator=cuda, device="cuda") * 3 - 1).to(dtype)
    a = fused_instance_norm(x, relu=True)
    b = fused_instance_norm(x, relu=True)
    assert torch.equal(a, b)


def test_instance_norm_refuses_a_plan_it_cannot_take(cuda):
    """The plan refuses a plane over eight blocks' shared memory; the C
    entry refuses a bad plan (no other path is taken) and launches nothing."""
    before = fused_instance_norm.launches
    too_big = in_module.MAX_CLUSTER * in_module.MAX_DYNAMIC_SMEM // 4 + 1
    x = torch.zeros((1, 1, 1, too_big), device="cuda")
    with pytest.raises(ValueError, match="shared memory"):
        fused_instance_norm(x)
    small = torch.randn((1, 4, 8, 8), generator=cuda, device="cuda")
    bad = in_module.Plan("cluster", 2, 2, 256, 0, 0)  # a cluster takes one plane per block
    with pytest.raises(RuntimeError, match="instance_norm kernel launch failed"):
        in_module._launch(small, False, 1e-5, bad)
    assert fused_instance_norm.launches == before


def test_instance_norm_kernel_raises_instead_of_falling_back(cuda):
    before = fused_instance_norm.launches
    x = torch.randn((1, 4, 8, 8), generator=cuda, device="cuda")
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fused_instance_norm(x.double())
    with pytest.raises(ValueError, match="contiguous"):
        fused_instance_norm(x.transpose(2, 3))
    with pytest.raises(ValueError, match="NCHW"):
        fused_instance_norm(x[0])
    assert fused_instance_norm.launches == before


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_instance_norm_gradient_on_the_card_matches_the_plain_version(cuda, dtype, relu):
    """The kernel's output carries the autograd graph: its gradient equals
    autograd through the plain version, so no instance norm on the card
    stops the gradient."""
    x = (torch.randn((2, 8, 30, 30), generator=cuda, device="cuda") * 2 + 0.5).to(dtype)
    g = torch.randn(x.shape, generator=cuda, device="cuda").to(dtype)
    grads = []
    for fn in (fused_instance_norm, instance_norm_plain):
        xr = x.clone().requires_grad_(True)
        y = fn(xr, relu=relu)
        assert y.requires_grad
        (y.float() * g.float()).sum().backward()
        grads.append(xr.grad.float())
    got, want = grads
    assert got.abs().max().item() > 0
    tol = 1e-4 * want.abs().max().item() if dtype == torch.float32 else TOL[dtype]
    assert (got - want).abs().max().item() <= tol


@pytest.mark.parametrize("layout", ["plan", "resident", "packed2", "packed8", "cluster2",
                                    "cluster4", "cluster8"])
def test_instance_norm_bf16_follows_the_moment_formula_at_high_mean(cuda, layout):
    """In bfloat16 the kernel takes max(E[x^2] - E[x]^2, 0), as its plain
    version and the JAX package's bf16 paths do. ``chip_smoke.high_mean_planes``
    (|mean| / std = 1258, sums exact in float32 in any order) is where the
    centred variance gives outputs 0.125 away: the kernel matches the plain
    version there, in every layout."""
    x = chip_smoke.high_mean_planes(torch, 16, "cuda")
    planes, hw = x.shape[1], x.shape[2] * x.shape[3]
    layouts = {
        "resident": in_module.Plan("resident", 1, 1, 256, in_module._range_smem(hw, 2), planes),
        **{f"packed{k}": in_module.Plan("packed", k, 1, 256, in_module._range_smem(k * hw, 2),
                                        -(-planes // k)) for k in (2, 8)},
        **{f"cluster{k}": in_module.Plan("cluster", 1, k, 256,
                                         in_module._range_smem(-(-hw // k), 2), planes * k)
           for k in (2, 4, 8)},
    }
    got = (fused_instance_norm(x) if layout == "plan"
           else in_module._launch(x, False, 1e-5, layouts[layout]))
    want = instance_norm_plain(x)
    torch.cuda.synchronize()
    assert (got.float() - want.float()).abs().max().item() <= TOL[torch.bfloat16]
    centred = chip_smoke.centred_bf16_plain(torch, x)
    assert (centred.float() - want.float()).abs().max().item() > TOL[torch.bfloat16]


def _warp_inputs(gen, b, h, w, *, minify: float = 1.0):
    """Coordinates and widths of random ADA transforms at p = 0.9, scaled
    by ``minify`` (> 1 widens the tents and maps points off the frame)."""
    draws = draw_augment(gen, b, "cuda")
    g = geometric_matrix(draws.geom, h, w, torch.tensor(0.9, device="cuda"))
    g = g @ torch.diag(torch.tensor([minify, minify, 1.0], device="cuda"))
    sx, sy = source_coords(g, h, w)
    return sx.contiguous(), sy.contiguous(), g


def _bf16_tol_ratio(got: torch.Tensor, want: torch.Tensor, x: torch.Tensor) -> float:
    """Largest |got - want| over (one bfloat16 ulp of the larger magnitude
    + 2^-19 max|x|)."""
    diff = (got.double() - want.double()).abs()
    mag = torch.maximum(got.double().abs(), want.double().abs())
    ulp = torch.exp2(torch.floor(torch.log2(mag.clamp_min(2.0**-126))) - 7)
    return (diff / (ulp + 2.0**-19 * x.abs().max().item())).max().item()


@pytest.mark.parametrize("antialias", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    ("shape", "minify"),
    [((3, 32, 32), 1.0), ((2, 16, 24), 1.0), ((2, 64, 64), 2.7), ((4, 512, 256), 1.0)],
)
def test_warp_kernel_matches_plain(cuda, shape, minify, dtype, antialias):
    b, h, w = shape
    sx, sy, g = _warp_inputs(cuda, b, h, w, minify=minify)
    wx, wy = tent_widths(g, antialias=antialias)
    if minify > 1 and antialias:
        assert wx.min().item() > 2.0  # wide tents
    x = torch.randn(shape, generator=cuda, device="cuda").to(dtype)
    before = warp.launches
    got = warp(x, sx, sy, wx, wy, antialias=antialias)
    assert warp.launches == before + 1
    want = warp_plain(x, sx, sy, wx, wy, antialias=antialias)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == x.shape
    assert torch.isfinite(got).all()
    if dtype == torch.float32:
        assert (got - want).abs().max().item() <= 2e-6
    else:
        assert _bf16_tol_ratio(got, want, x) <= 1.0


def test_warp_kernel_zero_far_outside_and_identity(cuda):
    """A position far outside the frame gives exactly 0 (not NaN) with and
    without antialiasing; the identity transform returns the image."""
    x = torch.randn((2, 16, 16), generator=cuda, device="cuda")
    ys, xs = torch.meshgrid(torch.arange(16.0, device="cuda"),
                            torch.arange(16.0, device="cuda"), indexing="ij")
    sx = xs.expand(2, 16, 16).contiguous()
    sy = ys.expand(2, 16, 16).contiguous()
    ones = torch.ones(2, device="cuda")
    for aa in (False, True):
        torch.testing.assert_close(warp(x, sx, sy, ones, ones, antialias=aa), x,
                                   rtol=0, atol=1e-6)
        far = warp(x, sx + 1e4, sy - 1e4, ones * 4, ones * 4, antialias=aa)
        assert (far == 0).all()


def _below(v: float) -> float:
    return torch.nextafter(torch.tensor(v), torch.tensor(0.0)).item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("width", [1.0, 2.0, 3.0, 4.0, _below(1.0), _below(2.0), _below(3.0),
                                   _below(4.0)])
def test_warp_forward_at_tap_count_edges(cuda, width, dtype):
    """Widths where the tap count changes, and just under them, on both
    axes and on x alone (y at width 1), with positions on integers,
    half-integers and across the frame's edges."""
    b, h, w = 2, 24, 40
    x = torch.randn((b, h, w), generator=cuda, device="cuda").to(dtype)

    def coords(n: int, other: int, along: int) -> torch.Tensor:
        c = torch.rand((b, h, w), generator=cuda, device="cuda") * (n + 2 * width) - width
        edge = torch.arange(other, device="cuda", dtype=torch.float32)
        if along == 2:  # x coordinates: rows 0 and 1 step across the frame
            c[:, 0], c[:, 1] = edge * 0.5 - 2, edge - 1
        else:  # y coordinates: columns 0 and 1
            c[:, :, 0], c[:, :, 1] = edge * 0.5 - 2, edge - 1
        return c.contiguous()

    sx, sy = coords(w, w, 2), coords(h, h, 1)
    wide = torch.full((b,), width, device="cuda")
    for wy in (wide, torch.ones(b, device="cuda")):
        got = warp(x, sx, sy, wide, wy, antialias=True)
        want = warp_plain(x, sx, sy, wide, wy, antialias=True)
        torch.cuda.synchronize()
        assert torch.isfinite(got).all()
        if dtype == torch.float32:
            assert (got - want).abs().max().item() <= 2e-6
        else:
            assert _bf16_tol_ratio(got, want, x) <= 1.0


@pytest.mark.parametrize("antialias", [False, True])
@pytest.mark.parametrize("minify", [1.0, 2.7])
def test_warp_forward_weights_are_the_plain_versions_bitwise(cuda, minify, antialias):
    """On a comb of unit impulses 11 pixels apart each output pixel sees at
    most one nonzero tap, so the kernel's output is RN(wy * wx) exactly as
    the plain version's: its weights (divisions by the width and by the
    normaliser, the normaliser's sum) equal the plain version's bitwise."""
    b, h, w = 4, 64, 96
    x = torch.zeros((b, h, w), device="cuda")
    x[:, ::11, ::11] = 1.0
    sx, sy, g = _warp_inputs(cuda, b, h, w, minify=minify)
    wx, wy = tent_widths(g, antialias=antialias)
    got = warp(x, sx, sy, wx, wy, antialias=antialias)
    want = warp_plain(x, sx, sy, wx, wy, antialias=antialias)
    torch.cuda.synchronize()
    assert (got != 0).sum().item() >= 100
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_warp_forward_beyond_the_extended_range_and_too_wide(cuda, dtype):
    """Positions beyond the extended taps [-RADIUS, n + RADIUS) give exactly
    0; an image whose tent is wider than the dispatch takes comes out NaN,
    and only that image."""
    b, h, w = 3, 16, 16
    x = torch.randn((b, h, w), generator=cuda, device="cuda").to(dtype)
    ys, xs = torch.meshgrid(torch.arange(h, device="cuda", dtype=torch.float32),
                            torch.arange(w, device="cuda", dtype=torch.float32), indexing="ij")
    sy = ys.expand(b, h, w).contiguous()
    width = torch.full((b,), AA_MAX_WIDTH, device="cuda")
    for beyond in (-RADIUS - AA_MAX_WIDTH - 0.5, w + RADIUS + AA_MAX_WIDTH + 0.5, 1e30,
                   -float("inf")):
        sx = torch.full((b, h, w), beyond, device="cuda")
        assert (warp(x, sx, sy, width, width, antialias=True) == 0).all()
    sx = xs.expand(b, h, w).contiguous()
    too_wide = width.clone()
    too_wide[1] = torch.nextafter(torch.tensor(AA_MAX_WIDTH), torch.tensor(5.0)).item()
    out = warp(x, sx, sy, too_wide, width, antialias=True)
    torch.cuda.synchronize()
    assert out[1].isnan().all()
    assert torch.isfinite(out[0]).all() and torch.isfinite(out[2]).all()


def test_warp_raises_instead_of_falling_back(cuda):
    b, h, w = 2, 8, 8
    x = torch.randn((b, h, w), generator=cuda, device="cuda")
    sx = torch.rand((b, h, w), generator=cuda, device="cuda") * w
    sy = torch.rand((b, h, w), generator=cuda, device="cuda") * h
    ones = torch.ones(b, device="cuda")
    before = warp.launches
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        warp(x.double(), sx, sy, ones, ones, antialias=True)
    with pytest.raises(ValueError, match="contiguous"):
        warp(x.transpose(1, 2), sx, sy, ones, ones, antialias=True)
    with pytest.raises(ValueError, match="sx must be float32"):
        warp(x, sx.double(), sy, ones, ones, antialias=True)
    assert warp.launches == before
    assert not math.isnan(warp(x.detach(), sx, sy, ones, ones, antialias=True).sum().item())


@pytest.mark.parametrize("antialias", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    ("shape", "minify"),
    [((3, 32, 32), 1.0), ((2, 16, 24), 1.0), ((2, 64, 64), 2.7), ((2, 64, 64), 0.5),
     ((4, 512, 256), 1.0)],
)
def test_warp_bwd_kernel_matches_plain(cuda, shape, minify, dtype, antialias):
    """The image cotangent at minifying (2.7: wide tents, points off the
    frame) and magnifying (0.5: many terms per pixel) scales."""
    b, h, w = shape
    sx, sy, g = _warp_inputs(cuda, b, h, w, minify=minify)
    wx, wy = tent_widths(g, antialias=antialias)
    dout = torch.randn(shape, generator=cuda, device="cuda").to(dtype)
    before = warp_bwd.launches
    got = warp_bwd(dout, sx, sy, wx, wy, antialias=antialias)
    assert warp_bwd.launches == before + 1
    want = warp_bwd_plain(dout, sx, sy, wx, wy, antialias=antialias)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == dout.shape
    assert torch.isfinite(got).all() and got.abs().max().item() > 0
    diff = (got.double() - want.double()).abs()
    if dtype == torch.float32:
        assert diff.max().item() <= 2e-6
    else:
        mag = torch.maximum(got.double().abs(), want.double().abs()).clamp_min(2.0**-126)
        ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
        bound = warp_bwd_sum_bound(dout, sx, sy, wx, wy, antialias=antialias)
        assert (diff <= ulp + bound).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_warp_autograd_on_the_card(cuda, dtype):
    """``warp`` on images that require a gradient has a ``grad_fn`` on the
    card; its backward makes the cotangent contiguous (the gradient of a
    ``mean`` is an expanded tensor) and launches the backward kernel once,
    with the kernel's result on the contiguous cotangent, nonzero where
    the CPU's gradient is."""
    b, h, w = 4, 64, 64
    sx, sy, g = _warp_inputs(cuda, b, h, w)
    wx, wy = tent_widths(g, antialias=True)
    x = torch.randn((b, h, w), generator=cuda, device="cuda").to(dtype).requires_grad_(True)
    out = warp(x, sx, sy, wx, wy, antialias=True)
    assert out.grad_fn is not None
    before = warp_bwd.launches
    out.float().mean().backward()
    assert warp_bwd.launches == before + 1
    dout = torch.full(x.shape, 1.0 / x.numel(), device="cuda").to(dtype)
    want = warp_bwd(dout, sx, sy, wx, wy, antialias=True)
    cpu = warp_bwd_plain(dout.cpu(), sx.cpu(), sy.cpu(), wx.cpu(), wy.cpu(), antialias=True)
    torch.cuda.synchronize()
    tol = 2e-6 if dtype == torch.float32 else 0.05 / x.numel()
    assert (x.grad.double() - want.double()).abs().max().item() <= tol
    assert torch.equal(x.grad.cpu() != 0, cpu != 0)
    assert (cpu != 0).any()


def test_warp_bwd_runs_in_deterministic_mode_and_repeats_bitwise(cuda):
    """The gather sums each pixel's terms in a fixed order: it runs under
    ``torch.use_deterministic_algorithms(True)``, and every launch gives the
    same bits as any other."""
    b, h, w = 4, 64, 64
    sx, sy, g = _warp_inputs(cuda, b, h, w)
    wx, wy = tent_widths(g, antialias=True)
    dout = torch.randn((b, h, w), generator=cuda, device="cuda").to(torch.bfloat16)
    first = warp_bwd(dout, sx, sy, wx, wy, antialias=True)
    before = warp_bwd.launches
    try:
        torch.use_deterministic_algorithms(True)
        repeats = [warp_bwd(dout, sx, sy, wx, wy, antialias=True) for _ in range(3)]
    finally:
        torch.use_deterministic_algorithms(False)
    assert warp_bwd.launches == before + 3
    assert all(torch.equal(first, r) for r in repeats)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["rot90_flip", "magnify_4x", "width_cap"])
def test_warp_bwd_gather_on_hard_transforms(cuda, case, dtype):
    """``chip_smoke.gather_transforms``: rotations by multiples of 90
    degrees and flips, 4x magnification (regions staged in chunks) and
    4x minification with the widths at the cap (9 taps a side). Held as
    ``chip_smoke._check_bwd`` holds them (float32: 2e-6 plus
    ``warp_bwd_sum_bound``, since a magnified pixel sums tens of terms)."""
    b, h, w = 8, 96, 80
    name = "minify_4x" if case == "width_cap" else case
    g = chip_smoke.gather_transforms(torch, cuda, b, h, w)[name]
    sx, sy = source_coords(g, h, w)
    wx, wy = tent_widths(g, antialias=True)
    if case == "width_cap":
        wx = wy = torch.full((b,), AA_MAX_WIDTH, device="cuda")
    coords = (sx.contiguous(), sy.contiguous(), wx, wy)
    dout = torch.randn((b, h, w), generator=cuda, device="cuda").to(dtype)
    got = warp_bwd(dout, *coords, antialias=True)
    again = warp_bwd(dout, *coords, antialias=True)
    want = warp_bwd_plain(dout, *coords, antialias=True)
    torch.cuda.synchronize()
    assert got.abs().max().item() > 0 and torch.equal(got, again)
    chip_smoke._check_bwd(torch, got, want, dout, coords, True, case)


@pytest.mark.parametrize("antialias", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_warp_bwd_gather_exact_on_random_coordinates(cuda, dtype, antialias):
    """Coordinates that are no affine map of the pixel grid (uniform random
    at 8x8, over and past the frame): the measured deviation widens every
    box toward the whole frame, and the result stays exact."""
    b, h, w = 4, 8, 8
    sx = torch.rand((b, h, w), generator=cuda, device="cuda") * (w + 4) - 2
    sy = torch.rand((b, h, w), generator=cuda, device="cuda") * (h + 4) - 2
    wx = 1.0 + 3.0 * torch.rand((b,), generator=cuda, device="cuda")
    wy = 1.0 + 3.0 * torch.rand((b,), generator=cuda, device="cuda")
    dout = torch.randn((b, h, w), generator=cuda, device="cuda").to(dtype)
    got = warp_bwd(dout, sx, sy, wx, wy, antialias=antialias)
    want = warp_bwd_plain(dout, sx, sy, wx, wy, antialias=antialias)
    torch.cuda.synchronize()
    assert got.abs().max().item() > 0
    chip_smoke._check_bwd(torch, got, want, dout, (sx, sy, wx, wy), antialias, "random")


def test_warp_bwd_nan_contract(cuda):
    """With antialias, an image with a NaN coordinate, or a tent wider than
    the dispatch takes, gets a NaN cotangent over the whole image (the
    scatter this gather replaced put the NaN on pixel 0 only); the other
    images' cotangents are unchanged. Without antialias a NaN position
    weighs nothing (its tents are 0), as in the forward."""
    b, h, w = 4, 32, 32
    sx, sy, g = _warp_inputs(cuda, b, h, w)
    wx, wy = tent_widths(g, antialias=True)
    dout = torch.randn((b, h, w), generator=cuda, device="cuda")
    clean = warp_bwd(dout, sx, sy, wx, wy, antialias=True)
    nan_sx = sx.clone()
    nan_sx[1, 3, 4] = float("nan")
    wide = wx.clone()
    wide[2] = torch.nextafter(torch.tensor(AA_MAX_WIDTH), torch.tensor(5.0)).item()
    out = warp_bwd(dout, nan_sx, sy, wide, wy, antialias=True)
    torch.cuda.synchronize()
    assert out[1].isnan().all() and out[2].isnan().all()
    assert torch.equal(out[0], clean[0]) and torch.equal(out[3], clean[3])
    ones = torch.ones(b, device="cuda")
    plain = warp_bwd(dout, sx, sy, ones, ones, antialias=False)
    off = warp_bwd(dout, nan_sx, sy, ones, ones, antialias=False)
    d_nan = dout.clone()
    d_nan[1, 3, 4] = 0.0  # the NaN position's terms are 0
    assert torch.isfinite(off).all()
    assert torch.equal(off[1], warp_bwd(d_nan, sx, sy, ones, ones, antialias=False)[1])
    assert torch.equal(off[0], plain[0])


def test_warp_bwd_raises_instead_of_falling_back(cuda):
    b, h, w = 2, 8, 8
    dout = torch.randn((b, h, w), generator=cuda, device="cuda")
    sx = torch.rand((b, h, w), generator=cuda, device="cuda") * w
    sy = torch.rand((b, h, w), generator=cuda, device="cuda") * h
    ones = torch.ones(b, device="cuda")
    before = warp_bwd.launches
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        warp_bwd(dout.half(), sx, sy, ones, ones, antialias=True)
    with pytest.raises(ValueError, match="contiguous"):
        warp_bwd(dout.transpose(1, 2), sx, sy, ones, ones, antialias=True)
    with pytest.raises(ValueError, match=r"expected non-empty \[B,H,W\]"):
        warp_bwd(dout[None], sx, sy, ones, ones, antialias=True)
    with pytest.raises(ValueError, match="sy must be float32"):
        warp_bwd(dout, sx, sy.cpu(), ones, ones, antialias=True)
    with pytest.raises(ValueError, match="width_x must be float32"):
        warp_bwd(dout, sx, sy, ones[:1], ones, antialias=True)
    assert warp_bwd.launches == before


# ------------------------------------------------------------ the int8 conv


def _int8_site(gen, b, c, h, w, o, dtype=torch.float32):
    """(x, s, w_q, w_scale, d) of one int8 site on the card."""
    x = (torch.randn((b, c, h, w), generator=gen, device="cuda") * 3).to(dtype)
    s = torch.randn((b, c), generator=gen, device="cuda")
    d = torch.rand((b, o), generator=gen, device="cuda") + 0.5
    w_q, w_scale = quantize_weight(torch.randn((o, c, 3, 3), generator=gen, device="cuda") * 0.05)
    return x, s, w_q, w_scale, d


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pad_mode", ["zero", "reflect"])
@pytest.mark.parametrize(
    ("b", "c", "h", "w", "o"),
    [
        (1, 32, 3, 5, 8),  # C = 32, one block, most of it out of range; odd H and W
        (2, 64, 17, 21, 70),  # rows, columns and O off the tiles (O > 64: 128-wide N)
        (3, 32, 9, 38, 129),  # O one past a tile
        (1, 128, 32, 16, 64),  # the 64-wide N tile
        (2, 256, 8, 64, 256),  # the decoder's resnet width
        (2, 32, 9, 131, 40),  # three column strips, the last of 3 columns
        (2, 64, 12, 128, 300),  # two N tiles
    ],
)
def test_int8_conv_kernel_is_the_plain_version_bitwise(cuda, b, c, h, w, o, pad_mode, dtype):
    """Both kernels of an int8 site against their plain versions: the
    largest |value| and integer sums are exact in any order and every
    rounding is the plain version's. Also the unmodulated, unpadded float32
    case that ops/quantize.int8_conv takes."""
    x, s, w_q, w_scale, d = _int8_site(cuda, b, c, h, w, o, dtype)
    kw = {"padding": 1, "pad_mode": pad_mode, "dtype": dtype}
    before = (int8_prepass.launches, fused_int8_conv.launches)
    got = modulated_int8_conv(x, s, w_q, w_scale, d, **kw)
    again = modulated_int8_conv(x, s, w_q, w_scale, d, **kw)
    want = modulated_int8_conv_plain(x, s, w_q, w_scale, d, **kw)
    torch.cuda.synchronize()
    assert (int8_prepass.launches, fused_int8_conv.launches) == (before[0] + 2, before[1] + 2)
    assert got.shape == want.shape == (b, o, h, w) and got.dtype == dtype
    assert torch.equal(got, want) and torch.equal(got, again)
    flat = {"padding": 0, "pad_mode": "zero", "dtype": torch.float32}
    assert torch.equal(modulated_int8_conv(x, None, w_q, w_scale, None, **flat),
                       modulated_int8_conv_plain(x, None, w_q, w_scale, None, **flat))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1, 32, 3, 5), (64, 256, 16, 8), (3, 64, 7, 9)])
def test_int8_prepass_kernel_is_the_plain_version_bitwise(cuda, shape, dtype):
    x = (torch.randn(shape, generator=cuda, device="cuda") * 5).to(dtype)
    s = torch.randn(shape[:2], generator=cuda, device="cuda")
    x[-1] = 0  # an all-zero sample: the scale floors at 1e-12 / 127
    for act in (torch.float32, torch.bfloat16):
        for style in (s, None):
            got = int8_prepass(x, style, act)
            assert torch.equal(got, int8_prepass_plain(x, style, act))
            assert torch.equal(got, int8_prepass(x, style, act))


def test_int8_conv_on_the_card_is_the_cpu_plain_version(cuda):
    """The site on the card against the CPU's plain version on the same
    inputs, scales and codes first: the scales are divisions on both (a
    division by a Python number on the card multiplies by a rounded
    reciprocal, one ulp off for some of these 64 samples and 128
    channels)."""
    x, s, w_q, w_scale, d = _int8_site(cuda, 64, 32, 12, 10, 128)
    x = x * torch.rand((64, 1, 1, 1), generator=cuda, device="cuda") * 10
    w = torch.randn((128, 32, 3, 3), generator=cuda, device="cuda") * 0.1
    for fn, t in ((quantize_activations, x), (quantize_weight, w)):
        for got, want in zip(fn(t), fn(t.cpu()), strict=True):
            assert torch.equal(got.cpu(), want)
    assert torch.equal(int8_conv(x, w).cpu(), int8_conv(x.cpu(), w.cpu()))
    for pad_mode in ("zero", "reflect"):
        kw = {"padding": 1, "pad_mode": pad_mode, "dtype": torch.float32}
        got = modulated_int8_conv(x, s, w_q, w_scale, d, **kw).cpu()
        cpu = [t.cpu() for t in (x, s, w_q, w_scale, d)]
        assert torch.equal(got, modulated_int8_conv(*cpu, **kw))


def test_int8_conv_raises_instead_of_falling_back(cuda):
    x, s, w_q, w_scale, d = _int8_site(cuda, 2, 64, 8, 8, 16)
    xs = int8_prepass(x, s, torch.float32)
    kw = {"padding": 1, "pad_mode": "zero", "dtype": torch.float32}
    before = fused_int8_conv.launches
    x48, s48, w48, ws48, d48 = _int8_site(cuda, 2, 48, 8, 8, 16)
    with pytest.raises(ValueError, match="multiples of 32"):
        fused_int8_conv(x48, s48, int8_prepass(x48, s48, torch.float32), w48, ws48, d48, **kw)
    with pytest.raises(ValueError, match="contiguous"):
        fused_int8_conv(x.transpose(2, 3), s, xs, w_q, w_scale, d, **kw)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fused_int8_conv(x.half(), s, xs, w_q, w_scale, d, **kw)
    with pytest.raises(ValueError, match="weight codes must be int8"):
        fused_int8_conv(x, s, xs, w_q.float(), w_scale, d, **kw)
    with pytest.raises(ValueError, match="tensors on"):
        fused_int8_conv(x, s, xs.cpu(), w_q, w_scale, d, **kw)
    with pytest.raises(ValueError, match="padding 2"):
        fused_int8_conv(x, s, xs, w_q, w_scale, d, padding=2, pad_mode="zero",
                        dtype=torch.float32)
    with pytest.raises(ValueError, match="weight codes"):
        fused_int8_conv(x, s, xs, w_q[:, :, :1, :1].contiguous(), w_scale, d, **kw)
    misaligned = torch.empty(x.numel() + 1, dtype=torch.float32, device="cuda")[1:]
    with pytest.raises(ValueError, match="16-byte boundary"):
        fused_int8_conv(misaligned.view(x.shape), s, xs, w_q, w_scale, d, **kw)
    assert fused_int8_conv.launches == before


# ------------------------------------------------------ split instance norm


def _split(x, spatial, relu, kernel=True):
    """Bands of ``x``'s rows: every band's partials stacked in band order (the
    all-gather's result), then every band's apply."""
    from one_to_many_gan_torch.parallel import halo

    part = in_module.instance_norm_partials if kernel else in_module.partials_plain
    apply = in_module.instance_norm_apply if kernel else in_module.apply_plain
    bands = [x[:, :, lo:hi].contiguous()
             for lo, hi in (halo.band(x.shape[2], spatial, t) for t in range(spatial))]
    gathered = torch.stack([part(b) for b in bands])
    return torch.cat([apply(b, gathered, relu=relu) for b in bands], 2), gathered


@pytest.mark.parametrize("spatial", [2, 4, 8])
@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "shape",
    # the trunk's ragged planes (packed), a 254-row one (resident), a 512^2
    # encode plane (cluster), and planes with fewer rows than bands
    [(16, 512, 62, 62), (8, 128, 254, 254), (2, 64, 512, 512), (3, 5, 3, 7)],
)
def test_split_instance_norm_matches_plain_and_whole_plane(cuda, shape, dtype, relu, spatial):
    x = (torch.randn(shape, generator=cuda, device="cuda") * 2 + 0.5).to(dtype)
    got, gathered = _split(x, spatial, relu)
    plain, plain_gathered = _split(x, spatial, relu, kernel=False)
    whole = fused_instance_norm(x, relu=relu)
    again, _ = _split(x, spatial, relu)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert torch.equal(gathered[:, -1], plain_gathered[:, -1])  # the band counts
    tol = TOL[dtype]
    assert (got.float() - plain.float()).abs().max().item() <= tol
    assert (got.float() - whole.float()).abs().max().item() <= tol


def test_split_instance_norm_empty_band_launches_nothing(cuda):
    x = torch.randn((2, 3, 0, 5), device="cuda")
    p0, a0 = in_module.instance_norm_partials.launches, in_module.instance_norm_apply.launches
    part = in_module.instance_norm_partials(x)
    assert part.shape == (7, 2) and torch.equal(part, torch.zeros_like(part))
    assert in_module.instance_norm_apply(x, part[None]).shape == x.shape
    assert (in_module.instance_norm_partials.launches, in_module.instance_norm_apply.launches) \
        == (p0, a0)


def test_split_instance_norm_raises_instead_of_falling_back(cuda):
    x = torch.randn((2, 3, 4, 5), device="cuda")
    with pytest.raises(ValueError, match="expected .S, 7, 2. float32"):
        in_module.instance_norm_apply(x, torch.zeros((2, 6, 2), device="cuda"))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        in_module.instance_norm_partials(x.half())
