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
backward in float32 is held to the same 2e-6, and in bfloat16 to one
bfloat16 ulp plus ``warp_bwd_sum_bound``, a proven bound on the error of
the kernel's float32 atomic sums in any order. The instance
norm's gradient on the card is held to the plain version's autograd
gradient at 1e-4 relative to its largest entry in float32 (the two sum
over the plane in different orders, and the closed form and autograd's
chain of plain ops round differently; 1.2e-7 measured on the CPU) and at
the JAX package's 0.05 in bfloat16 (autograd rounds every step of the
plain chain to bfloat16; 0.016 measured on the CPU on gradients of
magnitude 2).
"""

import pytest
import torch

import math

from one_to_many_gan_torch.augment.pipeline import (
    draw_augment,
    geometric_matrix,
    source_coords,
    tent_widths,
)
from one_to_many_gan_torch.ops.cuda import (
    fused_instance_norm,
    instance_norm_plain,
    warp,
    warp_bwd,
    warp_bwd_plain,
    warp_bwd_sum_bound,
    warp_plain,
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
        (2, 64, 33, 17),  # H*W not a multiple of the vector width: scalar path
        (2, 16, 62, 62),  # a D-trunk plane: scalar path in bf16, vector in f32
        (1, 8, 64, 32),  # vector path
        (3, 5, 128, 64),  # vector path, several unrolled steps per thread
        (1, 1, 1, 3),  # fewer elements than threads
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


def test_warp_bwd_refuses_deterministic_mode(cuda):
    dout = torch.randn((1, 8, 8), generator=cuda, device="cuda")
    c = torch.rand((1, 8, 8), generator=cuda, device="cuda") * 8
    ones = torch.ones(1, device="cuda")
    before = warp_bwd.launches
    try:
        torch.use_deterministic_algorithms(True)
        with pytest.raises(RuntimeError, match="no deterministic implementation"):
            warp_bwd(dout, c, c, ones, ones, antialias=True)
    finally:
        torch.use_deterministic_algorithms(False)
    assert warp_bwd.launches == before


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
