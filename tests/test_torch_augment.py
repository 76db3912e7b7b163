"""The port's ADA pipeline, warp and controller against the JAX package, on
the CPU.

The draws are the JAX code's own: ``jax_augment_draws`` rebuilds the key
layout of ``augment`` (``split(rng)`` into geometry and colour, then
``split(k_geom, 16)`` and ``split(k_color, 10)``; the JAX package's
``augment/pipeline.py:139,189,622``) and hands the same uniform, normal
and integer draws to both packages.

Tolerances:

- matrices 1e-6: the same f32 ops on both sides; cos, sin and exp2 may
  differ in the last ulp between the libraries.
- the warp's plain version 2e-6 in f32 (the JAX package's warp
  tolerance, tests/test_pallas_kernels.py), on coordinates computed once
  and fed to both sides; in bf16 one bf16 ulp of the output plus 2^-19 of
  the largest |image| value against the Pallas kernel in bf16. Both form
  the same exact products (bf16 weight times bf16 pixel); the plain
  version sums them in float64 and rounds once, the Pallas kernel sums in
  float32, which errs by at most (nx + ny) * 2^-24 * max|x| * 1.03 for
  nx, ny <= 12 taps per axis whose weights sum to at most 1.03 (bf16
  rounding): 25 * 2^-24 < 2^-19. That term is more than a bf16 ulp where
  the taps cancel to an output near 0.
- ``augment`` end to end 1e-4 in f32: each side computes its own source
  coordinates (an einsum over the 3x3 matrix), whose last-ulp differences
  (7.6e-6 for coordinates in [64, 128)) move a tent weight by as much,
  and then the sample by up to that times the image's step between
  neighbouring pixels (up to 2 here) times the colour gain (up to ~3).
  bf16 end to end: the JAX package's 0.05.
- the controller: exact (the same f32 adds and one division).

The warp references are jitted at XLA's backend optimisation level 0
(``FAST_COMPILE``): the same functions, compiled in about half the time
on the CPU.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from one_to_many_gan_torch.augment import controller as port_ctl
from one_to_many_gan_torch.augment import pipeline as port_aug
from one_to_many_gan_torch.ops.cuda.warp import warp as port_warp_fn
from one_to_many_gan_torch.ops.cuda.warp import warp_plain
from one_to_many_gan_tpu.augment import controller as jax_ctl
from one_to_many_gan_tpu.augment import pipeline as jax_aug
from one_to_many_gan_tpu.ops.pallas.warp import warp_pallas

ALL = frozenset(jax_aug.ALL_CATEGORIES)
FAST_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


def fast_jit(fn, **kwargs):
    return jax.jit(fn, compiler_options=FAST_COMPILE, **kwargs)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def jax_augment_draws(key, b: int) -> port_aug.AugmentDraws:
    """The draws of JAX ``augment(images, p, key)`` on a batch of ``b``, as
    the port's ``AugmentDraws``."""
    k_geom, k_color = jax.random.split(key)
    kg = jax.random.split(k_geom, 16)
    kc = jax.random.split(k_color, 10)

    def u(k, shape=(b,)):
        return _t(jax.random.uniform(k, shape))

    def n(k, shape=(b,)):
        return _t(jax.random.normal(k, shape))

    def i(k, high):
        return _t(jax.random.randint(k, (b,), 0, high))

    geom = port_aug.GeometricDraws(
        i(kg[0], 2), u(kg[1]), i(kg[2], 4), u(kg[3]), u(kg[4], (b, 2)), u(kg[5]),
        n(kg[6]), u(kg[7]), u(kg[8]), u(kg[9]), n(kg[10]), u(kg[11]), u(kg[12]),
        u(kg[13]), n(kg[14], (b, 2)), u(kg[15]),
    )
    color = port_aug.ColorDraws(
        n(kc[0]), u(kc[1]), n(kc[2]), u(kc[3]), i(kc[4], 2), u(kc[5]), u(kc[6]),
        u(kc[7]), n(kc[8]), u(kc[9]),
    )
    return port_aug.AugmentDraws(geom, color)


# ----------------------------------------------------------------- matrices


@pytest.mark.parametrize("p", [0.0, 0.6, 0.9, 1.0])
@pytest.mark.parametrize(("b", "h", "w"), [(5, 64, 64), (3, 512, 256)])
def test_geometric_matrix_matches_jax(b, h, w, p):
    key = jax.random.key(int(p * 10) + h)
    k_geom, _ = jax.random.split(key)
    want = jax_aug.geometric_matrix(k_geom, b, h, w, jnp.float32(p), ALL)
    draws = jax_augment_draws(key, b)
    got = port_aug.geometric_matrix(draws.geom, h, w, torch.tensor(p))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("p", [0.0, 0.6, 0.9])
def test_color_matrix_matches_jax(p, channels):
    key = jax.random.key(int(p * 10) + channels)
    _, k_color = jax.random.split(key)
    want = jax_aug.color_matrix(k_color, 6, channels, jnp.float32(p), ALL)
    draws = jax_augment_draws(key, 6)
    got = port_aug.color_matrix(draws.color, channels, torch.tensor(p))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("channels", [1, 3])
def test_apply_color_matches_jax(channels):
    rng = np.random.default_rng(3)
    x = rng.uniform(-1, 1, (4, 8, 8, channels)).astype(np.float32)
    cmat = np.asarray(jax_aug.color_matrix(jax.random.key(4), 4, channels, 0.9, ALL))
    want = jax_aug.apply_color(jnp.asarray(x), jnp.asarray(cmat))
    got = port_aug.apply_color(_t(x), _t(cmat))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_draw_augment_shapes_and_ranges():
    gen = torch.Generator().manual_seed(0)
    draws = port_aug.draw_augment(gen, 7, "cpu")
    again = port_aug.draw_augment(torch.Generator().manual_seed(0), 7, "cpu")
    for field, t, t2 in zip(draws.geom._fields + draws.color._fields,
                            (*draws.geom, *draws.color), (*again.geom, *again.color)):
        torch.testing.assert_close(t, t2, rtol=0, atol=0)
        assert t.shape[0] == 7, field
        if field.startswith("u_"):
            assert t.dtype == torch.float32 and (t >= 0).all() and (t < 1).all(), field
    assert set(draws.geom.i_rot90.tolist()) <= {0, 1, 2, 3}
    assert draws.geom.u_xint.shape == draws.geom.n_xfrac.shape == (7, 2)


# --------------------------------------------------------------------- warp


def _coords(g_inv, h, w):
    """The JAX package's source coordinates and antialias widths
    (``_warp_impl``), computed once in JAX and shared by both sides."""
    ys = jnp.arange(h, dtype=jnp.float32) - (h - 1) / 2.0
    xs = jnp.arange(w, dtype=jnp.float32) - (w - 1) / 2.0
    gy, gx = jnp.meshgrid(ys, xs, indexing="ij")
    grid = jnp.stack([gx, gy, jnp.ones_like(gx)], axis=-1)
    src = jnp.einsum("bij,hwj->bhwi", g_inv, grid)
    jac = g_inv[:, :2, :2]
    wx = jnp.clip(jnp.sqrt(jac[:, 0, 0] ** 2 + jac[:, 0, 1] ** 2), 1.0, 4.0)
    wy = jnp.clip(jnp.sqrt(jac[:, 1, 0] ** 2 + jac[:, 1, 1] ** 2), 1.0, 4.0)
    return src[..., 0] + (w - 1) / 2.0, src[..., 1] + (h - 1) / 2.0, wx, wy


CASES = [((3, 32, 32), 1.0), ((2, 16, 24), 1.0), ((2, 64, 64), 2.7)]


def _warp_case(shape, minify, antialias, seed=5):
    """Images, shared coordinates and widths of random ADA transforms at
    p = 0.9, scaled by ``minify`` (2.7: tents about 2.7 wide, and points
    mapped off the frame)."""
    b, h, w = shape
    g = jax_aug.geometric_matrix(jax.random.key(seed), b, h, w, jnp.float32(0.9), ALL)
    g = g @ jnp.diag(jnp.asarray([minify, minify, 1.0], jnp.float32))
    sx, sy, wx, wy = _coords(g, h, w)
    if not antialias:
        wx = wy = jnp.ones((b,), jnp.float32)
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return x, sx, sy, wx, wy


@pytest.mark.parametrize("antialias", [False, True])
@pytest.mark.parametrize(("shape", "minify"), CASES)
def test_warp_plain_matches_tent_contract_and_pallas_f32(shape, minify, antialias):
    x, sx, sy, wx, wy = _warp_case(shape, minify, antialias)
    if minify > 1:
        assert float(jnp.min(sx)) < -8 and float(jnp.max(sx)) > shape[2] + 8  # off the frame
        if antialias:
            assert float(jnp.min(wx)) > 2.0
    got = warp_plain(*(_t(a) for a in (x, sx, sy, wx, wy)), antialias=antialias)
    want_xla = fast_jit(functools.partial(jax_aug._tent_contract, antialias=antialias))(
        jnp.asarray(x)[..., None], sx, sy, wx, wy
    )[..., 0]
    want_pallas = fast_jit(warp_pallas, static_argnums=5)(
        jnp.asarray(x), sx, sy, wx, wy, antialias)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want_xla), rtol=0, atol=2e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_pallas), rtol=0, atol=2e-6)
    # the wrapper takes the plain version for CPU tensors, without a build
    before = port_warp_fn.launches
    torch.testing.assert_close(
        port_warp_fn(*(_t(a) for a in (x, sx, sy, wx, wy)), antialias=antialias), got,
        rtol=0, atol=0,
    )
    assert port_warp_fn.launches == before


@pytest.mark.parametrize("antialias", [False, True])
@pytest.mark.parametrize(("shape", "minify"), CASES)
def test_warp_plain_matches_pallas_bf16(shape, minify, antialias):
    x, sx, sy, wx, wy = _warp_case(shape, minify, antialias, seed=6)
    xb = jnp.asarray(x, jnp.bfloat16)
    want = np.asarray(
        fast_jit(warp_pallas, static_argnums=5)(xb, sx, sy, wx, wy, antialias), np.float64)
    got = warp_plain(
        _t(np.asarray(xb, np.float32)).bfloat16(), *(_t(a) for a in (sx, sy, wx, wy)),
        antialias=antialias,
    )
    assert got.dtype == torch.bfloat16
    got = got.double().numpy()
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.maximum(abs(got), abs(want)), 2.0**-126))) - 7)
    assert (np.abs(got - want) <= ulp + 2.0**-19 * np.abs(x).max()).all()




# ------------------------------------------------------------------ augment


@pytest.mark.parametrize("antialias", [False, True])
@pytest.mark.parametrize("p", [0.6, 0.9])
def test_augment_matches_jax_f32(p, antialias):
    x = np.random.default_rng(7).uniform(-1, 1, (4, 64, 64, 1)).astype(np.float32)
    key = jax.random.key(8)
    want = jax_aug.augment(jnp.asarray(x), p, key, antialias=antialias, pallas=True)
    got = port_aug.augment(_t(x), p, jax_augment_draws(key, 4), antialias=antialias)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)


def test_augment_matches_jax_bf16():
    x = np.random.default_rng(9).uniform(-1, 1, (4, 64, 64, 1)).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    key = jax.random.key(10)
    want = jax_aug.augment(xb, 0.9, key, antialias=True, pallas=True)
    got = port_aug.augment(_t(np.asarray(xb, np.float32)).bfloat16(), 0.9,
                           jax_augment_draws(key, 4))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=0.05)


@pytest.mark.parametrize("antialias", [False, True])
def test_augment_gradient_matches_jax_f32(antialias):
    """``augment`` is differentiable in the images: the gradient of
    ``sum(sin(augment(x)))`` against ``jax.grad`` of the JAX package's
    (Pallas warp, interpret mode), at the end-to-end tolerance 1e-4."""
    x = np.random.default_rng(22).uniform(-1, 1, (4, 64, 64, 1)).astype(np.float32)
    key = jax.random.key(23)
    want = fast_jit(jax.grad(lambda z: jnp.sum(jnp.sin(
        jax_aug.augment(z, 0.9, key, antialias=antialias, pallas=True)))))(jnp.asarray(x))
    xt = _t(x).requires_grad_(True)
    torch.sin(port_aug.augment(xt, 0.9, jax_augment_draws(key, 4), antialias=antialias)).sum(
        ).backward()
    assert xt.grad.abs().max().item() > 0
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want), rtol=0, atol=1e-4)


def test_augment_gives_the_transform_no_gradient():
    """Gradients reach the images only: the geometric matrix (and so the
    coordinates and widths derived from it) gets none, as the JAX
    package stops them."""
    x = torch.from_numpy(np.random.default_rng(24).uniform(-1, 1, (2, 16, 16, 1))
                         .astype(np.float32)).requires_grad_(True)
    draws = port_aug.draw_augment(torch.Generator().manual_seed(2), 2, "cpu")
    g_inv = port_aug.geometric_matrix(draws.geom, 16, 16, torch.tensor(0.9)).requires_grad_(True)
    port_aug.warp_images(x, g_inv, antialias=True).sum().backward()
    assert g_inv.grad is None
    assert x.grad is not None and x.grad.abs().max().item() > 0


def test_augment_at_p_zero_is_the_identity():
    """At p = 0 every transform is the identity: integer source positions,
    tents of width 1, unit colour gain."""
    x = torch.from_numpy(np.random.default_rng(11).uniform(-1, 1, (3, 16, 24, 1)).astype(np.float32))
    draws = port_aug.draw_augment(torch.Generator().manual_seed(1), 3, "cpu")
    torch.testing.assert_close(port_aug.augment(x, 0.0, draws), x, rtol=0, atol=1e-6)


def test_warp_images_hands_the_kernel_contiguous_images(monkeypatch):
    """The CUDA kernels refuse strided images; the G phase augments every
    third image of one decode, a strided view."""
    seen = []

    def spy(images, *args, **kwargs):
        seen.append(images.is_contiguous())
        return port_warp_fn(images, *args, **kwargs)

    monkeypatch.setattr(port_aug, "warp", spy)
    x = torch.zeros((6, 1, 16, 16))[::3].permute(0, 2, 3, 1)  # every third image, NHWC
    assert not x[..., 0].is_contiguous()
    port_aug.warp_images(x, torch.eye(3).expand(2, 3, 3), antialias=True)
    assert seen == [True]


def test_warp_images_takes_single_channel_images_only():
    with pytest.raises(ValueError, match="single-channel"):
        port_aug.warp_images(torch.zeros((1, 8, 8, 3)), torch.eye(3)[None], antialias=True)


# --------------------------------------------------------------- controller


def test_controller_matches_jax_over_two_window_boundaries():
    """ada_e 64 at batch 16: a window closes on every 4th score after the
    first (4 + the boundary score, which also opens the next window). 13
    scores close three windows: p moves up, then down, then is clamped
    at 0."""
    args = (64, 5.12e-4, 16, 0.6)
    jax_update = jax.jit(jax_ctl.make_ada_update(*args))
    port_update = port_ctl.make_ada_update(*args)
    scores = [0.9, 1.0, 0.8, 0.7, 0.95, -0.2, 0.1, -1.0, 0.0, 0.3, -0.5, 0.25, 0.6]
    js = jax_ctl.AdaState(jnp.float32(0.03), jnp.int32(0), jnp.float32(0.0))
    ps = port_ctl.init_ada_state(p=0.03)
    closes = 0
    for s in scores:
        js = jax_update(js, jnp.float32(s))
        before = ps.p.item()
        ps = port_update(ps, torch.tensor(s))
        closes += ps.p.item() != before
        assert ps.p.item() == float(js.p)
        assert ps.count.item() == int(js.count) and ps.count.dtype == torch.int32
        assert ps.accum.item() == float(js.accum)
    assert closes == 3 and ps.p.item() == 0.0
