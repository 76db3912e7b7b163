"""The port's 2x supersampled ADA warp (``tpu.ada_supersample``) against the
JAX package's ``_warp_supersampled``, on the CPU, at 64x64.

- The sym6 operators and their phases: exactly ``_ss_updown_ops``'s, and
  cast to float32 and bfloat16 exactly as ``jnp.asarray`` casts them.
- ``warp_supersampled`` on one ``g_inv`` shared by both sides, float32:
  1e-6. Both sides form the same products in the same order of
  contraction; JAX's width-1 tent contraction and the port's warp sum
  the same four taps, in float32 and float64 respectively (measured
  2.4e-7).
- bfloat16: 2^-6, two bf16 ulps of values in [1, 2). Both sides round to
  bf16 after each of the five stages (two up products, the warp, two down
  products), but at different points inside them: JAX's warp rounds its
  inner tent sum to bf16 (XLA's contraction, not the Pallas kernel's),
  the port's kernel rounds once. One such rounding reaches the output
  through the down operators with a gain of at most 1.38^2 (their rows'
  L1 norms): measured one ulp (2^-7) on 6 seeds.
- ``augment(..., supersample=True)`` end to end, on the JAX draws: 1e-4
  in float32, as ``tests/test_torch_augment.py``'s augment: each side
  builds its own geometric matrix, whose cos, sin and exp2 differ in the
  last ulp, and that moves the source coordinates (measured 1.3e-5);
  2^-5 in bfloat16, the warp's 2^-6 times the colour gain (up to ~2).
- The image gradient of ``sum(sin(warp_supersampled(x)))`` against
  ``jax.grad``, float32: 1e-5 (measured 7.2e-7 of |grad| <= 2.6).
- Without antialiasing ``warp_plain`` gathers each pixel's taps; that
  equals the dense tent contraction bit for bit.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from one_to_many_gan_torch.augment import pipeline as port_aug
from one_to_many_gan_tpu.augment import pipeline as jax_aug
from tests.test_torch_augment import ALL, jax_augment_draws

warp_module = importlib.import_module("one_to_many_gan_torch.ops.cuda.warp")
SIZE = 64


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _images(b: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).uniform(-1, 1, (b, SIZE, SIZE, 1)).astype(np.float32)


def _g_inv(b: int, seed: int, p: float = 0.9):
    return jax_aug.geometric_matrix(jax.random.key(seed), b, SIZE, SIZE, jnp.float32(p), ALL)


@pytest.mark.parametrize("n", [16, 64, 96])
def test_operators_and_phases_equal_jax(n):
    u, d, a_up, a_dn = port_aug.ss_updown_ops(n)
    ju, jd, ja_up, ja_dn = jax_aug._ss_updown_ops(n)
    assert u.shape == (2 * n, n) and d.shape == (n, 2 * n)
    np.testing.assert_array_equal(u, ju)
    np.testing.assert_array_equal(d, jd)
    assert (a_up, a_dn) == (ja_up, ja_dn)
    for dtype, jdtype in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        tu, td = port_aug._ss_tensors(n, dtype, "cpu")
        np.testing.assert_array_equal(tu.float().numpy(), np.asarray(jnp.asarray(ju, jdtype),
                                                                     np.float32))
        np.testing.assert_array_equal(td.float().numpy(), np.asarray(jnp.asarray(jd, jdtype),
                                                                     np.float32))


@pytest.mark.parametrize(("dtype", "tol"), [("float32", 1e-6), ("bfloat16", 2.0**-6)])
def test_warp_supersampled_matches_jax(dtype, tol):
    x = _images(3, seed=0)
    g = _g_inv(3, seed=3)
    xj = jnp.asarray(x, dtype)
    want = np.asarray(jax.jit(jax_aug._warp_supersampled)(xj, g), np.float32)
    got = port_aug.warp_supersampled(_t(np.asarray(xj, np.float32)).to(getattr(torch, dtype)),
                                     _t(g))
    assert got.dtype == getattr(torch, dtype) and got.shape == x.shape
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=tol)


@pytest.mark.parametrize(("dtype", "tol"), [("float32", 1e-4), ("bfloat16", 2.0**-5)])
def test_augment_supersample_matches_jax(dtype, tol):
    x = _images(4, seed=7)
    key = jax.random.key(8)
    xj = jnp.asarray(x, dtype)
    want = np.asarray(jax_aug.augment(xj, 0.9, key, supersample=True), np.float32)
    got = port_aug.augment(_t(np.asarray(xj, np.float32)).to(getattr(torch, dtype)), 0.9,
                           jax_augment_draws(key, 4), supersample=True)
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=tol)


def test_warp_supersampled_gradient_matches_jax_f32():
    x = _images(2, seed=22)
    g = _g_inv(2, seed=23)
    want = jax.jit(jax.grad(lambda z: jnp.sum(jnp.sin(jax_aug._warp_supersampled(z, g)))))(
        jnp.asarray(x))
    xt = _t(x).requires_grad_(True)
    torch.sin(port_aug.warp_supersampled(xt, _t(g))).sum().backward()
    assert xt.grad.abs().max().item() > 0
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want), rtol=0, atol=1e-5)


def test_identity_is_interior_exact():
    """Identity affine: D @ U departs from the identity only at the
    zero-extended borders (as in the published pipeline); the interior is
    reproduced (the JAX package's own test and tolerance)."""
    x = _images(1, seed=1)
    out = port_aug.warp_supersampled(_t(x), torch.eye(3)[None]).numpy()
    m = 8  # the sym6 support's margin
    np.testing.assert_allclose(out[:, m:-m, m:-m], x[:, m:-m, m:-m], rtol=0, atol=5e-3)
    assert np.abs(out - x).max() > 5e-3  # not at the borders


def test_the_2x_grid_goes_through_the_warp_kernels_wrapper(monkeypatch):
    """One ``warp`` call per augment, on the contiguous [B, 2H, 2W] image,
    antialias off, widths 1; ``supersample`` overrides ``antialias``."""
    seen = []
    real = port_aug.warp

    def spy(images, sx, sy, width_x, width_y, *, antialias):
        seen.append((tuple(images.shape), images.is_contiguous(), tuple(sx.shape), antialias,
                     width_x.tolist(), width_y.tolist()))
        return real(images, sx, sy, width_x, width_y, antialias=antialias)

    monkeypatch.setattr(port_aug, "warp", spy)
    x = torch.from_numpy(_images(2, seed=4))
    draws = port_aug.draw_augment(torch.Generator().manual_seed(0), 2, "cpu")
    a = port_aug.augment(x, 0.9, draws, antialias=True, supersample=True)
    b = port_aug.augment(x, 0.9, draws, antialias=False, supersample=True)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    shape = (2, 2 * SIZE, 2 * SIZE)
    assert seen == [(shape, True, shape, False, [1.0, 1.0], [1.0, 1.0])] * 2
    with pytest.raises(ValueError, match="single-channel"):
        port_aug.warp_supersampled(torch.zeros((1, 8, 8, 3)), torch.eye(3)[None])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float64])
@pytest.mark.parametrize(("shape", "spread"), [((3, 16, 24), 1.0), ((2, 33, 17), 3.0)])
def test_plain_warp_without_antialias_gathers_the_dense_terms(shape, spread, dtype):
    """Coordinates inside and far outside the frame, on integers and half
    pixels, and a NaN: the gathered taps give the dense contraction's bits."""
    b, h, w = shape
    gen = torch.Generator().manual_seed(h)
    x = torch.randn(shape, generator=gen).to(dtype)
    sx = (torch.rand(shape, generator=gen) * 1.4 - 0.2) * w * spread
    sy = (torch.rand(shape, generator=gen) * 1.4 - 0.2) * h * spread
    sx[:, 0, :5] = torch.arange(5.0) - 1
    sx[:, 1, :3] = torch.tensor([w - 1.0, w - 0.5, -0.5])
    sx[0, 2, 0] = float("nan")
    ones = torch.ones(b)
    got = warp_module.warp_plain(x, sx, sy, ones, ones, antialias=False)
    want = warp_module._dense_plain(x, sx, sy, ones, ones, False)
    assert got.dtype == dtype and torch.isnan(got[0, 2, 0]) and torch.isnan(want[0, 2, 0])
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)
