"""The parts of the port's generator phase against the JAX package, on the
CPU: the warp backward, the style extractor, the generator's losses, the
three generator-side Adams, the extractor's weights and the state; the
activations' kink pattern (``ops/activations.py``).

Tolerances:

- the warp backward's plain version against ``jax.vjp`` through
  ``warp_pallas`` (interpret mode): 2e-6 in float32 (the JAX package's
  warp tolerance, tests/test_pallas_kernels.py:80); in bfloat16 one bf16
  ulp of the output plus ``warp_bwd_sum_bound``, a proven bound on the
  error of float32 sums of the same terms (the Pallas kernel sums in
  float32, the plain version in float64), which exceeds an ulp only where
  the terms cancel to a value near 0. Against ``torch.autograd`` of
  ``warp_plain`` in float64: 1e-12 (the same products, summed in another
  order).
- the extractor: outputs 1e-5 (measured 1.5e-7) and gradients 1e-4
  relative to each leaf's largest entry in float32 (XLA and oneDNN sum a
  conv's terms in other orders; measured ≤ 1.6e-5), 0.05 in bfloat16 (the
  JAX package's);
- the losses: 1e-6 relative (the same float32 ops; a mean may divide by
  a reciprocal: one ulp);
- Adam: 1e-6 relative (one rearranged expression, f32).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from one_to_many_gan_torch import convert as port_convert
from one_to_many_gan_torch import losses as port_losses
from one_to_many_gan_torch.config import check_training_options
from one_to_many_gan_torch.core.state import Models as PortModels
from one_to_many_gan_torch.core.state import init_train_state as port_init_state
from one_to_many_gan_torch.core.state import make_optimizers as port_optimizers
from one_to_many_gan_torch.models import StyleExtractor
from one_to_many_gan_torch.ops import activations, fused_instance_norm
from one_to_many_gan_torch.ops.cuda.warp import (
    warp,
    warp_bwd,
    warp_bwd_plain,
    warp_bwd_sum_bound,
    warp_plain,
)
from one_to_many_gan_torch.presets import tiny_config as port_tiny_config
from one_to_many_gan_tpu import losses as jax_losses
from one_to_many_gan_tpu.core.state import make_optimizers as jax_optimizers
from one_to_many_gan_tpu.models.discriminator import StyleExtractor as JaxStyleExtractor
from one_to_many_gan_tpu.ops.pallas.warp import warp_pallas
from one_to_many_gan_tpu.presets import tiny_config as jax_tiny_config
from tests.test_torch_augment import _warp_case, fast_jit
from tests.test_torch_d_phase import BATCH, SIZE, _jax_leaf, _params, _t

# (shape, minify): ADA transforms at p = 0.9, scaled by ``minify`` (2.7:
# wide tents and points off the frame; 0.5: a magnification, many terms
# per input pixel).
BWD_CASES = [((3, 32, 32), 1.0), ((2, 16, 24), 1.0), ((2, 64, 64), 2.7), ((2, 64, 64), 0.5)]


def _nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2))))


def _jax_layout(a: torch.Tensor) -> np.ndarray:
    a = a.detach().float().numpy()
    return a.transpose(2, 3, 1, 0) if a.ndim == 4 else a.T if a.ndim == 2 else a


@functools.cache
def _jax_warp_vjp(antialias: bool):
    def vjp(x, sx, sy, wx, wy, dout):
        _, pullback = jax.vjp(lambda z: warp_pallas(z, sx, sy, wx, wy, antialias), x)
        return pullback(dout)[0]

    return fast_jit(vjp)


def _bwd_case(shape, minify, antialias, seed):
    x, sx, sy, wx, wy = _warp_case(shape, minify, antialias, seed=seed)
    dout = np.random.default_rng(seed + 1).standard_normal(shape).astype(np.float32)
    return x, dout, sx, sy, wx, wy


# ------------------------------------------------------------ warp backward


@pytest.mark.parametrize("antialias", [False, True])
@pytest.mark.parametrize(("shape", "minify"), BWD_CASES)
def test_warp_bwd_plain_matches_pallas_f32(shape, minify, antialias):
    x, dout, sx, sy, wx, wy = _bwd_case(shape, minify, antialias, seed=12)
    want = _jax_warp_vjp(antialias)(jnp.asarray(x), sx, sy, wx, wy, jnp.asarray(dout))
    coords = [_t(a) for a in (sx, sy, wx, wy)]
    got = warp_bwd_plain(_t(dout), *coords, antialias=antialias)
    assert got.dtype == torch.float32 and got.abs().max().item() > 0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=2e-6)
    # the wrapper takes the plain version for CPU tensors, without a build
    before = warp_bwd.launches
    torch.testing.assert_close(warp_bwd(_t(dout), *coords, antialias=antialias), got,
                               rtol=0, atol=0)
    assert warp_bwd.launches == before


@pytest.mark.parametrize("antialias", [False, True])
@pytest.mark.parametrize(("shape", "minify"), BWD_CASES[2:])
def test_warp_bwd_plain_matches_pallas_bf16(shape, minify, antialias):
    x, dout, sx, sy, wx, wy = _bwd_case(shape, minify, antialias, seed=13)
    db = jnp.asarray(dout, jnp.bfloat16)
    want = np.asarray(_jax_warp_vjp(antialias)(
        jnp.asarray(x, jnp.bfloat16), sx, sy, wx, wy, db), np.float64)
    coords = [_t(a) for a in (sx, sy, wx, wy)]
    dt = _t(np.asarray(db, np.float32)).bfloat16()
    got = warp_bwd_plain(dt, *coords, antialias=antialias)
    assert got.dtype == torch.bfloat16
    got = got.double().numpy()
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.maximum(abs(got), abs(want)), 2.0**-126))) - 7)
    bound = warp_bwd_sum_bound(dt, *coords, antialias=antialias).numpy()
    assert (np.abs(got - want) <= ulp + bound).all()


@pytest.mark.parametrize("antialias", [False, True])
def test_warp_bwd_plain_is_the_transpose_of_warp_plain(antialias):
    """In float64 the backward's weights are the forward's (no rounding to
    the image dtype), so it equals autograd of the forward."""
    x, dout, sx, sy, wx, wy = _bwd_case((2, 64, 64), 0.5, antialias, seed=14)
    coords = [_t(a) for a in (sx, sy, wx, wy)]
    xd = _t(x).double().requires_grad_(True)
    warp_plain(xd, *coords, antialias=antialias).backward(_t(dout).double())
    got = warp_bwd_plain(_t(dout).double(), *coords, antialias=antialias)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), xd.grad.numpy(), rtol=0, atol=1e-12)


def test_warp_is_differentiable_in_the_images_only():
    """On the CPU the autograd Function's backward is ``warp_bwd_plain`` on
    the contiguous cotangent (here an expanded one); the coordinates and
    widths get no gradient."""
    x, _, sx, sy, wx, wy = _bwd_case((2, 32, 32), 1.0, True, seed=15)
    xt = _t(x).requires_grad_(True)
    coords = [_t(a).requires_grad_(True) for a in (sx, sy, wx, wy)]
    out = warp(xt, *coords, antialias=True)
    assert out.grad_fn is not None
    out.mean().backward()
    want = warp_bwd_plain(torch.full(x.shape, 1.0 / x.size), *(c.detach() for c in coords),
                          antialias=True)
    torch.testing.assert_close(xt.grad, want, rtol=0, atol=0)
    assert all(c.grad is None for c in coords)


# -------------------------------------------------------------- extractor


@pytest.fixture(scope="module")
def extractor_params():
    return _params(JaxStyleExtractor(w_dim=6).init, jnp.zeros((1, SIZE, SIZE, 1)), seed=3)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_style_extractor_matches_flax(extractor_params, dtype):
    """Forward and gradients (parameters and input) against flax's, on one
    loss, ``sum(styles * c)``."""
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    js = JaxStyleExtractor(w_dim=6, dtype=jdt)
    rng = np.random.default_rng(16)
    x = rng.uniform(-1, 1, (BATCH, SIZE, SIZE, 1)).astype(np.float32)
    c = rng.standard_normal((BATCH, 6)).astype(np.float32)

    def loss(params, img):
        styles = js.apply(params, img)
        return jnp.sum(styles * c), styles

    (_, want), (jgp, jgx) = fast_jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(
        extractor_params, jnp.asarray(x))
    ext = StyleExtractor(1, 6, dtype=getattr(torch, dtype))
    port_convert._load(port_convert._extractor_layers(ext), jax.tree.map(
        np.asarray, extractor_params), "extractor")
    xt = _nchw(x).requires_grad_(True)
    styles = ext(xt)
    assert styles.dtype == torch.float32 and styles.shape == (BATCH, 6)
    (styles * torch.from_numpy(c)).sum().backward()
    gx = np.transpose(xt.grad.numpy(), (0, 2, 3, 1))
    if dtype == "bfloat16":
        np.testing.assert_allclose(styles.detach().numpy(), np.asarray(want), atol=0.05)
        assert np.isfinite(gx).all() and all(torch.isfinite(p.grad).all()
                                             for p in ext.parameters())
        return
    np.testing.assert_allclose(styles.detach().numpy(), np.asarray(want), rtol=0, atol=1e-5)
    np.testing.assert_allclose(gx, np.asarray(jgx), rtol=0, atol=1e-4 * np.abs(jgx).max())
    for path, param, _ in port_convert.jax_leaves(port_convert._extractor_layers(ext)):
        want_g = _jax_leaf(jgp, path)
        got_g = _jax_layout(param.grad)
        if path.endswith(("_1/bias", "_2/bias", "_3/bias")):  # an IN follows: 0
            assert max(np.abs(got_g).max(), np.abs(want_g).max()) < 1e-5, path
            continue
        np.testing.assert_allclose(got_g, want_g, rtol=0, atol=1e-4 * np.abs(want_g).max(),
                                   err_msg=path)


def test_discriminator_and_extractor_share_one_trunk_definition():
    """Both heads sit on ``Trunk``: the same four convs, the same names."""
    from one_to_many_gan_torch.models import Discriminator, Trunk

    d, s = Discriminator(1), StyleExtractor(1, 6)
    assert type(d.trunk) is type(s.trunk) is Trunk
    shapes = [tuple(p.shape) for p in d.trunk.parameters()]
    assert shapes == [tuple(p.shape) for p in s.trunk.parameters()]
    assert [n for n, _ in d.named_parameters()][:8] == [f"trunk.{i}.{w}" for i in range(4)
                                                        for w in ("weight", "bias")]


# ----------------------------------------------------------------- losses


def test_lsgan_g_and_l1_losses_match_jax():
    rng = np.random.default_rng(17)
    s, a, b = (rng.uniform(-0.5, 1.5, (4, 5, 5, 1)).astype(np.float32) for _ in range(3))
    np.testing.assert_allclose(port_losses.lsgan_g_loss(_t(s)).item(),
                               float(jax_losses.lsgan_g_loss(jnp.asarray(s))), rtol=1e-6)
    np.testing.assert_allclose(port_losses.l1_loss(_t(a), _t(b)).item(),
                               float(jax_losses.l1_loss(jnp.asarray(a), jnp.asarray(b))),
                               rtol=1e-6)


def test_style_cycle_loss_matches_jax():
    """With a style that is exactly 0 (the mapping's ReLU can give one): the
    normalisation's clamp and the 1e-8 clamp of the norm product."""
    rng = np.random.default_rng(18)
    a = np.maximum(rng.standard_normal((4, 6)), 0).astype(np.float32)
    a[1] = 0.0
    b = rng.standard_normal((4, 6)).astype(np.float32)
    want = jax_losses.style_cycle_loss(jnp.asarray(a), jnp.asarray(b))
    got = port_losses.style_cycle_loss(_t(a), _t(b))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


def test_kl_loss_matches_jax_over_the_whole_packed_tensor():
    x = (np.random.default_rng(19).standard_normal((4, 8, 8, 5)) * 1.5 + 0.3).astype(np.float32)
    np.testing.assert_allclose(port_losses.kl_loss(_t(x)).item(),
                               float(jax_losses.kl_loss(jnp.asarray(x))), rtol=1e-6)
    # biased variance over every element, not per sample or channel
    want = x.mean() ** 2 + (x.var() - 1) ** 2
    np.testing.assert_allclose(port_losses.kl_loss(_t(x)).item(), want, rtol=1e-5)


def test_path_loss_matches_jax_and_divides_by_h():
    """Three taps of differing shapes. With θ near 0 the clip makes
    d1 - d2 = θ + h/2 < h, and both packages still divide by h."""
    rng = np.random.default_rng(20)
    shapes = [(2, 4, 4, 8), (2, 4, 4, 8), (2, 8, 8, 4)]
    f1 = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    f2 = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    theta = np.asarray([0.01, 0.5], np.float32)
    h = np.asarray([0.15, 0.12], np.float32)
    d1, d2 = np.clip(theta + h / 2, 0, 1), np.clip(theta - h / 2, 0, 1)
    assert d1[0] - d2[0] < h[0]  # the clip bit
    want = jax_losses.path_loss([jnp.asarray(f) for f in f1], [jnp.asarray(f) for f in f2],
                                jnp.asarray(h))
    got = port_losses.path_loss([_nchw(f) for f in f1], [_nchw(f) for f in f2], _t(h))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    by_h = np.mean([np.mean(((a - b) / h[:, None, None, None]) ** 2) for a, b in zip(f1, f2)])
    np.testing.assert_allclose(got.item(), by_h, rtol=1e-5)


# ------------------------------------------------------------------ Adams


def test_generator_side_adams_match_optax_over_three_steps():
    """The generator's, mapping's (at its 100x lower rate) and extractor's
    Adams against the JAX package's optimizers."""
    jcfg = jax_tiny_config((SIZE, SIZE), BATCH)
    pcfg = port_tiny_config((SIZE, SIZE), BATCH)
    modules = {
        key: torch.nn.ParameterList(torch.nn.Parameter(
            torch.randn(shape, generator=torch.Generator().manual_seed(i))) for shape in shapes)
        for i, (key, shapes) in enumerate({
            "g": [(3, 3, 4, 8), (8,)], "m": [(6, 6), (6,)], "s": [(512, 6), (6,)]}.items())
    }
    opts = port_optimizers(pcfg, modules)
    assert opts["m"].param_groups[0]["lr"] == pcfg["optimisation"]["mapping_network_learning_rate"]
    txs = jax_optimizers(jcfg)
    rng = np.random.default_rng(21)
    for key, module in modules.items():
        params = list(module)
        jparams = [jnp.asarray(p.detach().numpy().copy()) for p in params]
        jstate = txs[key].init(jparams)
        for _ in range(3):
            grads = [(rng.standard_normal(p.shape) * 10.0 ** rng.integers(-9, 1, p.shape))
                     .astype(np.float32) for p in params]
            for p, g in zip(params, grads, strict=True):
                p.grad = torch.from_numpy(g)
            opts[key].step()
            updates, jstate = txs[key].update([jnp.asarray(g) for g in grads], jstate, jparams)
            jparams = optax.apply_updates(jparams, updates)
        for p, jp in zip(params, jparams, strict=True):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp), rtol=1e-6, atol=1e-9)


# ------------------------------------------------------- weights and state


def test_convert_carries_the_extractor(extractor_params):
    """Every extractor leaf round-trips exactly; a wrong shape, a missing
    or an extra leaf raises."""
    pcfg = port_tiny_config((SIZE, SIZE), BATCH, min_latent=32, n_resnet_blocks=1)
    pm = PortModels(pcfg, device="cpu", seed=2)
    state = port_init_state(pcfg, pm, seed=2)
    # the generator and mapping trees: the port's own weights, back out
    gen_tree = _port_tree(port_convert._generator_layers(pm.generator))
    m_tree = _port_tree(port_convert._mapping_layers(pm.mapping))
    tree = jax.tree.map(np.array, extractor_params)
    port_convert.from_jax_params(state, gen_tree, m_tree, params_s=tree)
    leaves = list(port_convert.jax_leaves(port_convert._extractor_layers(state.extractor)))
    assert len(leaves) == 10
    for path, param, _ in leaves:
        np.testing.assert_array_equal(_jax_layout(param), _jax_leaf(extractor_params, path))
    bad = jax.tree.map(np.array, tree)
    bad["params"]["EqualizedLinear_0"]["weight"] = np.zeros((512, 7), np.float32)
    with pytest.raises(ValueError, match="extractor leaf params/EqualizedLinear_0/weight"):
        port_convert.from_jax_params(state, gen_tree, m_tree, params_s=bad)
    bad = jax.tree.map(np.array, tree)
    del bad["params"]["EqualizedConv_3"]["bias"]
    with pytest.raises(ValueError, match="missing .*EqualizedConv_3/bias"):
        port_convert.from_jax_params(state, gen_tree, m_tree, params_s=bad)


def _port_tree(layers) -> dict:
    """A JAX-layout variable tree of the port's ``layers``."""
    out: dict = {}
    for path, param, _ in port_convert.jax_leaves(layers):
        node = out
        *parents, leaf = path.split("/")
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = _jax_layout(param)
    return out


def test_train_state_holds_the_extractor_and_four_adams():
    """The extractor is built after the discriminator from the same forked
    seed; gradients are on for the generator and mapping of the state,
    and serving's ``Models`` are built without them."""
    pcfg = port_tiny_config((SIZE, SIZE), BATCH, min_latent=32, n_resnet_blocks=1)
    pm = PortModels(pcfg, device="cpu", seed=1)
    assert not any(p.requires_grad for p in pm.generator.parameters())
    assert not hasattr(pm, "extractor")
    state = port_init_state(pcfg, pm, seed=1)
    assert all(p.requires_grad for m in (state.generator, state.mapping, state.extractor)
               for p in m.parameters())
    for opt, module in ((state.opt_d, state.discriminator), (state.opt_g, state.generator),
                        (state.opt_m, state.mapping), (state.opt_s, state.extractor)):
        assert opt.param_groups[0]["params"] == list(module.parameters())
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(1)
        from one_to_many_gan_torch.models import Discriminator

        Discriminator(1)
        again = StyleExtractor(1, 6)
    assert all(torch.equal(p, q) for p, q in zip(state.extractor.parameters(),
                                                  again.parameters(), strict=True))


def test_training_runs_g_loss_split():
    """``g_loss_split`` is accepted and its two sub-backwards run: on a path
    step the path term is positive and every generator, mapping and
    extractor parameter gets a finite gradient (``tests/test_torch_production.py``
    holds them to the joint backward's)."""
    from one_to_many_gan_torch.core import train_step as port_ts

    cfg = port_tiny_config((SIZE, SIZE), BATCH, min_latent=32, n_resnet_blocks=1,
                           tpu={"g_loss_split": True, "path_interval": 2})
    check_training_options(cfg)
    models = PortModels(cfg, device="cpu")
    state = port_init_state(cfg, models)
    gen = torch.Generator().manual_seed(0)
    batches = port_ts.Batches(*(port_ts.synthetic_batch(gen, BATCH, (SIZE, SIZE), 1)
                                for _ in range(4)))
    draws = port_ts.draw_g_phase(gen, cfg, models)
    metrics = port_ts.make_g_loss(cfg, models)(state, batches, draws, state.ada.p, True)
    assert metrics["path_loss"].item() > 0
    for m in (state.generator, state.mapping, state.extractor):
        assert all(p.grad is not None and torch.isfinite(p.grad).all() for p in m.parameters())


# ------------------------------------------------------ the kink pattern


def test_activations_outside_a_block_are_the_plain_ops():
    """ReLU is ``torch.relu``; LeakyReLU has JAX's derivative at 0 (1)."""
    x = torch.tensor([-2.0, -0.0, 0.0, 3.0], requires_grad=True)
    assert torch.equal(activations.relu(x), torch.relu(x))
    (g,) = torch.autograd.grad(activations.leaky_relu(x).sum(), x)
    jg = jax.grad(lambda v: jax.nn.leaky_relu(v, 0.2).sum())(jnp.asarray(x.detach().numpy()))
    np.testing.assert_array_equal(g.numpy(), np.asarray(jg))


def test_a_pinned_pattern_sets_the_derivative_and_counts_the_flips():
    """A float64 pass records its sides; a float32 pass whose input
    rounds to the other side of 0 at one entry takes float64's side
    there when pinned (the gradient is float64's), keeps its own values,
    and counts the one flip."""
    x64 = torch.tensor([[-1.0, 1e-9, 2.0], [-3e-9, 0.5, -0.25]], dtype=torch.float64)
    x32 = x64.float()
    x32[0, 1], x32[1, 0] = -1e-9, 3e-9  # within rounding, on the other side
    grads = {}
    for name, fn in (("relu", activations.relu), ("leaky", activations.leaky_relu)):
        xr = x64.clone().requires_grad_(True)
        with activations.record() as recorded:
            (g64,) = torch.autograd.grad(fn(xr).sum(), xr)
        xr = x32.clone().requires_grad_(True)
        (g_own,) = torch.autograd.grad(fn(xr).sum(), xr)
        with activations.pin(recorded.masks) as pinned:
            y = fn(xr)
            (g_pin,) = torch.autograd.grad(y.sum(), xr)
        assert pinned.n_flips() == 2 and len(pinned.flips) == 1
        assert not torch.equal(g_own.double(), g64)
        torch.testing.assert_close(g_pin.double(), g64, rtol=1e-7, atol=0)
        # its own values on float64's sides: x, and slope * x
        slope = 0.2 if name == "leaky" else 0.0
        assert y[0, 1].item() == x32[0, 1].item() < 0
        assert y[1, 0].item() == np.float32(slope) * x32[1, 0].item()
        grads[name] = g_pin
    assert grads["leaky"][0, 1].item() == 1.0 and grads["relu"][0, 1].item() == 1.0


def test_a_pin_refuses_a_pattern_of_another_shape_and_nested_blocks():
    x = torch.randn(2, 3)
    with activations.record() as recorded:
        activations.relu(x)
        with pytest.raises(RuntimeError, match="already"), activations.record():
            pass
    with pytest.raises(RuntimeError, match="shape"), activations.pin(recorded.masks):
        activations.relu(torch.randn(3, 2))


def test_fused_instance_norm_relu_takes_the_pattern_too():
    """Inside a block the fused instance norm's ReLU runs through the
    activations, so it is recorded and pinned with them."""
    x = torch.randn(2, 3, 5, 5, dtype=torch.float64, requires_grad=True)
    with activations.record() as recorded:
        y = fused_instance_norm(x, relu=True)
    assert len(recorded.masks) == 1 and recorded.masks[0].shape == x.shape
    torch.testing.assert_close(y, fused_instance_norm(x, relu=True))
    flipped = [~recorded.masks[0]]
    with activations.pin(flipped) as pinned:
        fused_instance_norm(x, relu=True)
    assert pinned.n_flips() == x.numel()
