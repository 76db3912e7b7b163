"""The port's discriminator phase of training against the JAX package's, on
the CPU.

A tiny config (64x64, batch 2, min_latent 32: 1 resampling level, 1
modulated resnet block; a 2-slot replay buffer; the discriminator at its
only size) gets flax parameter trees (names and shapes from flax, values
drawn as flax's initialisers draw them), is carried into the port through
``convert.from_jax_params`` (into a ``TrainState``, the holder of the
discriminator) and runs on both sides with the same batches
and the same draws. At 64x64 the discriminator's
last instance norm normalises over a 6x6 plane.

The draws rebuild the JAX key layout: the D phase's ``split(rng, 10)``
keys 0-3 (the JAX package's ``core/train_step.py:189``), the style draws'
``split(k, 4)`` (``models/mapping.py:45``), the buffer's ``split(k, 2)``
(``core/buffer.py:73-75``) and the augment draws
(``augment/pipeline.py:139,189,622``; ``jax_augment_draws``).

Tolerances, float32:

- losses, scores, instance-norm gradients: 2e-5 (the JAX package's IN
  tolerance, tests/test_pallas_kernels.py);
- discriminator gradients: 1e-4 relative to each leaf's largest entry
  (XLA and oneDNN sum a conv's weight gradient over 2B x H x W terms in
  different orders; measured below 1e-5);
- Adam: 1e-6 relative (one rearranged expression, f32);
- the whole phase: metrics, ADA state and ``params_d`` at rtol 2e-4 /
  atol 2e-5 (the JAX package's step tolerance, tests/test_pallas_kernels.py
  :133), the buffer exactly. Adam's first step moves a parameter by
  ``lr * g / (|g| + 1e-8)``: about ``lr`` times the gradient's sign
  wherever |g| >> 1e-8. Where the JAX gradient is below 1e-6 (the biases
  of the convs an instance norm follows, whose gradient is 0 in exact
  arithmetic, so rounding noise of either sign), only the bound
  ``|change| <= lr`` is checked.

bfloat16 (the discriminator and ADA in bf16, parameters and statistics in
f32): the JAX package's 0.05 on losses and instance-norm gradients, and
the Adam bound on every parameter.

The JAX programs are jitted at XLA's backend optimisation level 0
(``fast_jit``), which halves their compile time on the CPU.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from one_to_many_gan_torch import convert as port_convert
from one_to_many_gan_torch import losses as port_losses
from one_to_many_gan_torch.augment import AdaState as PortAdaState
from one_to_many_gan_torch.config import check_training_options
from one_to_many_gan_torch.core import buffer as port_buffer
from one_to_many_gan_torch.core import train_step as port_ts
from one_to_many_gan_torch.core.state import Models as PortModels
from one_to_many_gan_torch.core.state import init_train_state as port_init_state
from one_to_many_gan_torch.core.state import make_optimizers as port_optimizers
from one_to_many_gan_torch.models import StyleRngs as PortStyleRngs
from one_to_many_gan_torch.ops.cuda import fused_instance_norm
from one_to_many_gan_torch.presets import tiny_config as port_tiny_config
from one_to_many_gan_tpu import losses as jax_losses
from one_to_many_gan_tpu.augment import AdaState as JaxAdaState
from one_to_many_gan_tpu.augment import init_ada_state
from one_to_many_gan_tpu.core import buffer as jax_buffer
from one_to_many_gan_tpu.core.state import Models as JaxModels
from one_to_many_gan_tpu.core.state import TrainState
from one_to_many_gan_tpu.core.state import make_optimizers as jax_optimizers
from one_to_many_gan_tpu.core.train_step import Batches, make_phase_fns
from one_to_many_gan_tpu.core.train_step import batch_pack as jax_pack
from one_to_many_gan_tpu.core.train_step import batch_unpack as jax_unpack
from one_to_many_gan_tpu.models import sample_style_rngs
from one_to_many_gan_tpu.ops.norm import instance_norm as jax_instance_norm
from one_to_many_gan_tpu.presets import tiny_config as jax_tiny_config
from tests.test_torch_augment import fast_jit, jax_augment_draws

SIZE, BATCH, BUFFER = 64, 2, 2
LR = 2e-3
# Biases of the convs an instance norm follows: their gradient is 0.
IN_BIASES = {f"params/EqualizedConv_{i}/bias" for i in (1, 2, 3)}
REPO = Path(__file__).resolve().parents[1]


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _nchw(x) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.transpose(np.asarray(x, np.float32), (0, 3, 1, 2))))


def _configs(precision):
    kw = {
        "min_latent": 32, "n_resnet_blocks": 1, "buffer_size": BUFFER,
        "tpu": {"precision": precision, "ada_pallas": True, "ada_antialias": True},
    }
    return jax_tiny_config((SIZE, SIZE), BATCH, **kw), port_tiny_config((SIZE, SIZE), BATCH, **kw)


def _jax_leaf(tree, path: str):
    for part in path.split("/"):
        tree = tree[part]
    return np.asarray(tree, np.float32)


def _hwio(param: torch.Tensor) -> np.ndarray:
    a = param.detach().float().numpy()
    return a.transpose(2, 3, 1, 0) if a.ndim == 4 else a


def _d_leaves(ps):
    return list(port_convert.jax_leaves(port_convert._discriminator_layers(ps.discriminator)))


def _params(init, *args, seed: int):
    """A flax variable tree with ``init``'s leaf names and shapes (traced
    by ``jax.eval_shape``, nothing compiled) and flax's initial values:
    weights N(0, 1), biases 0, the style affines' biases 1."""
    rng = np.random.default_rng(seed)

    def leaf(path, shape):
        name = jax.tree_util.keystr(path)
        if name.endswith("['weight']"):
            return jnp.asarray(rng.standard_normal(shape.shape).astype(np.float32))
        return jnp.full(shape.shape, 1.0 if "to_style" in name else 0.0, jnp.float32)

    return jax.tree_util.tree_map_with_path(leaf, jax.eval_shape(init, jax.random.key(0), *args))


def _init_state(jcfg, jm, params=None) -> TrainState:
    """A JAX ``TrainState`` with what ``d_phase`` reads: G, mapping and D
    parameters (fresh, or ``params`` of another build: the trees are
    float32 in either precision), D's Adam state, ADA and the buffer. The
    G-phase fields stay empty."""
    if params is None:
        img = jnp.zeros((1, SIZE, SIZE, 1))
        params = (
            _params(jm.generator.init, img, jnp.zeros((jm.n_style_blocks, 1, jm.w_dim)), seed=0),
            _params(jm.discriminator.init, img, seed=1),
            _params(jm.mapping.init, jnp.zeros((1, jm.w_dim)), seed=2),
        )
    params_g, params_d, params_m = params
    return TrainState(
        step=jnp.zeros((), jnp.int32), params_g=params_g, params_d=params_d,
        params_m=params_m, params_s={}, opt_g=(), opt_d=jax_optimizers(jcfg)["d"].init(params_d),
        opt_m=(), opt_s=(), ada=init_ada_state(),
        buffer=jax_buffer.init_buffer(BUFFER, (SIZE, SIZE, 1)), ema_params_g=None,
    )


def _build(precision, params=None):
    """-> (JAX config, port config, JAX models, JAX state, port state): the
    port's state carries the JAX state's G, mapping and D weights."""
    jcfg, pcfg = _configs(precision)
    jm = JaxModels(jcfg)
    jstate = _init_state(jcfg, jm, params)
    ps = port_init_state(pcfg, PortModels(pcfg, device="cpu", seed=9), seed=9)
    np_tree = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    port_convert.from_jax_params(
        ps, np_tree(jstate.params_g), np_tree(jstate.params_m), np_tree(jstate.params_d)
    )
    return jcfg, pcfg, jm, jstate, ps


@pytest.fixture(scope="module")
def f32():
    return _build("float32")


# ------------------------------------------------------------- small parts


def test_batch_pack_and_unpack_match_jax():
    rng = np.random.default_rng(0)
    xs = [rng.standard_normal((3, 4, 5)).astype(np.float32) for _ in range(3)]
    for dim in (0, 1):
        want = jax_pack([jnp.asarray(x) for x in xs], axis=dim)
        got = port_ts.batch_pack([_t(x) for x in xs], dim=dim)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        for g, x in zip(port_ts.batch_unpack(got, 3, dim=dim), xs, strict=True):
            np.testing.assert_array_equal(g.numpy(), x)
    assert len(jax_unpack(want, 3, axis=1)) == 3


def test_losses_match_jax():
    rng = np.random.default_rng(1)
    real, fake = (rng.uniform(-0.5, 1.5, (4, 5, 5, 1)).astype(np.float32) for _ in range(2))
    np.testing.assert_allclose(
        port_losses.lsgan_d_loss(_t(real), _t(fake)).item(),
        float(jax_losses.lsgan_d_loss(jnp.asarray(real), jnp.asarray(fake))), rtol=1e-6)
    real[0, 0, 0, 0] = 0.5  # sign(0) = 0
    np.testing.assert_allclose(  # XLA may divide the exact sum by a reciprocal: 1 ulp
        port_losses.discriminator_confidence(_t(real)).item(),
        float(jax_losses.discriminator_confidence(jnp.asarray(real))), rtol=1e-6)


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_instance_norm_gradient_matches_jax(dtype, relu):
    """The closed-form backward of ``fused_instance_norm`` (the one the
    card runs) against ``jax.grad`` of the JAX package's instance norm."""
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((2, 6, 6, 5)) * 2 + 0.5).astype(np.float32)
    g = rng.standard_normal(x.shape).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    xj = jnp.asarray(x, jdt)

    def f(v):
        y = jax_instance_norm(v)
        y = jnp.maximum(y, 0) if relu else y
        return jnp.sum(y.astype(jnp.float32) * g)

    want = np.asarray(jax.grad(f)(xj), np.float32)
    xt = _nchw(np.asarray(xj, np.float32)).to(getattr(torch, dtype)).requires_grad_(True)
    y = fused_instance_norm(xt, relu=relu)
    (y.float() * _nchw(g)).sum().backward()
    assert xt.grad.dtype == xt.dtype
    got = np.transpose(xt.grad.float().numpy(), (0, 2, 3, 1))
    np.testing.assert_allclose(got, want, atol=2e-5 if dtype == "float32" else 0.05)


def test_buffer_matches_jax_through_fill_and_swaps():
    """Three pushes of 4 into 3 slots: the first fills the buffer and
    passes one image through the swap logic; the next two swap, with a
    slot drawn twice in one batch."""
    size, b = 3, 4
    rng = np.random.default_rng(3)
    js = jax_buffer.init_buffer(size, (4, 4, 1))
    ps = port_buffer.init_buffer(size, (4, 4, 1))
    repeated = False
    swapped = 0
    for push in range(3):
        fakes = rng.standard_normal((b, 4, 4, 1)).astype(np.float32)
        key = jax.random.key(20 + push)
        jout, js = jax_buffer.buffer_apply(js, jnp.asarray(fakes), key)
        k1, k2 = jax.random.split(key)
        draws = port_buffer.BufferDraws(
            swap=_t(jax.random.uniform(k1, (b,))), slot=_t(jax.random.randint(k2, (b,), 0, size))
        )
        repeated |= len(set(draws.slot.tolist())) < b
        pout, ps = port_buffer.buffer_apply(ps, torch.from_numpy(fakes), draws)
        np.testing.assert_array_equal(pout.numpy(), np.asarray(jout))
        np.testing.assert_array_equal(ps.images.numpy(), np.asarray(js.images))
        assert ps.count.item() == int(js.count)
        swapped += int((pout.numpy() != fakes).any(axis=(1, 2, 3)).sum())
    assert repeated and swapped >= 2 and ps.count.item() == size


def test_adam_matches_optax_over_three_steps():
    import optax

    jcfg, pcfg = _configs("float32")
    module = torch.nn.ParameterList(
        torch.nn.Parameter(torch.randn(shape, generator=torch.Generator().manual_seed(i)))
        for i, shape in enumerate([(4, 4, 3, 8), (8,), (5, 7)])
    )
    opt = port_optimizers(pcfg, {"d": module})["d"]
    params = list(module)
    jparams = [jnp.asarray(p.detach().numpy().copy()) for p in params]  # no shared memory
    tx = jax_optimizers(jcfg)["d"]
    jstate = tx.init(jparams)
    update = jax.jit(tx.update)
    rng = np.random.default_rng(4)
    for _ in range(3):
        # magnitudes from 1e-9 (below Adam's eps) to 1
        grads = [(rng.standard_normal(p.shape) * 10.0 ** rng.integers(-9, 1, p.shape))
                 .astype(np.float32) for p in params]
        for p, g in zip(params, grads, strict=True):
            p.grad = torch.from_numpy(g)
        opt.step()
        updates, jstate = update([jnp.asarray(g) for g in grads], jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
    for p, jp in zip(params, jparams, strict=True):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp), rtol=1e-6, atol=1e-7)


def test_discriminator_forward_and_gradients_match_jax(f32):
    """The loss-and-grad function ``d_phase`` calls, on the same packed
    inputs as ``jax.value_and_grad`` of the JAX phase's packed pass."""
    jcfg, pcfg, jm, jstate, ps = f32
    rng = np.random.default_rng(5)
    fake, real = (rng.uniform(-1.5, 1.5, (BATCH, SIZE, SIZE, 1)).astype(np.float32)
                  for _ in range(2))

    def loss_fn(params_d):
        scores = jm.discriminator.apply(params_d, jax_pack([jnp.asarray(fake), jnp.asarray(real)]))
        f, r = jax_unpack(scores.astype(jnp.float32), 2)
        return jax_losses.lsgan_d_loss(r, f), (r, f)

    (want_loss, (want_r, want_f)), want_g = fast_jit(
        jax.value_and_grad(loss_fn, has_aux=True)
    )(jstate.params_d)
    loss, r, f = port_ts.d_loss_and_grad(ps.discriminator, _t(fake), _t(real))
    assert r.shape == (BATCH, 5, 5, 1)
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=2e-5)
    np.testing.assert_allclose(r.numpy(), np.asarray(want_r), atol=2e-5)
    np.testing.assert_allclose(f.numpy(), np.asarray(want_f), atol=2e-5)
    for path, param, _ in _d_leaves(ps):
        want = _jax_leaf(want_g, path)
        got = _hwio(param.grad)
        if path in IN_BIASES:  # zero in exact arithmetic: both are rounding noise
            assert max(np.abs(got).max(), np.abs(want).max()) < 1e-5, path
            continue
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max(),
                                   err_msg=path)


def test_resampling_after_serving_still_trains():
    """The resampling taps are cached per shape and dtype; built first under
    ``inference_mode`` (serving), they must still serve a backward pass."""
    from one_to_many_gan_torch.ops import resample

    resample._taps.cache_clear()
    x = torch.randn((2, 3, 8, 8))
    with torch.inference_mode():
        resample.downsample2x(x)
        resample.upsample2x(x)
    xr = x.clone().requires_grad_(True)
    (resample.downsample2x(xr).sum() + resample.upsample2x(xr).sum()).backward()
    assert xr.grad is not None and torch.isfinite(xr.grad).all()


# ------------------------------------------------------------ the D phase


def _jax_d_draws(key, jm, jcfg) -> port_ts.DPhaseDraws:
    """The port's draws of JAX ``d_phase(state, batches, key)``."""
    keys = jax.random.split(key, 10)
    style = sample_style_rngs(keys[0], BATCH, jm.w_dim, jm.n_style_blocks,
                              jcfg["training"]["style_mixing_prob"])
    k1, k2 = jax.random.split(keys[1])
    return port_ts.DPhaseDraws(
        style=PortStyleRngs(*(_t(t) for t in style)),
        buffer=port_buffer.BufferDraws(
            swap=_t(jax.random.uniform(k1, (BATCH,))),
            slot=_t(jax.random.randint(k2, (BATCH,), 0, BUFFER)),
        ),
        aug_fake=jax_augment_draws(keys[2], BATCH),
        aug_real=jax_augment_draws(keys[3], BATCH),
    )


def _run_both(built, ada: tuple[float, int, float], prefill: bool):
    """One D phase on both sides from the same start: ADA state ``ada`` =
    (p, count, accum); the buffer empty, or (``prefill``) full of the same
    random images, so that the phase swaps. -> (JAX state, metrics, port
    state, metrics)."""
    jcfg, pcfg, jm, jstate0, ps0 = built
    p, count, accum = ada
    jstate = jstate0.replace(ada=JaxAdaState(jnp.float32(p), jnp.int32(count), jnp.float32(accum)))
    pm = PortModels(pcfg, device="cpu", seed=9)
    pm.generator.load_state_dict(ps0.generator.state_dict())
    pm.mapping.load_state_dict(ps0.mapping.state_dict())
    pstate = port_init_state(pcfg, pm)
    pstate.discriminator.load_state_dict(ps0.discriminator.state_dict())
    pstate.ada = PortAdaState(torch.tensor(p), torch.tensor(count, dtype=torch.int32),
                              torch.tensor(accum))
    rng = np.random.default_rng(6)
    if prefill:
        stored = rng.uniform(-1, 1, (BUFFER, SIZE, SIZE, 1)).astype(np.float32)
        jstate = jstate.replace(buffer=jax_buffer.BufferState(jnp.asarray(stored), jnp.int32(BUFFER)))
        pstate.buffer = port_buffer.BufferState(_t(stored), torch.tensor(BUFFER, dtype=torch.int32))
    prints, marks = (rng.uniform(-1, 1, (BATCH, SIZE, SIZE, 1)).astype(np.float32)
                     for _ in range(2))
    key = jax.random.key(30)
    jstate, jm_out = fast_jit(make_phase_fns(jcfg, jm)[0])(
        jstate, Batches(*(jnp.asarray(a) for a in (prints, marks) * 2)), key)
    pstate, pm_out = port_ts.make_d_phase(pcfg, pm)(
        pstate, _t(prints), _t(marks), _jax_d_draws(key, jm, jcfg))
    return jstate, jm_out, pstate, pm_out


def _adam_bound(before: np.ndarray) -> np.ndarray:
    """Adam's first step moves a parameter by at most ``lr``; the float32
    result rounds to the parameter's spacing."""
    move = LR * (1 + 1e-5)
    return move + 2 * np.spacing(np.abs(before) + move)


def _check_params(jstate, params_before, ps, jgrads=None):
    for path, param, _ in _d_leaves(ps):
        got = _hwio(param)
        want = _jax_leaf(jstate.params_d, path)
        before = params_before[path]
        bound = _adam_bound(before)
        assert (np.abs(got - before) <= bound).all(), path
        assert (np.abs(want - before) <= bound).all(), path
        if jgrads is not None:
            big = np.abs(_jax_leaf(jgrads, path)) >= 1e-6
            np.testing.assert_allclose(got[big], want[big], rtol=2e-4, atol=2e-5, err_msg=path)


def _jax_grads(jstate):
    """The JAX gradients of a first D phase, read back from Adam's first
    moment (``mu = (1 - b1) * g`` after one step, b1 = 0.5)."""
    return jax.tree.map(lambda m: m / 0.5, jstate.opt_d[0].mu)


def _params_before(built):
    return {path: _jax_leaf(built[3].params_d, path) for path, _, _ in _d_leaves(built[4])}


def test_d_phase_matches_jax_f32(f32):
    """One phase from an empty buffer, the ADA window at its boundary (so
    the controller moves p), p = 0.7: transforms, wide tents and the fill
    of the buffer all occur."""
    before = _params_before(f32)
    jstate, jmet, pstate, pmet = _run_both(f32, (0.7, 4, 2.6), prefill=False)
    assert set(pmet) == set(jmet) == {"disc_loss", "disc_real_acc", "disc_fake_acc", "ada_p"}
    for name in jmet:
        np.testing.assert_allclose(pmet[name].item(), float(jmet[name]), rtol=2e-4, atol=2e-5,
                                   err_msg=name)
    np.testing.assert_allclose(pstate.ada.p.item(), float(jstate.ada.p), rtol=2e-4, atol=2e-5)
    assert pstate.ada.p.item() != 0.7  # the window closed
    assert pstate.ada.count.item() == int(jstate.ada.count) == 1
    np.testing.assert_allclose(pstate.ada.accum.item(), float(jstate.ada.accum),
                               rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(pstate.buffer.images.numpy(), np.asarray(jstate.buffer.images),
                               rtol=0, atol=1e-4)
    assert pstate.buffer.count.item() == int(jstate.buffer.count) == BUFFER
    _check_params(jstate, before, pstate, _jax_grads(jstate))


def test_d_phase_matches_jax_bf16(f32):
    """One phase in bf16 through a full buffer (it swaps). The
    discriminator sees bf16 inputs on both sides, so scores and losses
    agree to bf16 resolution; the window stays open, so p is exact."""
    built = _build("bfloat16", params=(f32[3].params_g, f32[3].params_d, f32[3].params_m))
    before = _params_before(built)
    jstate, jmet, pstate, pmet = _run_both(built, (0.6, 0, 0.0), prefill=True)
    np.testing.assert_allclose(pmet["disc_loss"].item(), float(jmet["disc_loss"]), atol=0.05)
    assert pmet["ada_p"].item() == float(jmet["ada_p"]) == np.float32(0.6)
    assert pstate.ada.p.item() == float(jstate.ada.p)
    assert pstate.ada.count.item() == int(jstate.ada.count) == 1
    assert pstate.buffer.count.item() == int(jstate.buffer.count) == BUFFER
    # The buffered fakes are the bf16 generator's output in f32.
    np.testing.assert_allclose(pstate.buffer.images.numpy(), np.asarray(jstate.buffer.images),
                               atol=0.05)
    for path, param, _ in _d_leaves(pstate):
        moved = np.abs(_hwio(param) - before[path])
        assert (moved <= _adam_bound(before[path])).all() and moved.max() > LR / 2, path
        assert torch.isfinite(param.grad).all(), path


def test_serving_models_hold_no_discriminator():
    """Serving builds only the generator and the mapping network; the
    training state builds the discriminator and hands it to D's Adam."""
    _, pcfg = _configs("float32")
    pm = PortModels(pcfg, device="cpu")
    assert not hasattr(pm, "discriminator")
    state = port_init_state(pcfg, pm, seed=1)
    params = list(state.discriminator.parameters())
    assert all(p.requires_grad for p in params)
    assert state.opt_d.param_groups[0]["params"] == params
    again = port_init_state(pcfg, pm, seed=1).discriminator
    assert all(torch.equal(p, q) for p, q in zip(params, again.parameters(), strict=True))


def test_make_d_phase_refuses_options_not_ported():
    for key, value in (("r1_gamma", 10.0), ("ema_decay", 0.999), ("ada_supersample", True)):
        cfg = port_tiny_config((SIZE, SIZE), BATCH, tpu={key: value})
        with pytest.raises(NotImplementedError, match=f"tpu.{key}.*ROADMAP.md"):
            check_training_options(cfg)
    check_training_options(port_tiny_config((SIZE, SIZE), BATCH, tpu={"ada_pallas": True}))


# ----------------------------------------------------------------- weights


def test_convert_carries_the_discriminator(f32):
    """Every D leaf round-trips HWIO -> OIHW -> HWIO exactly; a wrong shape,
    a missing or an extra leaf raises."""
    _, pcfg, _, jstate, ps = f32
    leaves = _d_leaves(ps)
    assert len(leaves) == 10
    for path, param, _ in leaves:
        np.testing.assert_array_equal(_hwio(param), _jax_leaf(jstate.params_d, path))
    tree = jax.tree.map(np.array, jstate.params_d)
    fresh = port_init_state(pcfg, PortModels(pcfg, device="cpu", seed=4), seed=4)
    g = jax.tree.map(np.asarray, jstate.params_g)
    m = jax.tree.map(np.asarray, jstate.params_m)
    bad = jax.tree.map(np.array, tree)
    bad["params"]["EqualizedConv_4"]["weight"] = np.zeros((4, 4, 512, 2), np.float32)
    with pytest.raises(ValueError, match="EqualizedConv_4/weight"):
        port_convert.from_jax_params(fresh, g, m, bad)
    bad = jax.tree.map(np.array, tree)
    del bad["params"]["EqualizedConv_2"]["bias"]
    with pytest.raises(ValueError, match="missing .*EqualizedConv_2/bias"):
        port_convert.from_jax_params(fresh, g, m, bad)
    bad = jax.tree.map(np.array, tree)
    bad["params"]["EqualizedConv_5"] = {"bias": np.zeros(1, np.float32)}
    with pytest.raises(ValueError, match="unexpected .*EqualizedConv_5/bias"):
        port_convert.from_jax_params(fresh, g, m, bad)


# --------------------------------------------------------------------- CLI


def test_train_d_cli_runs_on_the_cpu(tmp_path, capsys):
    """``python -m one_to_many_gan_torch.train_d`` at a 32x32 config: the
    buffer fills, the ADA window advances, the losses are finite."""
    import json

    from one_to_many_gan_torch import train_d

    text = (REPO / "configs" / "cpu_smoke.toml").read_text()
    text = text.replace("image_size = [64, 64]", "image_size = [32, 32]")
    text = text.replace("min_latent_resolution = 64", "min_latent_resolution = 16")
    text = text.replace("n_resnet_blocks = 7", "n_resnet_blocks = 1")
    cfg = tmp_path / "config.toml"
    cfg.write_text(text)
    train_d.main([str(cfg), "--device", "cpu", "--steps", "2", "--ada-p", "0.6"])
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [ln["step"] for ln in lines] == [0, 1]
    assert [ln["buffer_count"] for ln in lines] == [4, 8]
    assert [ln["ada_count"] for ln in lines] == [1, 2]
    assert all(np.isfinite(ln["disc_loss"]) and ln["device"] == "cpu" for ln in lines)
