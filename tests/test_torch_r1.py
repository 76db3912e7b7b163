"""Lazy R1 in the port against the JAX package, on the CPU.

The JAX package's R1 (``losses.r1_penalty``, taken in ``d_phase`` on the
augmented reals in float32 every ``r1_interval`` steps,
``core/train_step.py``) is a double backward through the discriminator.
At the tiny config of ``tests/test_torch_d_phase.py`` (64x64, batch 2,
min_latent 32: 1 resampling level, 1 resnet block; the discriminator at
its only width, whose last instance norm normalises 6x6 planes; at 32x32
its 2x2 planes make the bfloat16 term ill-conditioned, 12 % off float32 in
JAX and 31 % in the port) the port gets the JAX parameter trees through
``convert.from_jax_params`` and runs on the same inputs and draws:

- ``gamma / 2 * r1_penalty`` and its gradient in every discriminator
  parameter against ``jax.value_and_grad`` of the JAX term, in float32
  with the JAX run's LeakyReLU pattern pinned (``ops/activations.py``;
  the JAX program sends it to the host, as in
  ``tests/test_torch_g_phase.py``), and in bfloat16 against the float32
  gradient beside JAX's own bfloat16 gradient;
- one D phase with ``r1_gamma = 10``, ``r1_interval = 2`` at step 0 (R1
  on) against JAX's ``d_phase``; at step 1 (R1 off) the port's phase is
  bit for bit its ``r1_gamma = 0`` phase, and matches JAX's.

Tolerances (float32, the JAX package's): the term rtol 2e-5 (the IN's
tolerance; it is a sum of squared input gradients); the gradients 1e-4
of each leaf's largest entry, as the D phase's (tests/test_torch_d_phase.py);
the biases of the convs an instance norm follows have gradient 0 in
exact arithmetic and the head's bias none (D's gradient in its input does
not depend on it): those below 1e-5 of the largest gradient entry. The
whole phase as tests/test_torch_d_phase.py holds it (rtol 2e-4 / atol
2e-5). bfloat16: the term within the JAX package's 0.05, relative; each
gradient no farther from the float32 gradient than 1.25x JAX's bf16
gradient is (the test's docstring).

The two JAX programs (the R1 term's gradient, compiled for each precision,
and the R1 D phase, run at both steps) are jitted at XLA's backend
optimisation level 0 (``fast_jit``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from one_to_many_gan_torch import convert as port_convert
from one_to_many_gan_torch.augment import AdaState as PortAdaState
from one_to_many_gan_torch.core import train_step as port_ts
from one_to_many_gan_torch.core.state import Models as PortModels
from one_to_many_gan_torch.core.state import init_train_state as port_init_state
from one_to_many_gan_torch.losses import r1_penalty
from one_to_many_gan_torch.ops import activations
from one_to_many_gan_torch.presets import tiny_config as port_tiny_config
from one_to_many_gan_tpu import losses as jax_losses
from one_to_many_gan_tpu.augment import AdaState as JaxAdaState
from one_to_many_gan_tpu.augment import init_ada_state
from one_to_many_gan_tpu.core import buffer as jax_buffer
from one_to_many_gan_tpu.core.state import Models as JaxModels
from one_to_many_gan_tpu.core.state import TrainState
from one_to_many_gan_tpu.core.state import make_optimizers as jax_optimizers
from one_to_many_gan_tpu.core.train_step import Batches, make_phase_fns
from one_to_many_gan_tpu.presets import tiny_config as jax_tiny_config
from tests.test_torch_augment import fast_jit
from tests.test_torch_d_phase import BATCH, BUFFER, LR, _hwio, _jax_d_draws, _jax_leaf, _params, _t
from tests.test_torch_g_phase import _recording_jax_kinks

SIZE, GAMMA, INTERVAL = 64, 10.0, 2
# Biases of the convs an instance norm follows: gradient 0 in exact
# arithmetic; the head's bias: none from R1.
ZERO_GRAD = {f"params/EqualizedConv_{i}/bias" for i in (1, 2, 3)}
HEAD_BIAS = "params/EqualizedConv_4/bias"


def _configs(precision: str):
    kw = {"min_latent": 32, "n_resnet_blocks": 1, "buffer_size": BUFFER,
          "tpu": {"precision": precision, "ada_pallas": True, "ada_antialias": True,
                  "r1_gamma": GAMMA, "r1_interval": INTERVAL}}
    return jax_tiny_config((SIZE, SIZE), BATCH, **kw), port_tiny_config((SIZE, SIZE), BATCH, **kw)


@pytest.fixture(scope="module")
def params():
    jm = JaxModels(_configs("float32")[0])
    img = jnp.zeros((1, SIZE, SIZE, 1))
    return (
        _params(jm.generator.init, img, jnp.zeros((jm.n_style_blocks, 1, jm.w_dim)), seed=0),
        _params(jm.discriminator.init, img, seed=1),
        _params(jm.mapping.init, jnp.zeros((1, jm.w_dim)), seed=2),
    )


def _port_state(pcfg, params):
    """-> (models, state) carrying the JAX G, mapping and D weights."""
    np_tree = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    models = PortModels(pcfg, device="cpu", seed=9)
    ps = port_init_state(pcfg, models, seed=9)
    params_g, params_d, params_m = params
    port_convert.from_jax_params(ps, np_tree(params_g), np_tree(params_m), np_tree(params_d))
    return models, ps


def _d_leaves(ps):
    return list(port_convert.jax_leaves(port_convert._discriminator_layers(ps.discriminator)))


def _reals() -> np.ndarray:
    return np.random.default_rng(11).uniform(-1, 1, (BATCH, SIZE, SIZE, 1)).astype(np.float32)


# ----------------------------------------------------------- the R1 term


def _jax_r1(jm):
    """jitted (params_d, reals) -> (term, gradients, kinks as NCHW masks)."""
    sink: dict = {}

    def term(params_d, reals):
        with _recording_jax_kinks(sink):
            return jax.value_and_grad(
                lambda p: (GAMMA / 2.0) * jax_losses.r1_penalty(jm.discriminator.apply, p, reals)
            )(params_d)

    jitted = fast_jit(term)

    def call(params_d, reals):
        sink.clear()
        value, grads = jax.block_until_ready(jitted(params_d, reals))
        jax.effects_barrier()
        kinks = [torch.from_numpy(np.array(m.transpose(0, 3, 1, 2))) for _, m in sorted(sink.items())]
        return float(value), grads, kinks

    return call


@pytest.fixture(scope="module")
def jax_terms(params):
    """JAX's term, gradients and (float32) kink pattern in both precisions."""
    reals = jnp.asarray(_reals())
    return {precision: _jax_r1(JaxModels(_configs(precision)[0]))(params[1], reals)
            for precision in ("float32", "bfloat16")}


def _port_term(params, precision: str, kinks=None):
    """-> (term, {leaf: gradient in the JAX layout or None}, the kink pattern)."""
    _, ps = _port_state(_configs(precision)[1], params)
    leaves = _d_leaves(ps)
    x = torch.from_numpy(np.ascontiguousarray(_reals().transpose(0, 3, 1, 2)))
    with activations.pin(kinks) if kinks is not None else activations.record() as pattern:
        term = (GAMMA / 2.0) * r1_penalty(ps.discriminator, x)
        grads = torch.autograd.grad(term, [p for _, p, _ in leaves], allow_unused=True)
    assert term.dtype == torch.float32
    return term.item(), {path: None if g is None else _hwio(g)
                         for (path, _, _), g in zip(leaves, grads, strict=True)}, pattern


def test_r1_term_and_gradients_match_jax_float32(params, jax_terms):
    want, jgrads, kinks = jax_terms["float32"]
    got, grads, pattern = _port_term(params, "float32", kinks)
    assert len(kinks) == len(pattern.flips) == 4 and pattern.n_flips() == 0
    np.testing.assert_allclose(got, want, rtol=2e-5)
    largest = max(np.abs(_jax_leaf(jgrads, n)).max() for n in grads)
    for name, g in grads.items():
        jg = _jax_leaf(jgrads, name)
        if name == HEAD_BIAS:
            assert g is None and not jg.any(), name
        elif name in ZERO_GRAD:
            assert max(np.abs(g).max(), np.abs(jg).max()) < 1e-5 * largest, name
        else:
            np.testing.assert_allclose(g, jg, rtol=0, atol=1e-4 * np.abs(jg).max(), err_msg=name)


def test_r1_term_and_gradients_match_jax_bfloat16(params, jax_terms):
    """bfloat16 rounds every activation of a double backward: JAX's own
    bf16 gradients lie 7-13 % (per leaf, of its norm) from its float32
    ones, the port's 5-8 %. So each port leaf is held to the float32
    gradient no farther than 1.25x JAX's bf16 gradient is; the term within
    the JAX package's 0.05, relative (reading 1.1 %)."""
    want, jgrads, _ = jax_terms["bfloat16"]
    _, ref, _ = jax_terms["float32"]
    got, grads, _ = _port_term(params, "bfloat16")
    np.testing.assert_allclose(got, want, rtol=0.05)
    for name, g in grads.items():
        if name == HEAD_BIAS:
            assert g is None, name
            continue
        r = _jax_leaf(ref, name)
        port_err = np.linalg.norm(g - r)
        jax_err = np.linalg.norm(_jax_leaf(jgrads, name) - r)
        assert port_err <= 1.25 * jax_err, (name, port_err / np.linalg.norm(r),
                                            jax_err / np.linalg.norm(r))


# ---------------------------------------------------------- the D phase


def _jax_state(jcfg, params, step: int) -> TrainState:
    params_g, params_d, params_m = params
    return TrainState(
        step=jnp.int32(step), params_g=params_g, params_d=params_d, params_m=params_m,
        params_s={}, opt_g=(), opt_d=jax_optimizers(jcfg)["d"].init(params_d), opt_m=(),
        opt_s=(), ada=init_ada_state(), buffer=jax_buffer.init_buffer(BUFFER, (SIZE, SIZE, 1)),
        ema_params_g=None,
    )


def _port_phase(pcfg, params, step: int, prints, marks, draws):
    models, ps = _port_state(pcfg, params)
    ps.step = step
    ps.ada = PortAdaState(torch.tensor(0.7), torch.tensor(0, dtype=torch.int32),
                          torch.tensor(0.0))
    return port_ts.make_d_phase(pcfg, models)(ps, _t(prints), _t(marks), draws)


def test_d_phase_with_r1_matches_jax_on_and_off_steps(params):
    """One compiled JAX ``d_phase`` at steps 0 (R1 on) and 1 (off), ADA p
    0.7; the port's at both steps, and its ``r1_gamma = 0`` phase at step 1,
    which the off-step equals bit for bit."""
    jcfg, pcfg = _configs("float32")
    jm = JaxModels(jcfg)
    rng = np.random.default_rng(6)
    prints, marks = (rng.uniform(-1, 1, (BATCH, SIZE, SIZE, 1)).astype(np.float32)
                     for _ in range(2))
    key = jax.random.key(30)
    draws = _jax_d_draws(key, jm, jcfg)
    d_phase = fast_jit(make_phase_fns(jcfg, jm)[0])
    batches = Batches(*(jnp.asarray(a) for a in (prints, marks) * 2))
    off_cfg = _configs("float32")[1]
    off_cfg["tpu"]["r1_gamma"] = 0.0
    runs = {}
    for step in (0, 1):
        jstate = _jax_state(jcfg, params, step).replace(
            ada=JaxAdaState(jnp.float32(0.7), jnp.int32(0), jnp.float32(0.0)))
        jstate, jmet = d_phase(jstate, batches, key)
        runs[step] = (jstate, jmet, *_port_phase(pcfg, params, step, prints, marks, draws))
    plain_ps, plain_met = _port_phase(off_cfg, params, 1, prints, marks, draws)

    before = {path: _jax_leaf(params[1], path) for path, _, _ in _d_leaves(plain_ps)}
    # R1 raises D's loss on the on-step by its term (the reals are the same)
    assert runs[0][1]["disc_loss"] > runs[1][1]["disc_loss"] + 1e-3
    for step, (jstate, jmet, ps, pmet) in runs.items():
        for name in jmet:
            np.testing.assert_allclose(pmet[name].item(), float(jmet[name]), rtol=2e-4, atol=2e-5,
                                       err_msg=f"step {step} {name}")
        jgrads = jax.tree.map(lambda m: m / 0.5, jstate.opt_d[0].mu)  # mu = (1 - b1) g
        for path, param, _ in _d_leaves(ps):
            got, want = _hwio(param), _jax_leaf(jstate.params_d, path)
            bound = LR * (1 + 1e-5) + 2 * np.spacing(np.abs(before[path]) + LR)
            assert (np.abs(got - before[path]) <= bound).all(), path
            big = np.abs(_jax_leaf(jgrads, path)) >= 1e-6
            np.testing.assert_allclose(got[big], want[big], rtol=2e-4, atol=2e-5,
                                       err_msg=f"step {step} {path}")
    # the off-step is the r1_gamma = 0 update, bit for bit
    off_ps, off_met = runs[1][2], runs[1][3]
    assert all(torch.equal(off_met[k], plain_met[k]) for k in plain_met)
    for p, q in zip(off_ps.discriminator.parameters(), plain_ps.discriminator.parameters(),
                    strict=True):
        assert torch.equal(p, q)
    assert any(not torch.equal(p, q) for p, q in zip(
        runs[0][2].discriminator.parameters(), plain_ps.discriminator.parameters(), strict=True))
