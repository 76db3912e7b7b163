"""The port's generator phase and fused training step against the JAX
package's, on the CPU.

The tiny config of ``tests/test_torch_d_phase.py`` (64x64, batch 2,
min_latent 32: 1 resampling level, 1 modulated resnet block, 2 style
blocks; a 2-slot replay buffer) gets flax parameter trees for the
generator, mapping network, discriminator and style extractor, carried
into the port through ``convert.from_jax_params``; both sides run
``make_train_step`` (the D phase, then the G phase), or the G phase
alone, on the same batches and the same draws. The draws rebuild the JAX
key layout: one ``split(rng, 10)`` per step, keys 0-3 for the D phase
(``tests/test_torch_d_phase.py``), keys 4-9 for the G phase (θ, h, latent
noise, ``w_t``'s style draws, the translations' augment draws, ``w_path``'s
style draws; the JAX package's ``core/train_step.py:289-293,304-306,321,
337,369``).

Each fused step starts with the ADA window at its boundary and an
adjustment of 0.05, so the D phase's controller moves p by 0.4: the G
phase must augment at the p that entered the step and score with the
discriminator the D phase updated, and the test fails if either is
swapped (checked by running it against both mistakes: the G phase at the
controller's new p fails on ``gan_loss``; the G phase run before the D
phase fails on the pinned kink pattern, whose calls come in the other
order).

Kinks. The ReLUs and LeakyReLUs of one fused step take 1.3e7 inputs.
Where one lies within float32 rounding of 0, the two packages can put it
on different sides of the kink, where the derivative is 1 on one side
and 0 or 0.2 on the other; one such flip moves every gradient upstream
of it by up to ~1e-3 of the leaf's largest entry. So the JAX program
sends the side each activation input took to the host
(``_recording_jax_kinks``), and the port's step runs with that pattern
pinned (``ops/activations.py``): each activation takes JAX's side, its
values stay its own, and the pin counts the inputs whose own side
differed: 5 of 1.3e7 on the path step, 4 on the next, held to
``MAX_FLIPS`` (an error upstream of a kink would move thousands). The
gradients are then held at 1e-4 of each leaf's largest entry.

Tolerances, float32:

- metrics: rtol 2e-4 / atol 2e-5 (the JAX package's step tolerance,
  tests/test_pallas_kernels.py:133; reading 8.0e-7 relative);
- gradients of generator, mapping, extractor and (after the D phase)
  discriminator, read from Adam's first moments on the JAX side
  (``mu_k = b1 mu_{k-1} + (1 - b1) g_k``, b1 = 0.5) and from ``.grad`` on
  the port's: 1e-4 of each leaf's largest entry (readings: 1.5e-5 on
  the path step, 1.7e-5 on the next, both the discriminator's);
- parameters: Adam's first step moves each by ``lr * g / (|g| + eps)``,
  at most lr on both sides; they are held at rtol 2e-4 / atol 2e-5 where
  ``|g|`` exceeds twice the two gradients' largest disagreement (so the
  signs agree) and eps does not magnify that disagreement past 1e-5,
  and on a later step where the disagreement is under 1 % of ``|g|``.
  The biases of the convs an instance norm follows, in the encoder and
  in both trunks, have gradient 0 in exact arithmetic: below 1e-5 on
  both sides.

Each step after the first starts the port from the JAX state the step
before left (parameters, Adam's moments, buffer, step counter), so that
each is compared from one start: Adam's ``sign(g)`` turns gradient
entries that are ~0 on both sides into parameters 2 lr apart.

bfloat16 (activations bf16, parameters and statistics f32): the G phase
alone, two steps at path interval 8, and one fused step at interval 1,
with latent noise, kinks not pinned (bf16 rounding puts ~2600 inputs on
the other side); each metric's limit stands beside its reading in
``BF16_METRIC_RTOL`` and ``BF16_D_*``, the parameters within Adam's
bound.

The JAX programs are jitted with XLA's CPU fusion emitters off and its
backend optimisation level at 1 (``JAX_COMPILE``): on one core the G
phase's compile falls from ~22 s to ~15 s and its run rises from ~5 s to
~8 s; each program is compiled and run once.
"""

import contextlib
import itertools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from one_to_many_gan_torch import convert as port_convert
from one_to_many_gan_torch.augment import AdaState as PortAdaState
from one_to_many_gan_torch.core import buffer as port_buffer
from one_to_many_gan_torch.core import train_step as port_ts
from one_to_many_gan_torch.core.state import Models as PortModels
from one_to_many_gan_torch.core.state import init_train_state as port_init_state
from one_to_many_gan_torch.models import StyleRngs as PortStyleRngs
from one_to_many_gan_torch.ops import activations
from one_to_many_gan_torch.presets import tiny_config as port_tiny_config
from one_to_many_gan_tpu.augment import AdaState as JaxAdaState
from one_to_many_gan_tpu.core.state import Models as JaxModels
from one_to_many_gan_tpu.core.state import TrainState
from one_to_many_gan_tpu.core.state import make_optimizers as jax_optimizers
from one_to_many_gan_tpu.core.train_step import Batches, make_phase_fns, make_train_step
from one_to_many_gan_tpu.models import sample_style_rngs
from one_to_many_gan_tpu.presets import tiny_config as jax_tiny_config
from tests.test_torch_augment import jax_augment_draws
from tests.test_torch_d_phase import (
    BATCH,
    BUFFER,
    LR,
    REPO,
    SIZE,
    _jax_d_draws,
    _jax_leaf,
    _params,
    _t,
)
from tests.test_torch_d_phase import _init_state as _jax_d_state

G_METRICS = ("total_gen_loss", "gan_loss", "reconstruction_loss", "identity_loss",
             "kl_loss", "style_loss", "path_loss")
# Leaves whose gradient is 0 in exact arithmetic: the biases of the convs
# an instance norm follows, in the encoder and the extractor's trunk.
ZERO_GRAD = {("g", "params/enc_stem/bias"), ("g", "params/enc_down_0/bias")} | {
    ("s", f"params/EqualizedConv_{i}/bias") for i in (1, 2, 3)}
# of each leaf's largest entry, with the kinks pinned
GRAD_RTOL = 1e-4
# Inputs of the port's activations whose own side differed from the JAX
# package's, of 1.3e7 per step (readings: 5 on the path step, 4 on the
# next).
MAX_FLIPS = 16
JAX_COMPILE = {"xla_cpu_use_fusion_emitters": False, "xla_backend_optimization_level": 1}
ADAM_EPS = 1e-8
# The ADA window at its boundary (ada_e = 4 batches): the D phase closes
# it and moves p, by 0.4 (adjustment 0.05 x ada_e 8), so that the
# augmentation's gates see the difference.
ADA_BOUNDARY = (0.6, 4, 2.6)
ADA_ADJUSTMENT = 0.05


def _configs(precision: str, interval: int, noise: bool = False):
    kw = {
        "min_latent": 32, "n_resnet_blocks": 1, "buffer_size": BUFFER,
        "tpu": {"precision": precision, "ada_pallas": True, "ada_antialias": True,
                "path_interval": interval},
        "architecture": {"add_latent_noise": noise},
        "ada": {"ada_adjustment_size": ADA_ADJUSTMENT},
    }
    return jax_tiny_config((SIZE, SIZE), BATCH, **kw), port_tiny_config((SIZE, SIZE), BATCH, **kw)


def _port_leaf(param: torch.Tensor) -> np.ndarray:
    """A port parameter (or gradient) in the JAX layout: OIHW -> HWIO,
    ``[out, in]`` -> ``[in, out]``."""
    a = param.detach().float().numpy()
    return a.transpose(2, 3, 1, 0) if a.ndim == 4 else a.T if a.ndim == 2 else a


def _networks(ps, with_d: bool = False):
    """(key, port module, its JAX layers) of G, mapping, extractor (and D)."""
    nets = [
        ("g", port_convert._generator_layers(ps.generator)),
        ("m", port_convert._mapping_layers(ps.mapping)),
        ("s", port_convert._extractor_layers(ps.extractor)),
    ]
    if with_d:
        nets.append(("d", port_convert._discriminator_layers(ps.discriminator)))
    return nets


def _leaves(ps):
    """(network, JAX leaf path, port parameter) of G, mapping and extractor."""
    for net, layers in _networks(ps):
        for path, param, _ in port_convert.jax_leaves(layers):
            yield net, path, param


def _load_jax_state(ps, jstate) -> None:
    """Set the port's state to the JAX state: the parameters, Adam's
    moments and counts of all four networks, the buffer and the step."""
    trees = {"g": jstate.params_g, "m": jstate.params_m, "s": jstate.params_s,
             "d": jstate.params_d}
    opts = {"g": (ps.opt_g, jstate.opt_g), "m": (ps.opt_m, jstate.opt_m),
            "s": (ps.opt_s, jstate.opt_s), "d": (ps.opt_d, jstate.opt_d)}
    for net, layers in _networks(ps, with_d=True):
        opt, jopt = opts[net]
        adam = jopt[0]
        for path, param, layout in port_convert.jax_leaves(layers):
            def conv(tree, path=path, layout=layout):
                value = _jax_leaf(tree, path)
                return torch.from_numpy(port_convert._to_torch_layout(value, layout).copy())

            with torch.no_grad():
                param.copy_(conv(trees[net]))
            opt.state[param] = {"step": torch.tensor(float(adam.count)),
                                "exp_avg": conv(adam.mu), "exp_avg_sq": conv(adam.nu)}
    ps.buffer = port_buffer.BufferState(_t(jstate.buffer.images), _t(jstate.buffer.count))
    ps.step = int(jstate.step)


def _build(precision: str, interval: int, noise: bool = False):
    """-> (JAX config, port config, JAX models, JAX state, port models,
    port state) on the same weights, ADA at the window boundary."""
    jcfg, pcfg = _configs(precision, interval, noise)
    jm = JaxModels(jcfg)
    jd = _jax_d_state(jcfg, jm)
    img = jnp.zeros((1, SIZE, SIZE, 1))
    params_s = _params(jm.extractor.init, img, seed=3)
    opts = jax_optimizers(jcfg)
    p, count, accum = ADA_BOUNDARY
    jstate = TrainState(
        step=jnp.zeros((), jnp.int32), params_g=jd.params_g, params_d=jd.params_d,
        params_m=jd.params_m, params_s=params_s, opt_g=opts["g"].init(jd.params_g),
        opt_d=jd.opt_d, opt_m=opts["m"].init(jd.params_m), opt_s=opts["s"].init(params_s),
        ada=JaxAdaState(jnp.float32(p), jnp.int32(count), jnp.float32(accum)),
        buffer=jd.buffer, ema_params_g=None,
    )
    pm = PortModels(pcfg, device="cpu", seed=9)
    ps = port_init_state(pcfg, pm, seed=9)
    ps.ada = _port_ada()
    np_tree = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    port_convert.from_jax_params(
        ps, *(np_tree(t) for t in (jd.params_g, jd.params_m, jd.params_d, params_s)))
    return jcfg, pcfg, jm, jstate, pm, ps


def _jax_g_draws(key, jm, jcfg, noise_shape=None) -> port_ts.GPhaseDraws:
    """The port's draws of JAX ``g_phase(state, batches, key, p)``."""
    keys = jax.random.split(key, 10)
    lo, hi = jcfg["optimisation"]["path_loss_jacobian_granularity"]
    mixing = jcfg["training"]["style_mixing_prob"]

    def style(k):
        return PortStyleRngs(*(_t(t) for t in sample_style_rngs(
            k, BATCH, jm.w_dim, jm.n_style_blocks, mixing)))

    noise = None
    if noise_shape is not None:
        noise = jax.random.normal(keys[6], noise_shape, jm.dtype)
        noise = torch.from_numpy(np.asarray(noise, np.float32)).to(
            torch.bfloat16 if jm.dtype == jnp.bfloat16 else torch.float32)
    return port_ts.GPhaseDraws(
        theta=_t(jax.random.uniform(keys[4], (BATCH,))),
        fin_diff_h=_t(jax.random.uniform(keys[5], (BATCH,), minval=lo, maxval=hi)),
        latent_noise=noise,
        style=style(keys[7]),
        aug=jax_augment_draws(keys[8], BATCH),
        path_style=style(keys[9]),
    )


def _batches(seed: int):
    rng = np.random.default_rng(seed)
    return [rng.uniform(-1, 1, (BATCH, SIZE, SIZE, 1)).astype(np.float32) for _ in range(4)]


def _snapshot(ps) -> dict:
    return {(net, path): _port_leaf(param).copy() for net, path, param in _leaves(ps)}


@contextlib.contextmanager
def _recording_jax_kinks(sink: dict):
    """While a JAX program is traced inside the block, its ReLUs and
    LeakyReLUs (the JAX package calls ``jax.nn.relu`` and
    ``jax.nn.leaky_relu``) also send the side each input takes (``x > 0``,
    ``x >= 0``: their derivatives' conventions) to ``sink[call index]``
    whenever the program runs. Calls that are no model activation are left
    alone: the Pallas warp's tent weights (3-d) and the batch-1 shape
    probes of the models' wrappers."""
    relu, leaky = jax.nn.relu, jax.nn.leaky_relu
    calls = itertools.count()

    def send(x, side):
        if x.ndim in (2, 4) and x.shape[0] > 1:
            i = next(calls)
            jax.debug.callback(lambda m, i=i: sink.__setitem__(i, np.asarray(m)), side)

    def recording_relu(x):
        send(x, x > 0)
        return relu(x)

    def recording_leaky(x, negative_slope=0.01):
        send(x, x >= 0)
        return leaky(x, negative_slope)

    jax.nn.relu, jax.nn.leaky_relu = recording_relu, recording_leaky
    try:
        yield
    finally:
        jax.nn.relu, jax.nn.leaky_relu = relu, leaky


def _jax_program(jcfg, jm, k: int, g_only: bool = False):
    """JAX's ``make_train_step`` (``g_only``: its G phase alone, at the
    state's ADA p) at step ``k``, jitted -> ``call(state, batches, key) ->
    (state, metrics, kinks)``, ``kinks`` the side each activation input
    took, in call order, as the port's NCHW masks. The step counter is a
    numpy constant and ``jax.disable_jit`` is active while the step is
    traced, so the lazy path's ``lax.cond`` takes its branch at trace
    time."""
    if g_only:
        _, g_phase = make_phase_fns(jcfg, jm)

        def step(state, batches, key):
            return g_phase(state, batches, key, state.ada.p)
    else:
        step = make_train_step(jcfg, jm)
    sink = {}

    def run(state, batches, key):
        with jax.disable_jit(), _recording_jax_kinks(sink):
            return step(state.replace(step=np.int32(k)), batches, key)

    jitted = jax.jit(run, compiler_options=JAX_COMPILE)

    def call(state, batches, key):
        sink.clear()
        state, metrics = jax.block_until_ready(jitted(state, batches, key))
        jax.effects_barrier()
        kinks = [torch.from_numpy(np.array(m.transpose(0, 3, 1, 2) if m.ndim == 4 else m))
                 for _, m in sorted(sink.items())]
        return state, metrics, kinks

    return call


def _port_ada() -> PortAdaState:
    p, count, accum = ADA_BOUNDARY
    return PortAdaState(torch.tensor(p), torch.tensor(count, dtype=torch.int32),
                        torch.tensor(accum))


def _run(built, n_steps: int, noise: bool = False, g_only: bool = False, pin: bool = True):
    """``n_steps`` steps on both sides (fused, or ``g_only``), each from
    the ADA boundary, the port's with the JAX run's kinks pinned (unless
    ``pin`` is off); from the
    second on, the port starts from the JAX state the previous step left
    (parameters, Adam, buffer, step), so that each step is compared from
    one start: f32 rounding differs between the two, and Adam's first
    step, ``lr * sign(g)``, turns a gradient entry that is ~0 on both
    sides into a parameter 2 lr apart.
    -> per step a dict: JAX state and metrics, port metrics, the port's
    gradients, its parameters before and after, its ADA p, its
    discriminator's ``.grad`` and the pin's flip count; and the port
    state."""
    jcfg, pcfg, jm, jstate, pm, ps = built
    if g_only:
        g_phase = port_ts.make_g_phase(pcfg, pm)

        def port_step(state, batches, draws):
            return g_phase(state, batches, draws.g, state.ada.p)
    else:
        port_step = port_ts.make_train_step(pcfg, pm)
    latent = SIZE // 2  # one resampling level
    noise_shape = (2 * BATCH, latent, latent, pm.generator.latent_features) if noise else None
    runs = []
    for k in range(n_steps):
        p, count, accum = ADA_BOUNDARY
        jstate = jstate.replace(
            ada=JaxAdaState(jnp.float32(p), jnp.int32(count), jnp.float32(accum)))
        if k:
            _load_jax_state(ps, jstate)
        ps.ada = _port_ada()
        before = _snapshot(ps)
        arrays = _batches(40 + k)
        key = jax.random.key(50 + k)
        jstate, jmet, kinks = _jax_program(jcfg, jm, k, g_only)(
            jstate, Batches(*(jnp.asarray(a) for a in arrays)), key)
        assert int(jstate.step) == k + 1
        draws = port_ts.StepDraws(d=_jax_d_draws(key, jm, jcfg),
                                  g=_jax_g_draws(key, jm, jcfg, noise_shape))
        with activations.pin(kinks) if pin else contextlib.nullcontext() as pinned:
            ps, pmet = port_step(ps, port_ts.Batches(*(_t(a) for a in arrays)), draws)
        if pin:
            assert len(pinned.flips) == len(kinks), "the port ran fewer activations than JAX"
        runs.append({
            "jstate": jstate, "jmet": jmet, "pmet": pmet, "before": before,
            "after": _snapshot(ps), "p": ps.ada.p.item(),
            "flips": pinned.n_flips() if pin else None,
            "kinks": kinks,
            "grads": {(net, path): _port_leaf(param.grad) for net, path, param in _leaves(ps)},
            "d_grads": [p.grad.clone() if p.grad is not None else None
                        for p in ps.discriminator.parameters()],
        })
    return runs, ps


def _jax_grads(runs, k: int) -> dict:
    """The JAX gradients of step ``k`` per network, from Adam's first
    moments: ``mu_k = b1 mu_{k-1} + (1 - b1) g_k`` with b1 = 0.5."""

    def mu(state):
        return {"g": state.opt_g[0].mu, "m": state.opt_m[0].mu, "s": state.opt_s[0].mu,
                "d": state.opt_d[0].mu}

    now = mu(runs[k]["jstate"])
    if k == 0:
        return {net: jax.tree.map(lambda a: np.asarray(a) / 0.5, t) for net, t in now.items()}
    prev = mu(runs[k - 1]["jstate"])
    return {net: jax.tree.map(lambda a, b: (np.asarray(a) - 0.5 * np.asarray(b)) / 0.5,
                              now[net], prev[net]) for net in now}


def _check_step(run: dict, jgrads: dict | None, ps, first: bool) -> None:
    """The parameters' moves; with ``jgrads`` (float32), the port's
    gradients held to JAX's and its parameters where the two gradients
    must give the same update. ``first``: Adam's first step, which moves
    every parameter by at most lr on both sides."""
    jstate = run["jstate"]
    params = {"g": jstate.params_g, "m": jstate.params_m, "s": jstate.params_s}
    for net, path, _ in _leaves(ps):
        before, got = run["before"][net, path], run["after"][net, path]
        want = _jax_leaf(params[net], path)
        assert np.abs(got - before).max() > 0, path
        lr = LR / 100 if net == "m" else LR  # the mapping network's rate
        if first:
            bound = lr * (1 + 1e-5) + 2 * np.spacing(np.abs(before) + lr)
            assert (np.abs(got - before) <= bound).all(), path
            assert (np.abs(want - before) <= bound).all(), path
        grad = run["grads"][net, path]
        if jgrads is None:
            assert np.isfinite(grad).all(), path
            continue
        jg = _jax_leaf(jgrads[net], path)
        err = np.abs(grad - jg)
        if (net, path) in ZERO_GRAD:
            assert max(np.abs(grad).max(), np.abs(jg).max()) < 1e-5, path
            continue
        assert err.max() <= GRAD_RTOL * np.abs(jg).max(), path
        # Where the gradients must give the same update. Adam's first step
        # is lr * g / (|g| + eps): where |g| exceeds twice the two sides'
        # disagreement (the signs agree) and eps does not magnify it past
        # half the atol (its derivative is lr * eps / (|g| + eps)^2). A
        # later step scales with g: where the disagreement is under 1 % of
        # |g|.
        if first:
            low = np.abs(jg) - err.max()
            same = (low > err.max()) & (lr * ADAM_EPS * err.max() / (low + ADAM_EPS) ** 2 < 1e-5)
        else:
            same = np.abs(jg) > 100 * err.max()
        assert same.mean() > 0.1, path
        np.testing.assert_allclose(got[same], want[same], rtol=2e-4, atol=2e-5, err_msg=path)


def _check_d(run: dict, jgrads: dict, ps) -> None:
    """The discriminator's ``.grad`` after the fused step is the D phase's,
    JAX's at the G leaves' tolerance: the G phase computed no gradient
    into it."""
    leaves = port_convert.jax_leaves(port_convert._discriminator_layers(ps.discriminator))
    for (path, _, _), grad in zip(leaves, run["d_grads"], strict=True):
        if path.endswith(("_1/bias", "_2/bias", "_3/bias")):  # an IN follows: 0
            continue
        want = _jax_leaf(jgrads["d"], path)
        err = np.abs(_port_leaf(grad) - want).max()
        assert err <= GRAD_RTOL * np.abs(want).max(), path


def _check_metrics(jmet, pmet, k: int) -> None:
    assert set(pmet) == set(jmet) and set(G_METRICS) <= set(pmet)
    for name in jmet:
        np.testing.assert_allclose(pmet[name].item(), float(jmet[name]), rtol=2e-4, atol=2e-5,
                                   err_msg=f"step {k}: {name}")


@pytest.fixture(scope="module")
def f32_two_steps():
    built = _build("float32", 8)
    runs, ps = _run(built, 2)
    return runs, ps


def test_fused_steps_match_jax_f32_path_interval_8(f32_two_steps):
    """Step 0 is a path step (the term scaled by 8), step 1 is not (path
    loss 0, no extract)."""
    runs, ps = f32_two_steps
    for k, run in enumerate(runs):
        _check_metrics(run["jmet"], run["pmet"], k)
        assert run["flips"] <= MAX_FLIPS
        # the D phase moved p; the G phase used the p entering the step
        assert run["pmet"]["ada_p"].item() == np.float32(ADA_BOUNDARY[0]) != run["p"]
        jgrads = _jax_grads(runs, k)
        _check_step(run, jgrads, ps, first=k == 0)
        _check_d(run, jgrads, ps)
    assert runs[0]["pmet"]["path_loss"].item() > 0
    assert runs[1]["pmet"]["path_loss"].item() == 0.0
    assert ps.step == 2
    m0 = runs[0]["pmet"]
    main = sum(w * m0[n].item() for w, n in (
        (1.0, "gan_loss"), (5.0, "identity_loss"), (5.0, "reconstruction_loss"),
        (0.01, "kl_loss"), (5.0, "style_loss")))
    np.testing.assert_allclose(m0["total_gen_loss"].item(),
                               main + 0.1 * 8 * m0["path_loss"].item(), rtol=1e-5)


def test_fused_step_matches_jax_f32_path_interval_1():
    """At interval 1 every step is a path step and the term is not
    scaled (the JAX package's non-lazy structure)."""
    runs, ps = _run(_build("float32", 1), 1)
    run = runs[0]
    _check_metrics(run["jmet"], run["pmet"], 0)
    assert run["flips"] <= MAX_FLIPS
    assert run["pmet"]["path_loss"].item() > 0
    jgrads = _jax_grads(runs, 0)
    _check_step(run, jgrads, ps, first=True)
    _check_d(run, jgrads, ps)


def test_fused_step_at_interval_1_is_interval_8s_path_step_with_8x_lambda(f32_two_steps):
    """The JAX package pins that its interval-L path step is its
    interval-1 step with ``path_loss_lambda`` scaled by L
    (tests/test_lazy_path.py); the port's interval-1 step with lambda 0.8
    gives its interval-8 step 0 with lambda 0.1, the kinks pinned to the
    same pattern."""
    runs, _ = f32_two_steps
    jcfg, pcfg, jm, _, pm, ps = _build("float32", 1)
    pcfg["optimisation"]["path_loss_lambda"] = 0.8
    key = jax.random.key(50)
    draws = port_ts.StepDraws(d=_jax_d_draws(key, jm, jcfg), g=_jax_g_draws(key, jm, jcfg))
    with activations.pin(runs[0]["kinks"]) as pinned:
        ps, pmet = port_ts.make_train_step(pcfg, pm)(
            ps, port_ts.Batches(*(_t(a) for a in _batches(40))), draws)
    assert ps.step == 1 and pinned.n_flips() == runs[0]["flips"]
    for name, want in runs[0]["pmet"].items():
        np.testing.assert_allclose(pmet[name].item(), want.item(), rtol=1e-6, atol=1e-7,
                                   err_msg=name)
    for net, path, param in _leaves(ps):
        np.testing.assert_allclose(_port_leaf(param), runs[0]["after"][net, path], rtol=0,
                                   atol=1e-6, err_msg=path)


# bfloat16 against the JAX package's bfloat16, the G phase alone, each
# metric's error relative to JAX's value: the larger reading of the two
# steps, then the limit. The extractor's trunk runs in bfloat16, so the
# style loss (and the total, through its weight of 5) moves most. The JAX
# program's own rounding moves these readings: at XLA's default
# optimisation level instead of JAX_COMPILE's, gan_loss read 6.8e-4 and
# reconstruction_loss 1.3e-6.
BF16_METRIC_RTOL = {
    "total_gen_loss": 1e-2,  # 3.0e-3
    "gan_loss": 1.5e-2,  # 3.5e-3
    "reconstruction_loss": 5e-5,  # 1.4e-5
    "identity_loss": 5e-4,  # 7.0e-5
    "kl_loss": 1.5e-4,  # 2.5e-6
    "style_loss": 4e-2,  # 1.1e-2
    # (f1 - f2) / h over h in [0.1, 0.2] magnifies the features' bf16
    # rounding; the mean over every tap's entries averages it: 3.7e-5
    # (0.11253065 against 0.11252646), on the path step
    "path_loss": 2e-4,
}
# The fused step's D metrics in bfloat16: the loss relative to JAX's
# (reading 1.5e-3), the accuracies absolute: the sign of one of the 50
# patch scores (2 images of 5x5), 2/50 (reading 0).
BF16_D_LOSS_RTOL = 5e-3
BF16_ACC_ATOL = 2 / 50


@pytest.fixture(scope="module")
def bf16_two_steps():
    return _run(_build("bfloat16", 8, noise=True), 2, noise=True, g_only=True, pin=False)


def test_g_phase_matches_jax_bf16_path_interval_8_with_latent_noise(bf16_two_steps):
    """bfloat16, the G phase alone at path interval 8 (step 0 a path step,
    step 1 not), with ``architecture.add_latent_noise`` on (key 6, drawn
    in bfloat16)."""
    runs, ps = bf16_two_steps
    for k, run in enumerate(runs):
        jmet, pmet = run["jmet"], run["pmet"]
        assert set(pmet) == set(jmet) == set(G_METRICS)
        for name, rtol in BF16_METRIC_RTOL.items():
            np.testing.assert_allclose(pmet[name].item(), float(jmet[name]), rtol=rtol, atol=0,
                                       err_msg=f"step {k}: {name}")
        _check_step(run, None, ps, first=k == 0)
    assert float(runs[0]["jmet"]["path_loss"]) > 0
    assert runs[1]["pmet"]["path_loss"].item() == float(runs[1]["jmet"]["path_loss"]) == 0.0
    assert ps.step == 2


def test_fused_step_matches_jax_bf16_path_interval_1_with_latent_noise():
    """bfloat16, the fused step at interval 1 (a path step, the term
    unscaled), with ``architecture.add_latent_noise`` on (key 6, drawn in
    bfloat16). Readings of the G metrics as in the interval-8 test."""
    runs, ps = _run(_build("bfloat16", 1, noise=True), 1, noise=True, pin=False)
    jmet, pmet = runs[0]["jmet"], runs[0]["pmet"]
    assert set(pmet) == set(jmet)
    for name, rtol in BF16_METRIC_RTOL.items():
        np.testing.assert_allclose(pmet[name].item(), float(jmet[name]), rtol=rtol, atol=0,
                                   err_msg=name)
    np.testing.assert_allclose(pmet["disc_loss"].item(), float(jmet["disc_loss"]),
                               rtol=BF16_D_LOSS_RTOL)
    for name in ("disc_real_acc", "disc_fake_acc"):
        assert abs(pmet[name].item() - float(jmet[name])) <= BF16_ACC_ATOL, name
    assert float(jmet["path_loss"]) > 0
    assert pmet["ada_p"].item() == np.float32(ADA_BOUNDARY[0]) != runs[0]["p"]
    _check_step(runs[0], None, ps, first=True)


def test_g_phase_leaves_the_discriminator_alone(f32_two_steps):
    """The G phase freezes the discriminator only while it runs: its
    parameters require gradients again afterwards, and its weights are
    the D phase's."""
    _, ps = f32_two_steps
    assert all(p.requires_grad for p in ps.discriminator.parameters())


# --------------------------------------------------------------------- CLI


def test_train_cli_runs_on_the_cpu(tmp_path, capsys):
    """``python -m one_to_many_gan_torch.train`` at a 32x32 config and
    path interval 2: step 0 is a path step, step 1 is not."""
    from one_to_many_gan_torch import train

    text = (REPO / "configs" / "cpu_smoke.toml").read_text()
    text = text.replace("image_size = [64, 64]", "image_size = [32, 32]")
    text = text.replace("min_latent_resolution = 64", "min_latent_resolution = 16")
    text = text.replace("n_resnet_blocks = 7", "n_resnet_blocks = 1")
    cfg = tmp_path / "config.toml"
    cfg.write_text(text + "\n[tpu]\npath_interval = 2\n")
    train.main([str(cfg), "--device", "cpu", "--synthetic-steps", "2", "--ada-p", "0.6"])
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [ln["step"] for ln in lines] == [0, 1]
    assert [ln["path_step"] for ln in lines] == [True, False]
    assert lines[0]["path_loss"] > 0 and lines[1]["path_loss"] == 0
    for ln in lines:
        assert ln["device"] == "cpu" and ln["ms"] > 0
        assert all(np.isfinite(ln[name]) for name in G_METRICS + ("disc_loss",))
