"""The port's data parallelism on the CPU: gloo ranks against one process,
and against the JAX package's step under a 4x1 mesh.

Four gloo ranks (processes, one torch thread each) are started once for
the module and run each test's task together. The config is
``tests/helpers.write_tiny_config``'s (32x32, 3 resnet blocks) at a global
batch of 8 (2 per rank), float32, the lazy path term every 2nd step and
R1 (gamma 10) every 2nd step: step 0 is a path + R1 step, step 1 another.

- (a) the fused step of 4 ranks against one process at batch 8, each step
  from the same state (the one process's checkpoint dict, through
  ``migrate``), with the one process's kink pattern pinned in the ranks
  (each rank its rows of every mask; ``ops/activations.py``): every
  metric, gradient leaf and parameter within rtol 2e-4 / atol 2e-5 (the
  JAX package's step tolerance, ``tests/test_pallas_kernels.py:133``);
  parameters, buffer and ADA state bitwise equal across the ranks.
- (b) the JAX fused step under ``make_mesh(4, 1)`` (the
  ``tests/test_parallel.py`` pattern) against the port's 4 ranks on the
  same weights (``convert.from_jax_params``), batches and draws (the JAX
  key layout), with the JAX run's kinks pinned, held as
  ``tests/test_torch_g_phase.py`` holds one process.
- (c) the KL term across 4 ranks against one process: its value, and its
  gradient after ``reduce_gradients``.
- (d) the replay buffer across 4 ranks against one process at the global
  batch, bitwise.
- (e) the training CLI on 4 gloo ranks (``--device cpu``): 6 steps with
  checkpoints at 3 and 6, one file of each, one log line per log step;
  3.tar resumed in one process at the global batch gives rank 0's FID/KID
  line for it, and continues within the step tolerance of the 4-rank
  run's logged means.
- (e') the CLI at data 2 x spatial 2, resumed in one process and back
  (``tests/test_torch_spatial.py`` holds the spatial steps themselves).
- (f) the config's resolution of ``data_parallel`` and ``spatial_parallel``,
  and the four-card presets (data 4, and data 2 x spatial 2).
- (g) ``InferenceEngine(data_parallel=2)`` on two CPU replicas against one
  engine.
"""

import io
import os
import subprocess
import sys
import traceback
import warnings

import chip_smoke
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from one_to_many_gan_torch import convert as port_convert
from one_to_many_gan_torch import train as port_train
from one_to_many_gan_torch import train_d as port_train_d
from one_to_many_gan_torch.augment import AdaState as PortAdaState
from one_to_many_gan_torch.config import check_training_options, load_config
from one_to_many_gan_torch.config import resolve_data_parallel
from one_to_many_gan_torch.core import buffer as port_buffer
from one_to_many_gan_torch.core import train_step as port_ts
from one_to_many_gan_torch.core.state import Models, init_train_state
from one_to_many_gan_torch.data import write_synthetic_dataset_dirs
from one_to_many_gan_torch.losses import kl_loss
from one_to_many_gan_torch.migrate import from_reference_checkpoint, to_reference_checkpoint
from one_to_many_gan_torch.models import StyleRngs as PortStyleRngs
from one_to_many_gan_torch.ops import activations
from one_to_many_gan_torch.parallel import distributed
from one_to_many_gan_torch.presets import card_overrides, write_card_config
from one_to_many_gan_torch.serve import InferenceEngine
from one_to_many_gan_tpu.augment import AdaState as JaxAdaState
from one_to_many_gan_tpu.config import load_config as jax_load_config
from one_to_many_gan_tpu.core import buffer as jax_buffer
from one_to_many_gan_tpu.core.state import Models as JaxModels
from one_to_many_gan_tpu.core.state import TrainState
from one_to_many_gan_tpu.core.state import make_optimizers as jax_optimizers
from one_to_many_gan_tpu.core.train_step import Batches, make_train_step
from one_to_many_gan_tpu.models import sample_style_rngs
from one_to_many_gan_tpu.parallel import make_mesh, replicate, shard_batch
from tests.helpers import write_tiny_config
from tests.test_torch_augment import jax_augment_draws
from tests.test_torch_d_phase import _params, _t
from tests.test_torch_g_phase import (
    JAX_COMPILE,
    MAX_FLIPS,
    _check_d,
    _check_metrics,
    _check_step,
    _jax_grads,
    _leaves,
    _port_leaf,
    _recording_jax_kinks,
    _snapshot,
)

WORLD = 4
BATCH = 8  # global: 2 per rank
SIZE = 32
TPU = "\n[tpu]\npath_interval = 2\nr1_gamma = 10.0\nr1_interval = 2\nada_pallas = true\n"
ADA_P = 0.5  # the warp transforms
STEPS = 2  # step 0: path + R1; step 1: neither
STEP_TOL = {"rtol": 2e-4, "atol": 2e-5}
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ------------------------------------------------------------------ ranks


def _dumps(obj) -> bytes:
    buf = io.BytesIO()
    torch.save(obj, buf)
    return buf.getvalue()


def _loads(data: bytes):
    return torch.load(io.BytesIO(data), weights_only=False)


def _rank_loop(rank: int, port: int, tasks, results) -> None:
    """A rank of the pool: join the gloo group, then run ``(fn, args)``
    tasks (serialised) until ``None``, sending back each result or the
    traceback."""
    torch.set_num_threads(1)
    group = distributed.ensure_initialized("cpu", rank=rank, world_size=WORLD,
                                           init_method=f"tcp://127.0.0.1:{port}")
    while (item := tasks.get()) is not None:
        fn, args = _loads(item)
        try:
            results.put((rank, _dumps(("ok", fn(group, *args)))))
        except Exception:  # noqa: BLE001 — sent to the test, which fails with it
            results.put((rank, _dumps(("error", traceback.format_exc()))))
    group.close()
    dist.destroy_process_group()


class _Ranks:
    """Four gloo ranks; ``run(fn, *args)`` runs ``fn(group, *args)`` on all
    of them at once -> the results in rank order."""

    def __init__(self):
        ctx = torch.multiprocessing.get_context("spawn")
        port = distributed._free_port()
        self.tasks = [ctx.Queue() for _ in range(WORLD)]
        self.results = ctx.Queue()
        self.procs = [ctx.Process(target=_rank_loop, args=(r, port, self.tasks[r], self.results))
                      for r in range(WORLD)]
        for p in self.procs:
            p.start()

    def run(self, fn, *args) -> list:
        item = _dumps((fn, args))
        for q in self.tasks:
            q.put(item)
        out = [None] * WORLD
        for _ in range(WORLD):
            rank, data = self.results.get(timeout=600)
            status, value = _loads(data)
            if status != "ok":
                pytest.fail(f"rank {rank} raised:\n{value}")
            out[rank] = value
        return out

    def close(self) -> None:
        for q in self.tasks:
            q.put(None)
        for p in self.procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()


@pytest.fixture(scope="module")
def ranks():
    pool = _Ranks()
    yield pool
    pool.close()
    assert not any(p.is_alive() for p in pool.procs)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread in this process too (the suite runs several
    test workers on one host); restored afterwards."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def config_path(tmp_path_factory):
    return write_tiny_config(tmp_path_factory.mktemp("dp"), tpu_section=TPU, batch_size=BATCH)


def _batches(seed: int) -> list[np.ndarray]:
    rng = np.random.default_rng(seed)
    return [rng.uniform(-1, 1, (BATCH, SIZE, SIZE, 1)).astype(np.float32) for _ in range(4)]


def _state_of(state) -> dict:
    """Parameters, gradients, buffer and ADA of a port state (copies)."""
    nets = {"g": state.generator, "m": state.mapping, "d": state.discriminator,
            "s": state.extractor}
    return {
        "params": {f"{k}.{n}": p.detach().clone() for k, m in nets.items()
                   for n, p in m.named_parameters()},
        "grads": {f"{k}.{n}": p.grad.clone() for k, m in nets.items()
                  for n, p in m.named_parameters() if p.grad is not None},
        "buffer": (state.buffer.images.clone(), state.buffer.count.clone()),
        "ada": tuple(t.clone() for t in state.ada),
    }


def _slice_masks(masks, group) -> list[torch.Tensor]:
    """Each rank's rows of a global kink pattern: every activation runs on
    a batch whose rows are the global batch's interleaved packing, so a
    rank's inputs are a contiguous slice of each mask."""
    return [group.shard(m) for m in masks]


# ------------------------------------------------- (a) ranks vs one process


def _rank_step(group, path, ckpt, k, batches, draws, masks):
    config = load_config(path)
    models = Models(config, device="cpu", seed=0)
    state = from_reference_checkpoint(ckpt, init_train_state(config, models, seed=0), step=k)
    train_step = port_ts.make_train_step(config, models, group)
    rows = port_ts.Batches(*(group.shard(torch.from_numpy(b)) for b in batches))
    with activations.pin(_slice_masks(masks, group)) as pinned:
        state, metrics = train_step(state, rows, draws)
    assert len(pinned.flips) == len(masks), "the rank ran fewer activations than one process"
    return {"metrics": {k: v.item() for k, v in metrics.items()}, "flips": pinned.n_flips(),
            **_state_of(state)}


@pytest.fixture(scope="module")
def steps(ranks, config_path):
    """``STEPS`` fused steps of one process at batch 8 and of the 4 ranks,
    each from the one process's state before it, the one process's kinks
    pinned in the ranks."""
    config = load_config(config_path)
    models, state, _ = port_train.setup(config, seed=0, ada_p=ADA_P, device="cpu")
    train_step = port_ts.make_train_step(config, models)
    runs = []
    for k in range(STEPS):
        ckpt = to_reference_checkpoint(state)
        batches = _batches(40 + k)
        draws = port_ts.draw_step(torch.Generator().manual_seed(50 + k), config, models)
        with activations.record() as pattern:
            state, metrics = train_step(
                state, port_ts.Batches(*map(torch.from_numpy, batches)), draws)
        one = {"metrics": {k: v.item() for k, v in metrics.items()}, **_state_of(state)}
        runs.append((one, ranks.run(_rank_step, config_path, ckpt, k, batches, draws,
                                    pattern.masks)))
    return runs


@pytest.mark.parametrize("k", range(STEPS), ids=["path_r1_step", "other_step"])
def test_four_ranks_match_one_process(steps, k):
    """Metrics and gradients within the step tolerance; the parameters too,
    wherever Adam must move them alike (``chip_smoke.held_mask``: where the
    two gradients' disagreement cannot change the update's sign or size
    past the tolerance). A leaf whose gradient
    is 0 in exact arithmetic (the bias of a conv an instance norm follows)
    has rounding noise for a gradient on both sides, below 1e-5, which
    Adam's step, ``lr * g / (|g| + eps)``, turns into moves of up to lr."""
    one, per_rank = steps[k]
    lr = 2e-3  # write_tiny_config's learning_rate; the mapping's is 100x lower
    for r, got in enumerate(per_rank):
        assert got["flips"] <= MAX_FLIPS, (r, got["flips"])
        assert set(got["metrics"]) == set(one["metrics"])
        for name, want in one["metrics"].items():
            np.testing.assert_allclose(got["metrics"][name], want, **STEP_TOL,
                                       err_msg=f"rank {r}: {name}")
        assert set(got["grads"]) == set(one["grads"]) == set(one["params"])
        held = 0
        for name, want in one["grads"].items():
            g, w = got["grads"][name].numpy(), want.numpy()
            np.testing.assert_allclose(g, w, **STEP_TOL, err_msg=f"rank {r}: grad {name}")
            if np.abs(w).max() < 1e-5:
                assert np.abs(g).max() < 1e-5, name
                continue
            same = chip_smoke.held_mask(torch.from_numpy(g), torch.from_numpy(w),
                                        lr / 100 if name.startswith("m.") else lr,
                                        first=k == 0).numpy()
            held += same.sum()
            np.testing.assert_allclose(got["params"][name].numpy()[same],
                                       one["params"][name].numpy()[same], **STEP_TOL,
                                       err_msg=f"rank {r}: param {name}")
        assert held > 0.9 * sum(p.numel() for p in one["params"].values())
    if k == 0:
        assert one["metrics"]["path_loss"] > 0
    else:
        assert one["metrics"]["path_loss"] == 0


@pytest.mark.parametrize("k", range(STEPS), ids=["path_r1_step", "other_step"])
def test_ranks_stay_bitwise_equal(steps, k):
    _, per_rank = steps[k]
    first = per_rank[0]
    for got in per_rank[1:]:
        for name, want in first["params"].items():
            assert torch.equal(got["params"][name], want), name
        assert all(torch.equal(a, b) for a, b in zip(got["buffer"], first["buffer"],
                                                      strict=True))
        assert all(torch.equal(a, b) for a, b in zip(got["ada"], first["ada"], strict=True))
        assert got["metrics"] == first["metrics"]


# ------------------------------------------------ (b) ranks vs JAX on a mesh


def _jax_step_draws(key, jm, jcfg) -> port_ts.StepDraws:
    """The port's draws of the JAX fused step at the global batch (keys 0-3
    the D phase's, 4-9 the G phase's; ``tests/test_torch_d_phase.py`` and
    ``tests/test_torch_g_phase.py`` at batch ``BATCH``)."""
    keys = jax.random.split(key, 10)
    mixing = jcfg["training"]["style_mixing_prob"]
    lo, hi = jcfg["optimisation"]["path_loss_jacobian_granularity"]
    size = jcfg["training"]["image_buffer_size"]

    def style(k):
        return PortStyleRngs(*(_t(t) for t in sample_style_rngs(
            k, BATCH, jm.w_dim, jm.n_style_blocks, mixing)))

    k1, k2 = jax.random.split(keys[1])
    d = port_ts.DPhaseDraws(
        style=style(keys[0]),
        buffer=port_buffer.BufferDraws(swap=_t(jax.random.uniform(k1, (BATCH,))),
                                       slot=_t(jax.random.randint(k2, (BATCH,), 0, size))),
        aug_fake=jax_augment_draws(keys[2], BATCH), aug_real=jax_augment_draws(keys[3], BATCH))
    g = port_ts.GPhaseDraws(
        theta=_t(jax.random.uniform(keys[4], (BATCH,))),
        fin_diff_h=_t(jax.random.uniform(keys[5], (BATCH,), minval=lo, maxval=hi)),
        latent_noise=None, style=style(keys[7]), aug=jax_augment_draws(keys[8], BATCH),
        path_style=style(keys[9]))
    return port_ts.StepDraws(d=d, g=g)


def _port_ada(p: float) -> PortAdaState:
    return PortAdaState(torch.tensor(p), torch.tensor(0, dtype=torch.int32), torch.tensor(0.0))


def _rank_jax_step(group, path, trees, batches, draws, masks):
    config = load_config(path)
    models = Models(config, device="cpu", seed=9)
    state = init_train_state(config, models, seed=9)
    port_convert.from_jax_params(state, *trees)
    state.ada = _port_ada(ADA_P)
    before = _snapshot(state)
    train_step = port_ts.make_train_step(config, models, group)
    rows = port_ts.Batches(*(group.shard(torch.from_numpy(b)) for b in batches))
    with activations.pin(_slice_masks(masks, group)) as pinned:
        state, metrics = train_step(state, rows, draws)
    assert len(pinned.flips) == len(masks), "the rank ran fewer activations than JAX"
    return {"pmet": metrics, "before": before, "after": _snapshot(state),
            "flips": pinned.n_flips(),
            "grads": {(net, p): _port_leaf(param.grad) for net, p, param in _leaves(state)},
            "d_grads": [p.grad.clone() for p in state.discriminator.parameters()],
            "state": _state_of(state)}


@pytest.fixture(scope="module")
def jax_mesh_step(ranks, config_path):
    """One JAX fused step (path + R1, step 0) under ``make_mesh(4, 1)``
    with its kinks recorded, and the same step on the port's 4 ranks."""
    jcfg = jax_load_config(config_path)
    jm = JaxModels(jcfg)
    img = jnp.zeros((1, SIZE, SIZE, 1))
    params_g = _params(jm.generator.init, img, jnp.zeros((jm.n_style_blocks, 1, jm.w_dim)),
                       seed=0)
    params_d = _params(jm.discriminator.init, img, seed=1)
    params_m = _params(jm.mapping.init, jnp.zeros((1, jm.w_dim)), seed=2)
    params_s = _params(jm.extractor.init, img, seed=3)
    opts = jax_optimizers(jcfg)
    size = jcfg["training"]["image_buffer_size"]
    jstate = TrainState(
        step=jnp.zeros((), jnp.int32), params_g=params_g, params_d=params_d,
        params_m=params_m, params_s=params_s, opt_g=opts["g"].init(params_g),
        opt_d=opts["d"].init(params_d), opt_m=opts["m"].init(params_m),
        opt_s=opts["s"].init(params_s),
        ada=JaxAdaState(jnp.float32(ADA_P), jnp.int32(0), jnp.float32(0.0)),
        buffer=jax_buffer.init_buffer(size, (SIZE, SIZE, 1)), ema_params_g=None,
    )
    mesh = make_mesh(WORLD, 1)
    step = make_train_step(jcfg, jm, mesh)
    sink: dict = {}

    def run(state, batches, key):
        with jax.disable_jit(), _recording_jax_kinks(sink):
            return step(state.replace(step=np.int32(0)), batches, key)

    batches = _batches(60)
    key = jax.random.key(70)
    jstate, jmet = jax.block_until_ready(jax.jit(run, compiler_options=JAX_COMPILE)(
        replicate(mesh, jstate), Batches(*(shard_batch(mesh, b) for b in batches)), key))
    jax.effects_barrier()
    masks = [torch.from_numpy(np.array(m.transpose(0, 3, 1, 2) if m.ndim == 4 else m))
             for _, m in sorted(sink.items())]
    trees = [jax.tree.map(np.asarray, t) for t in (params_g, params_m, params_d, params_s)]
    per_rank = ranks.run(_rank_jax_step, config_path, trees, batches,
                         _jax_step_draws(key, jm, jcfg), masks)
    return jstate, jmet, per_rank


def test_four_ranks_match_jax_under_a_4x1_mesh(jax_mesh_step, config_path):
    jstate, jmet, per_rank = jax_mesh_step
    config = load_config(config_path)
    ps = init_train_state(config, Models(config, device="cpu", seed=9), seed=9)
    jgrads = _jax_grads([{"jstate": jstate}], 0)
    for run in per_rank:
        assert run["flips"] <= MAX_FLIPS, run["flips"]
        _check_metrics(jmet, run["pmet"], 0)
        _check_step({**run, "jstate": jstate}, jgrads, ps, first=True)
        _check_d(run, jgrads, ps)
    for run in per_rank[1:]:
        for name, want in per_rank[0]["state"]["params"].items():
            assert torch.equal(run["state"]["params"][name], want), name


# ------------------------------------------------------------- (c) the KL


def _rank_kl(group, x):
    rows = group.shard(x).clone().requires_grad_(True)
    scale = torch.ones((), requires_grad=True)
    value = kl_loss(rows * scale, group)
    value.backward()
    group.reduce_gradients([[scale]])
    return value.detach(), rows.grad, scale.grad


def test_kl_across_ranks_is_the_global_batch_term(ranks):
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(0.3, 1.4, (2 * BATCH, 8, 4, 4)).astype(np.float32))
    ref = x.clone().requires_grad_(True)
    scale = torch.ones((), requires_grad=True)
    want = kl_loss(ref * scale)
    want.backward()
    for r, (value, row_grad, scale_grad) in enumerate(ranks.run(_rank_kl, x)):
        np.testing.assert_allclose(value.item(), want.item(), rtol=1e-6)
        rows = slice(r * 2 * BATCH // WORLD, (r + 1) * 2 * BATCH // WORLD)
        # this rank's rows' share of the global gradient, times the world
        np.testing.assert_allclose(row_grad.numpy() / WORLD, ref.grad[rows].numpy(),
                                   rtol=1e-5, atol=1e-9)
        # a parameter's gradient after the mean over the ranks
        np.testing.assert_allclose(scale_grad.item(), scale.grad.item(), rtol=1e-5)


# ---------------------------------------------------------- (d) the buffer


def _rank_buffer(group, state, fakes, draws):
    out, new = port_buffer.buffer_apply(state, group.shard(fakes), draws, group)
    return out, new.images, new.count


def test_buffer_across_ranks_is_the_global_buffer_bitwise(ranks):
    rng = np.random.default_rng(4)
    size = 6
    images = torch.from_numpy(rng.normal(size=(size, SIZE, SIZE, 1)).astype(np.float32))
    # three slots filled: the batch first fills, then swaps
    state = port_buffer.BufferState(images, torch.tensor(3, dtype=torch.int32))
    fakes = torch.from_numpy(rng.normal(size=(BATCH, SIZE, SIZE, 1)).astype(np.float32))
    draws = port_buffer.draw_buffer(torch.Generator().manual_seed(5), BATCH, size, "cpu")
    want, want_state = port_buffer.buffer_apply(
        port_buffer.BufferState(images.clone(), state.count), fakes, draws)
    assert int(want_state.count) == size
    swapped = (want != fakes).flatten(1).any(1)
    assert swapped.any() and not swapped.all()
    for r, (out, got_images, count) in enumerate(ranks.run(_rank_buffer, state, fakes, draws)):
        assert torch.equal(out, want[r * 2 : (r + 1) * 2])
        assert torch.equal(got_images, want_state.images) and int(count) == size


# ------------------------------------------------------- (e) the Trainer CLI


def _means(path) -> list[dict]:
    """The logged interval means of ``metrics.jsonl`` (not its FID lines)."""
    import json

    return [m for m in map(json.loads, path.open()) if "fid" not in m]


def test_train_cli_runs_four_ranks_and_one_process_resumes_it(tmp_path):
    for domain, seed in (("shoeprints", 0), ("shoemarks", 9)):
        write_synthetic_dataset_dirs(tmp_path / domain, n_train=16, n_test=2,
                                     image_size=(SIZE, SIZE), seed=seed)
    four = write_tiny_config(tmp_path, batch_size=BATCH,
                             tpu_section="\n[tpu]\ndata_parallel = 4\nkeep_checkpoints = 5\n")
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    proc = subprocess.run([sys.executable, "-m", "one_to_many_gan_torch.train", str(four),
                           "--device", "cpu"], cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=600, check=False)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("Step: ")]
    assert [ln.split(",")[0] for ln in lines] == ["Step: 2/6", "Step: 4/6", "Step: 6/6"]
    run = tmp_path / "checkpoints" / "test_run"
    assert sorted(p.name for p in (run / "models").iterdir()) == ["3.tar", "6.tar"]
    assert len((run / "log").read_text().splitlines()) == 5  # 3 log lines, 2 FID lines
    four_means = _means(run / "metrics.jsonl")
    assert [m["step"] for m in four_means] == [2, 4, 6]

    # one process at the global batch, from the 4 ranks' 3.tar
    (run / "models" / "6.tar").unlink()
    (run / "metrics.jsonl").unlink()
    one = load_config(write_tiny_config(tmp_path, batch_size=BATCH,
                                        tpu_section="\n[tpu]\ndata_parallel = 1\n"))
    from one_to_many_gan_torch.core.trainer import Trainer

    trainer = Trainer(one, device="cpu", verbose=False)
    assert trainer.start_step == 3
    # the one process's FID/KID line of 3.tar is rank 0's
    four_fid = [ln for ln in (run / "log").read_text().splitlines() if " | fid: " in ln]
    trainer.checkpoint(3)
    one_fid = (run / "log").read_text().splitlines()[-1]

    def scores(line):  # "Step 3 | fid: F, kid: K [extractor]"
        return [float(part.split(": ")[1]) for part in line.split(" [")[0].split(", ")]

    assert one_fid.startswith("Step 3 | fid: ") and one_fid.endswith("[random_projection_v1]")
    # the same features; the Frechet distance's matrix square root in
    # float64 is not bitwise across processes
    np.testing.assert_allclose(scores(one_fid), scores(four_fid[0]), rtol=1e-7)
    assert trainer.run().step == 6
    one_means = _means(run / "metrics.jsonl")
    assert [m["step"] for m in one_means] == [4, 6]
    got, want = one_means[1], four_means[2]  # steps 4 and 5 in both (step 4's: 3 alone)
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], **STEP_TOL,
                                   err_msg=f"step {want['step']}: {name}")


def test_train_cli_runs_two_by_two_and_resumes_across_layouts(tmp_path):
    """The CLI at data 2 x spatial 2 (4 gloo ranks, each half the rows of
    its data row's images): 4 steps with checkpoints at 2 and 4. Its 2.tar
    resumed in one process continues to 4 within the step tolerance of the
    2x2 run's logged means; the one process's 4.tar then resumed at 2x2
    continues to 6 within it of the one process's own continuation (one
    card's checkpoint schema both ways)."""
    from one_to_many_gan_torch.core.trainer import Trainer

    for domain, seed in (("shoeprints", 0), ("shoemarks", 9)):
        write_synthetic_dataset_dirs(tmp_path / domain, n_train=16, n_test=2,
                                     image_size=(SIZE, SIZE), seed=seed)
    tpu = "\n[tpu]\nkeep_checkpoints = 5\nr1_gamma = 10.0\nr1_interval = 2\n"
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    run = tmp_path / "checkpoints" / "test_run"

    def config(steps: int, grid: bool):
        section = tpu + ("data_parallel = 2\nspatial_parallel = 2\n" if grid else "")
        return write_tiny_config(tmp_path, batch_size=BATCH, tpu_section=section,
                                 training_steps=steps, checkpoint_interval=2,
                                 n_evaluation_images=4)

    def grid_cli(steps: int) -> dict:
        proc = subprocess.run([sys.executable, "-m", "one_to_many_gan_torch.train",
                               str(config(steps, True)), "--device", "cpu"], cwd=REPO, env=env,
                              capture_output=True, text=True, timeout=600, check=False)
        assert proc.returncode == 0, proc.stdout + proc.stderr
        return _means(run / "metrics.jsonl")[-1]

    def one_process(steps: int) -> dict:
        trainer = Trainer(load_config(config(steps, False)), device="cpu", verbose=False)
        assert trainer.start_step == steps - 2
        assert trainer.run().step == steps
        return _means(run / "metrics.jsonl")[-1]

    def close(got, want):
        assert got["step"] == want["step"] and set(got) == set(want)
        for name in want:
            np.testing.assert_allclose(got[name], want[name], **STEP_TOL,
                                       err_msg=f"step {want['step']}: {name}")

    grid4 = grid_cli(4)
    assert sorted(p.name for p in (run / "models").iterdir()) == ["2.tar", "4.tar"]
    (run / "models" / "4.tar").unlink()
    close(one_process(4), grid4)  # 2x2 -> one process
    one6 = one_process(6)
    (run / "models" / "6.tar").unlink()
    close(grid_cli(6), one6)  # one process -> 2x2


# ----------------------------------------------------------- (f) the config


def test_data_parallel_resolution(tmp_path):
    config = load_config(write_tiny_config(tmp_path, batch_size=BATCH))
    assert config["tpu"]["data_parallel"] == -1
    assert resolve_data_parallel(config, 4) == 4  # -1: every card
    assert distributed.data_parallel_ranks(config, "cpu") == 1  # -1 on the CPU: one
    config["tpu"]["data_parallel"] = 3
    with pytest.warns(UserWarning, match="data_parallel=3 does not divide batch_size=8; "
                                         "clamped to 2"):
        assert resolve_data_parallel(config, 4) == 2
    config["tpu"]["data_parallel"] = 8
    with pytest.raises(ValueError, match="needs 8 devices, have 4"):
        resolve_data_parallel(config, 4)
    config["tpu"]["data_parallel"] = 0
    with pytest.raises(ValueError, match="-1 .* or >= 1"):
        check_training_options(config)
    # the spatial axis, as make_mesh resolves it: 4 x 2 needs 8 cards, -1
    # takes the cards a spatial column leaves, spatial must divide the cards
    config["tpu"].update(data_parallel=4, spatial_parallel=2)
    with pytest.raises(ValueError, match="needs 8 devices, have 4"):
        resolve_data_parallel(config, 4)
    assert resolve_data_parallel(config, 8) == 4
    config["tpu"]["data_parallel"] = -1
    assert resolve_data_parallel(config, 4) == 2
    assert distributed.data_parallel_ranks(config, "cpu") == 2  # one data row x 2
    config["tpu"]["spatial_parallel"] = 3
    with pytest.raises(ValueError, match="spatial_parallel=3 must divide the device count 4"):
        resolve_data_parallel(config, 4)
    # the D phase's CLI runs one process and refuses more by name
    two = write_tiny_config(tmp_path, batch_size=BATCH, tpu_section="\n[tpu]\ndata_parallel = 2\n")
    with pytest.raises(NotImplementedError, match=r"tpu\.data_parallel = 2 is not ported"):
        port_train_d.main([str(two), "--device", "cpu"])


def test_four_card_preset_of_the_production_config(tmp_path):
    src = os.path.join(REPO, "configs", "tpu_v5e8_512.toml")
    config = load_config(src)
    assert card_overrides(config, 4) == {"spatial_parallel": 1}
    assert card_overrides(config, 2) == {"data_parallel": 2, "batch_size": 16,
                                         "spatial_parallel": 1}
    changes = write_card_config(src, tmp_path / "four.toml", cards=4)
    four = load_config(tmp_path / "four.toml")
    assert changes == {"spatial_parallel": 1}
    assert (four["tpu"]["data_parallel"], four["training"]["batch_size"]) == (4, 32)
    assert resolve_data_parallel(four, 4) == 4
    with pytest.raises(ValueError, match="needs 4 devices, have 1"):
        resolve_data_parallel(four, 1)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        write_card_config(src, tmp_path / "one.toml")
    assert load_config(tmp_path / "one.toml")["training"]["batch_size"] == 8
    # keeping the spatial axis: data 2 x spatial 2 at the global batch as written
    assert card_overrides(config, 4, spatial=True) == {"data_parallel": 2}
    assert write_card_config(src, tmp_path / "2x2.toml", cards=4, spatial=True,
                             native_loader=False) == {"data_parallel": 2, "native_loader": False}
    two = load_config(tmp_path / "2x2.toml")
    assert (two["tpu"]["data_parallel"], two["tpu"]["spatial_parallel"],
            two["training"]["batch_size"]) == (2, 2, 32)
    assert resolve_data_parallel(two, 4) == 2
    with pytest.raises(ValueError, match="spatial_parallel=2 must divide the 3 cards"):
        card_overrides(config, 3, spatial=True)


# ---------------------------------------------------------- (g) serving


def test_two_replica_engine_matches_one_engine(tmp_path):
    config = load_config(write_tiny_config(tmp_path))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # no checkpoint: fresh weights
        one = InferenceEngine(config, buckets=(4, 8), device="cpu")
        two = InferenceEngine(config, buckets=(4, 8), device="cpu", data_parallel=2)
    assert two.data_parallel == 2 and len(two.replicas) == 2
    rng = np.random.default_rng(0)
    images = torch.from_numpy(rng.uniform(-1, 1, (2, SIZE, SIZE, 1)).astype(np.float32))
    z = torch.from_numpy(rng.standard_normal((2, 8, 6)).astype(np.float32))
    thetas = torch.tensor([1.0, 0.4])
    want = one._fns[0](images, z, thetas)
    got = torch.cat([fn(images, z, thetas, rows=slice(8 * i, 8 * i + 8))
                     for i, fn in enumerate(two._fns)])
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-6)
    srcs = [rng.integers(0, 256, (SIZE, SIZE, 1), dtype=np.uint8) for _ in range(3)]
    for a, b in zip(one.generate_batch(srcs, [3, 8, 5], [1, 2, 3], [1.0, 0.5, 0.2]),
                    two.generate_batch(srcs, [3, 8, 5], [1, 2, 3], [1.0, 0.5, 0.2]),
                    strict=True):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match=r"data_parallel=4 must divide every n bucket; "
                                         r"offending buckets: \[6\]"):
        InferenceEngine(config, buckets=(4, 6), device="cpu", data_parallel=4)
