"""The port's spatial axis on the CPU: gloo ranks whose images' rows are
split into bands, against one process and against the JAX package's
step under a 2x2 mesh.

Four gloo ranks (processes, one torch thread each) are started once for
the module; each builds two groups over them, data 2 x spatial 2 and
data 1 x spatial 4 (``parallel.make_group``), and runs each test's task
together. The config is ``tests/helpers.write_tiny_config``'s (32x32, 3
resnet blocks) at a global batch of 8, float32, the lazy path term and
R1 (gamma 10) every 2nd step: step 0 is a path + R1 step, step 1 another.
At spatial 4 the discriminator's last maps have 3, 2 and 1 rows, so
some bands hold none.

- the halo exchange and its transpose: ``<fetch(x), y> = <x, fetch^T(y)>``
  summed over the ranks, in float64;
- each model pass banded at spatial 2 and 4 against the whole pass:
  forward and input gradient, at the step tolerance (float32 sums in
  another order);
- the split instance norm's plain version against ``ops/norm.py`` on odd
  and even rows;
- the fused step at 2x2 and 1x4 against one process at batch 8, each
  step from the same state, the one process's kink pattern pinned in the
  ranks (each rank its rows and band of every mask): metrics and
  parameters at the JAX package's tolerances
  (``tests/test_parallel.py:116-133``), gradients at 1e-4 of each leaf's
  largest entry (``tests/test_torch_g_phase.py``); every rank's parameters, buffer
  and ADA bitwise equal; no all-gather moves a feature map (only the
  images ADA warps, the instance norms' partials and the buffer's fakes),
  and no halo piece exceeds 3 rows;
- the D and G phases called apart (the trainer's ``split_phases``) with
  ``remat = "conv"``, ``g_loss_split``, ``ada_supersample`` and EMA, at
  2x2 against one process;
- the JAX fused step under ``make_mesh(2, 2)`` against the port's 2x2
  ranks, held as ``tests/test_torch_parallel.py`` holds its 4x1 mesh.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import chip_smoke
from one_to_many_gan_torch import convert as port_convert
from one_to_many_gan_torch import train as port_train
from one_to_many_gan_torch.config import load_config
from one_to_many_gan_torch.core import train_step as port_ts
from one_to_many_gan_torch.core.state import Models, init_train_state
from one_to_many_gan_torch.migrate import from_reference_checkpoint, to_reference_checkpoint
from one_to_many_gan_torch.ops import activations
from one_to_many_gan_torch.ops.cuda import instance_norm as cuda_in
from one_to_many_gan_torch.ops.norm import instance_norm
from one_to_many_gan_torch.parallel import distributed, halo, make_group
from one_to_many_gan_torch.presets import tiny_config
from one_to_many_gan_tpu.augment import AdaState as JaxAdaState
from one_to_many_gan_tpu.config import load_config as jax_load_config
from one_to_many_gan_tpu.core import buffer as jax_buffer
from one_to_many_gan_tpu.core.state import Models as JaxModels
from one_to_many_gan_tpu.core.state import TrainState
from one_to_many_gan_tpu.core.state import make_optimizers as jax_optimizers
from one_to_many_gan_tpu.core.train_step import Batches, make_train_step
from one_to_many_gan_tpu.parallel import make_mesh, replicate, shard_batch
from tests.helpers import write_tiny_config
from tests.test_torch_d_phase import _params
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
from tests.test_torch_parallel import (
    ADA_P,
    BATCH,
    SIZE,
    STEP_TOL,
    STEPS,
    _batches,
    _dumps,
    _jax_step_draws,
    _loads,
    _port_ada,
    _state_of,
)

WORLD = 4
LAYOUTS = {"2x2": 2, "1x4": 4}  # data x spatial -> spatial ranks
TPU = ("\n[tpu]\npath_interval = 2\nr1_gamma = 10.0\nr1_interval = 2\nada_pallas = true\n"
       "spatial_parallel = 2\n")
HALO_ROWS = 3  # the widest halo: the 7x7 convs' 3 rows


# ------------------------------------------------------------------ ranks


def _rank_loop(rank: int, port: int, tasks, results) -> None:
    """A rank of the pool: join the gloo group and build both layouts'
    groups, then run ``(fn, args)`` tasks until ``None``, each as
    ``fn(groups, *args)``."""
    import traceback

    torch.set_num_threads(1)
    base = distributed.ensure_initialized("cpu", rank=rank, world_size=WORLD,
                                          init_method=f"tcp://127.0.0.1:{port}")
    groups = {s: make_group(torch.device("cpu"), spatial=s) for s in LAYOUTS.values()}
    while (item := tasks.get()) is not None:
        fn, args = _loads(item)
        try:
            results.put((rank, _dumps(("ok", fn(groups, *args)))))
        except Exception:  # noqa: BLE001 — sent to the test, which fails with it
            results.put((rank, _dumps(("error", traceback.format_exc()))))
    for g in (base, *groups.values()):
        g.close()
    dist.destroy_process_group()


class _Ranks:
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
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def config_path(tmp_path_factory):
    return write_tiny_config(tmp_path_factory.mktemp("sp"), tpu_section=TPU, batch_size=BATCH)


def _slice_masks(masks, group) -> list[torch.Tensor]:
    """Each rank's part of a global kink pattern: its data row's rows of
    every mask and, of a feature map's (NCHW), its band of rows."""
    out = []
    for m in masks:
        m = group.shard(m)
        if m.dim() == 4:
            lo, hi = group.spatial.band(m.shape[2])
            m = m[:, :, lo:hi]
        out.append(m)
    return out


class _Gathers:
    """Records the input shape of every all-gather the rank runs."""

    def __enter__(self):
        self.shapes: list[tuple[int, ...]] = []
        self._saved = (dist.all_gather, dist.all_gather_into_tensor)
        gather, into = self._saved

        def all_gather(parts, x, *a, **k):
            self.shapes.append(tuple(x.shape))
            return gather(parts, x, *a, **k)

        def all_gather_into_tensor(out, x, *a, **k):
            self.shapes.append(tuple(x.shape))
            return into(out, x, *a, **k)

        dist.all_gather, dist.all_gather_into_tensor = all_gather, all_gather_into_tensor
        return self

    def __exit__(self, *exc):
        dist.all_gather, dist.all_gather_into_tensor = self._saved


# ------------------------------------------------------- the halo exchange


def _rank_halo(groups, s):
    group = groups[s]
    sp = group.spatial
    rng = np.random.default_rng(7)
    n = 11
    x = torch.from_numpy(rng.normal(size=(2, 3, n, 5)))
    # every rank's rows: a ragged window, one beyond the map, one empty
    needs = [(sp.band(n, t)[0] - 2, sp.band(n, t)[1] + 1 + t) for t in range(s)]
    needs[-1] = (0, 0) if s > 2 else needs[-1]
    lo, hi = sp.band(n)
    with halo.banded(sp):
        xb = x[:, :, lo:hi].clone().requires_grad_(True)
        got = halo.fetch(xb, n, needs)
        a, b = halo._clip(needs[sp.index], n)
        y = torch.from_numpy(rng.normal(size=(2, 3, n, 5)))[:, :, a:b]
        (gx,) = torch.autograd.grad((got * y).sum(), xb)
        lhs = (got * y).sum()
        rhs = (xb * gx).sum()
    return {"values": torch.equal(got, x[:, :, a:b]), "lhs": lhs.item(), "rhs": rhs.item()}


@pytest.mark.parametrize("layout", LAYOUTS)
def test_halo_exchange_is_the_transpose_of_its_backward(ranks, layout):
    out = ranks.run(_rank_halo, LAYOUTS[layout])
    assert all(r["values"] for r in out)
    s = LAYOUTS[layout]
    for row in range(WORLD // s):
        part = out[row * s : (row + 1) * s]
        np.testing.assert_allclose(sum(r["lhs"] for r in part), sum(r["rhs"] for r in part),
                                   rtol=1e-12)


# ------------------------------------------------------ banded model passes


def _pass(models, state, name):
    w = torch.from_numpy(np.random.default_rng(2).normal(
        size=(models.n_style_blocks, 2, models.w_dim)).astype(np.float32))
    return {"G": lambda x, h: state.generator(x, w),
            "D": lambda x, h: state.discriminator(x, h),
            "S": lambda x, h: state.extractor(x, h)}[name]


def _rank_pass(groups, s, name, out_shape):
    sp = groups[s].spatial
    config = tiny_config((SIZE, SIZE), 2, min_latent=8, n_resnet_blocks=3)
    models = Models(config, device="cpu", seed=0)
    state = init_train_state(config, models, seed=0)
    fn = _pass(models, state, name)
    x = torch.from_numpy(np.random.default_rng(1).uniform(-1, 1, (2, 1, SIZE, SIZE))
                         .astype(np.float32))
    lo, hi = sp.band(SIZE)
    with halo.banded(sp), _Gathers() as gathers:
        xb = x[:, :, lo:hi].clone().requires_grad_(True)
        y = fn(xb, SIZE)
        cot = torch.from_numpy(np.random.default_rng(3).normal(size=out_shape).astype(np.float32))
        if y.dim() == 4:
            loss = halo.all_reduce((y * halo.take_band(cot)).sum())
        else:
            loss = (y * cot).sum()
        (gx,) = torch.autograd.grad(halo.share(loss), xb)
    return {"y": y.detach(), "gx": gx, "band": (lo, hi), "gathers": gathers.shapes}


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("name", ["G", "D", "S"])
def test_banded_model_pass_matches_the_whole_pass(ranks, name, layout):
    s = LAYOUTS[layout]
    config = tiny_config((SIZE, SIZE), 2, min_latent=8, n_resnet_blocks=3)
    models = Models(config, device="cpu", seed=0)
    state = init_train_state(config, models, seed=0)
    x = torch.from_numpy(np.random.default_rng(1).uniform(-1, 1, (2, 1, SIZE, SIZE))
                         .astype(np.float32)).requires_grad_(True)
    y = _pass(models, state, name)(x, None)
    cot = torch.from_numpy(np.random.default_rng(3).normal(size=y.shape).astype(np.float32))
    out = ranks.run(_rank_pass, s, name, tuple(y.shape))
    for r, got in enumerate(out):
        a, b = halo.band(y.shape[2], s, r % s) if y.dim() == 4 else (0, None)
        want = y[:, :, a:b] if y.dim() == 4 else y
        np.testing.assert_allclose(got["y"].numpy(), want.detach().numpy(), **STEP_TOL,
                                   err_msg=f"rank {r} forward")
        # only the instance norms' partials are gathered
        assert all(len(shape) == 2 and shape[-1] == 2 for shape in got["gathers"]), got["gathers"]
    (gx,) = torch.autograd.grad((y * cot).sum(), x)
    for r, got in enumerate(out):
        lo, hi = got["band"]
        np.testing.assert_allclose(got["gx"].numpy(), gx[:, :, lo:hi].numpy(), **STEP_TOL,
                                   err_msg=f"rank {r} input gradient")


# -------------------------------------------------- split instance norm


@pytest.mark.parametrize("rows", [13, 16], ids=["odd", "even"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_split_instance_norm_plain_matches_the_whole_plane(rows, dtype):
    """The bands' partials, combined in band order, normalise each band as
    ``ops/norm.py::instance_norm`` normalises the plane, at IN's tolerances
    (2e-5 float32, 0.05 bfloat16); spatial 5 leaves empty-free ragged bands
    of 2 and 3 rows, spatial 16 some empty ones at 13 rows."""
    rng = np.random.default_rng(rows)
    x = torch.from_numpy(rng.normal(0.7, 2.0, (2, 3, rows, 9)).astype(np.float32)).to(dtype)
    want = instance_norm(x)
    tol = 2e-5 if dtype == torch.float32 else 0.05
    for s in (2, 5, 16):
        bands = [halo.band(rows, s, t) for t in range(s)]
        gathered = torch.stack([cuda_in.partials_plain(x[:, :, lo:hi].contiguous())
                                for lo, hi in bands])
        assert gathered.shape == (s, 7, 2)
        got = torch.cat([cuda_in.apply_plain(x[:, :, lo:hi], gathered) for lo, hi in bands], 2)
        np.testing.assert_allclose(got.float().numpy(), want.float().numpy(), rtol=tol, atol=tol)
        relu = torch.cat([cuda_in.apply_plain(x[:, :, lo:hi], gathered, relu=True)
                          for lo, hi in bands], 2)
        assert torch.equal(relu, torch.relu(got))


# ------------------------------------------ fused steps against one process


def _rank_step(groups, s, path, ckpt, k, batches, draws, masks, options):
    group = groups[s]
    config = load_config(path)
    config["tpu"].update(options)
    models = Models(config, device="cpu", seed=0)
    state = from_reference_checkpoint(ckpt, init_train_state(config, models, seed=0), step=k)
    rows = port_ts.Batches(*(group.shard(torch.from_numpy(b)) for b in batches))
    group.spatial.log = []
    with activations.pin(_slice_masks(masks, group)) as pinned, _Gathers() as gathers:
        if options.get("split_phases"):
            d_phase = port_ts.make_d_phase(config, models, group)
            g_phase = port_ts.make_g_phase(config, models, group)
            d = port_ts.shard_draws(draws, group)
            p_used = state.ada.p
            state, d_metrics = d_phase(state, rows.d_shoeprints, rows.d_shoemarks, d.d)
            state, g_metrics = g_phase(state, rows, d.g, p_used)
            metrics = {**d_metrics, **g_metrics}
        else:
            state, metrics = port_ts.make_train_step(config, models, group)(state, rows, draws)
    assert len(pinned.flips) == len(masks), "the rank ran fewer activations than one process"
    halo_rows = max(shape[2] for kind, shape, _ in group.spatial.log if kind.startswith("halo"))
    return {"metrics": {k: v.item() for k, v in metrics.items()}, "flips": pinned.n_flips(),
            "gathers": gathers.shapes, "halo_rows": halo_rows, **_state_of(state)}


def _one_process(config, models, state, k):
    batches = _batches(40 + k)
    draws = port_ts.draw_step(torch.Generator().manual_seed(50 + k), config, models)
    train_step = port_ts.make_train_step(config, models)
    with activations.record() as pattern:
        state, metrics = train_step(state, port_ts.Batches(*map(torch.from_numpy, batches)),
                                    draws)
    return state, batches, draws, pattern.masks, {
        "metrics": {k: v.item() for k, v in metrics.items()}, **_state_of(state)}


def _runs(ranks, config_path, layouts, options, steps):
    config = load_config(config_path)
    config["tpu"].update(options)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        models, state, _ = port_train.setup(config, seed=0, ada_p=ADA_P, device="cpu")
    runs = []
    for k in range(steps):
        ckpt = to_reference_checkpoint(state)
        state, batches, draws, masks, one = _one_process(config, models, state, k)
        per_layout = {name: ranks.run(_rank_step, LAYOUTS[name], config_path, ckpt, k, batches,
                                      draws, masks, options) for name in layouts}
        runs.append((one, per_layout))
    return runs


@pytest.fixture(scope="module")
def steps(ranks, config_path):
    """``STEPS`` fused steps of one process at batch 8 and of the 4 ranks in
    both layouts, each from the one process's state before it."""
    return _runs(ranks, config_path, LAYOUTS, {}, STEPS)


def _check_against_one(one, per_rank, k, lr=2e-3):
    """Metrics at the step tolerance; each gradient within 1e-4 of its
    leaf's largest entry (``tests/test_torch_g_phase.py``'s hold: the bands
    sum each leaf's gradient in another order); every parameter at rtol
    1e-3 / atol 2.5 lr (``tests/test_parallel.py:116-133``), and at the
    step tolerance wherever Adam must move it alike (``held_mask``)."""
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
            step_lr = lr / 100 if name.startswith("m.") else lr
            np.testing.assert_allclose(got["params"][name].numpy(), one["params"][name].numpy(),
                                       rtol=1e-3, atol=2.5 * step_lr,
                                       err_msg=f"rank {r}: param {name}")
            if np.abs(w).max() < 1e-5:  # 0 in exact arithmetic: rounding noise
                assert np.abs(g).max() < 1e-5, name
                continue
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-4 * np.abs(w).max(),
                                       err_msg=f"rank {r}: grad {name}")
            same = chip_smoke.held_mask(torch.from_numpy(g), torch.from_numpy(w), step_lr,
                                        first=k == 0).numpy()
            held += same.sum()
            np.testing.assert_allclose(got["params"][name].numpy()[same],
                                       one["params"][name].numpy()[same], **STEP_TOL,
                                       err_msg=f"rank {r}: param {name}")
        assert held > 0.9 * sum(p.numel() for p in one["params"].values())


CASES = [(layout, k) for layout in LAYOUTS for k in range(STEPS)]
IDS = [f"{layout}-{'path_r1_step' if k == 0 else 'other_step'}" for layout, k in CASES]


@pytest.mark.parametrize(("layout", "k"), CASES, ids=IDS)
def test_spatial_ranks_match_one_process(steps, layout, k):
    one, per_layout = steps[k]
    _check_against_one(one, per_layout[layout], k)
    assert (one["metrics"]["path_loss"] > 0) == (k == 0)


@pytest.mark.parametrize(("layout", "k"), CASES, ids=IDS)
def test_spatial_ranks_stay_bitwise_equal_and_gather_no_feature_map(steps, layout, k):
    _, per_layout = steps[k]
    per_rank = per_layout[layout]
    first = per_rank[0]
    for got in per_rank[1:]:
        for name, want in first["params"].items():
            assert torch.equal(got["params"][name], want), name
        assert all(torch.equal(a, b) for a, b in zip(got["buffer"], first["buffer"],
                                                      strict=True))
        assert all(torch.equal(a, b) for a, b in zip(got["ada"], first["ada"], strict=True))
        assert got["metrics"] == first["metrics"]
    for got in per_rank:
        # an instance norm's partials [planes + 1, 2], or images (one channel):
        # the fakes and translations ADA warps, the buffer's fakes
        for shape in got["gathers"]:
            assert (len(shape) == 2 and shape[1] == 2) or (
                len(shape) == 4 and 1 in (shape[1], shape[3])), shape
        assert 0 < got["halo_rows"] <= HALO_ROWS


def test_split_phases_with_remat_g_loss_split_supersample_and_ema_match_one_process(
        ranks, config_path):
    options = {"split_phases": True, "remat": "conv", "g_loss_split": True,
               "ada_supersample": True, "ema_decay": 0.9}
    ((one, per_layout),) = _runs(ranks, config_path, ["2x2"], options, 1)
    _check_against_one(one, per_layout["2x2"], 0)
    assert one["metrics"]["path_loss"] > 0


# ------------------------------------------------------ JAX under a 2x2 mesh


def _rank_jax_step(groups, path, trees, batches, draws, masks):
    group = groups[2]
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


def test_spatial_ranks_match_jax_under_a_2x2_mesh(ranks, config_path):
    """One JAX fused step (path + R1, step 0) under ``make_mesh(2, 2)``,
    its images sharded ``P("data", "spatial")``, with its kinks recorded,
    and the same step on the port's 2x2 ranks."""
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
    mesh = make_mesh(2, 2)
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
    config = load_config(config_path)
    ps = init_train_state(config, Models(config, device="cpu", seed=9), seed=9)
    jgrads = _jax_grads([{"jstate": jstate}], 0)
    for run_ in per_rank:
        assert run_["flips"] <= MAX_FLIPS, run_["flips"]
        _check_metrics(jmet, run_["pmet"], 0)
        _check_step({**run_, "jstate": jstate}, jgrads, ps, first=True)
        _check_d(run_, jgrads, ps)
    for run_ in per_rank[1:]:
        for name, want in per_rank[0]["state"]["params"].items():
            assert torch.equal(run_["state"]["params"][name], want), name
