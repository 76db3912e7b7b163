"""Data-parallel training: the port's ``Trainer`` on every card of the cell.

Set-up: the program's config is written from the configuration file
(the run's own directories, ``training.random_seed`` the run's seed);
the ranks start by the port's own launcher (``parallel.distributed.spawn``,
one process a card); each makes the synthetic prints and marks and the
weights from the seed on its card, builds ``Trainer(config, group=...)``
on them, loads the weights into the generator, mapping network,
discriminator, extractor and EMA generator, and sets ADA's probability
to ``ada_p`` (``init_ada_state(device, p=ada_p)``, as the CLI's
``setup(ada_p=)`` does). ``trainer.run(max_steps=warmup_steps)`` then
trains the first steps, which build every kernel and plan the window
uses (an R1 step and two path steps among them): the steps the
reference follows are its first ``check_steps``, through the same
``train_step`` call and feed as the window's.

The window: ``trainer.run(max_steps=N)`` from there, ``N`` the multiple
of ``period_steps`` that ``--seconds`` over the warm-up's step time holds,
at least ``min_periods`` periods, so that R1 and the path term keep
their ratio. A wrapper of the Trainer's ``train_step`` on every rank
opens the window at the first timed call after a device synchronise and
closes it after the N-th call and a synchronise, on rank 0's clock: the
window holds training steps only. ``train_images_per_s`` is ``N *
batch_size`` over it. The pause's model-only checkpoint that ``run()``
writes when it stops off the cadence is skipped (``save_checkpoint``
made a no-op for the run): it would write the whole state twice a run.
With ``--trace 1`` every rank records ``torch.profiler`` over the
window's ``trace_period``-th period of ``period_steps`` steps; rank 0's
trace is the run's (the readers' and the breakdown's), and the busy time
is the ranks' mean.

The check: the wrapper records, at the first ``check_steps`` calls, the
rows each rank was fed (matched to the dataset's images, flipped or not:
the feed is checked to hand out the benchmark's images), each rank's R1
term (the one ``r1_loss_and_grad`` returns, on its own rows) and, on
rank 0, the step's draws (the global batch's, which every rank takes),
its losses, the first gradient of every leaf as each Adam took it (from
its first moment after one step) and each leaf's change over the steps.
After the window every rank's parameters and Adam moments are compared
with rank 0's, and every rank lists the JAX modules it has loaded (a run
in which any rank has one is refused, as ``run.py`` refuses its own
process). Then the ranks end, and on the first card the plain float32
reference (``reference/otm_train.py``, TF32 off) trains the same steps
from the same weights on the same rows and draws; ``checks`` holds
each number compared beside its limit (``limits/<workload>.json``). The
draws are the program's, taken as inputs like the rows: the reference
checks what the step computes from them, not how they were drawn.
"""

from __future__ import annotations

import gc
import hashlib
import json
import os
import statistics
import sys
import time
from pathlib import Path
from types import ModuleType, SimpleNamespace

import numpy as np
import torch

from benchmark import harness, synth, synth_train, train_trace
from benchmark.drivers.serve_closed_loop import _profiler
from benchmark.reference import otm_train

LOSSES = ("disc_loss", "total_gen_loss")
TERMS = ("disc_loss", "total_gen_loss", "gan_loss", "reconstruction_loss", "identity_loss",
         "kl_loss", "style_loss", "path_loss")
NETS = {"g": "generator", "m": "mapping", "d": "discriminator", "s": "extractor"}
OPTS = {"g": "opt_g", "m": "opt_m", "d": "opt_d", "s": "opt_s"}


def make_weights(config: dict, seed: int, device) -> dict[str, dict[str, torch.Tensor]]:
    """Per network (``g``, ``m``, ``d``, ``s``), its weights from ``seed``,
    drawn on ``device`` in one call."""
    return otm_train.init_weights(synth.normals(otm_train.shapes(config), seed, device))


def dataset(config: dict, traffic: dict, seed: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """The run's prints and marks, uint8 [N, H, W, C] on ``device``."""
    h, w = config["data"]["image_size"]
    c = config["data"]["image_channels"]
    n = traffic["dataset_images"]
    return (synth_train.images(seed, 0, n, h, w, c, device),
            synth_train.images(seed, 1, n, h, w, c, device))


def _digest(image: np.ndarray) -> bytes:
    return hashlib.blake2b(np.ascontiguousarray(image).tobytes(), digest_size=16).digest()


class RowIndex:
    """Where a fed image came from: (index, flipped) in a uint8 dataset
    [N, H, W, C], its horizontal flip included."""

    def __init__(self, images: np.ndarray):
        self.table = {}
        for i, img in enumerate(images):
            self.table.setdefault(_digest(img[:, ::-1]), (i, True))
            self.table[_digest(img)] = (i, False)

    def find(self, batch: torch.Tensor) -> list[list[int]]:
        """[[index, flipped]] of each row of an NHWC batch in [-1, 1]
        (index -1 where the row is none of the dataset's images)."""
        u8 = ((batch.detach().float() + 1.0) * 127.5).round().clamp(0, 255).to(torch.uint8)
        return [list(self.table.get(_digest(row), (-1, False))) for row in u8.cpu().numpy()]


def tree(x):
    """A step's draws (NamedTuples of tensors) as nested dicts of host
    tensors."""
    if hasattr(x, "_asdict"):
        return {k: tree(v) for k, v in x._asdict().items()}
    return x.detach().cpu().clone() if torch.is_tensor(x) else x


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Step:
    """The wrapper of a Trainer's ``train_step`` (module docstring): the
    check's records at the first ``check_steps`` calls, the warm-up's step
    time, the window's bounds and the traced period. ``inner`` is the step
    it calls (the program's, or a fault planted under it)."""

    def __init__(self, trainer, spec: dict, prints: RowIndex, marks: RowIndex):
        self.trainer, self.spec = trainer, spec
        self.device = trainer.device
        self.main = trainer.main
        self.index = {"d_shoeprints": prints, "d_shoemarks": marks,
                      "g_shoeprints": prints, "g_shoemarks": marks}
        self.inner = trainer.train_step
        trainer.train_step = self
        self.calls = 0
        self.rows, self.draws, self.losses = [], [], []
        self.r1 = {}  # check step -> this rank's R1 term
        self.grads = self.changes = None
        self.start = None
        self.t_warm = None
        self.window = None  # (first call, calls)
        self.t_open = self.t_close = None
        self.prof = self.period = None
        self.traced = None  # (first call, calls)

    def watch_r1(self) -> None:
        """Record the R1 term of each check step that computes one, as
        ``r1_loss_and_grad`` (the one in place, a planted fault's
        included) returns it; ``undo`` takes the wrapper out again."""
        from one_to_many_gan_torch.core import train_step as ts

        inner = ts.r1_loss_and_grad

        def r1_loss_and_grad(*args, **kwargs):
            term = inner(*args, **kwargs)
            if self.calls < self.spec["check_steps"]:
                self.r1[self.calls] = float(term)
            return term

        ts.r1_loss_and_grad = r1_loss_and_grad

    def _snapshot(self) -> dict:
        st = self.trainer.state
        return {k: {n: p.detach().clone() for n, p in getattr(st, NETS[k]).named_parameters()}
                for k in NETS}

    def _records_after(self, i: int, metrics: dict) -> None:
        st = self.trainer.state
        self.losses.append({k: float(metrics[k]) for k in TERMS})
        if i == 0:
            self.grads = {}
            for k, attr in NETS.items():
                opt = getattr(st, OPTS[k])
                b1 = opt.param_groups[0]["betas"][0]
                moments = {n: opt.state.get(p, {}).get("exp_avg")
                           for n, p in getattr(st, attr).named_parameters()}
                self.grads[k] = {n: 0.0 if m is None else
                                 float(torch.linalg.vector_norm(m) / (1.0 - b1))
                                 for n, m in moments.items()}
        if i == self.spec["check_steps"] - 1:
            self.changes = {}
            for k in (*NETS, "ema"):
                module = st.ema_generator if k == "ema" else getattr(st, NETS[k])
                ref = self.start["g" if k == "ema" else k]
                self.changes[k] = {n: float(torch.linalg.vector_norm(p.detach() - ref[n]))
                                   for n, p in module.named_parameters()}
            self.start = None

    def __call__(self, state, batches, draws):
        i = self.calls
        check = i < self.spec["check_steps"]
        if check:
            self.rows.append({k: self.index[k].find(getattr(batches, k)) for k in self.index})
            if self.main:
                self.draws.append(tree(draws))
                if i == 0:
                    self.start = self._snapshot()
        if i == self.spec["time_from"]:
            _sync(self.device)
            self.t_warm = time.perf_counter()
        if self.window is not None and i == self.window[0]:
            _sync(self.device)
            self.t_open = time.perf_counter()
        if self.traced is not None and i == self.traced[0]:
            _sync(self.device)
            self.prof = _profiler(self.device)
            self.prof.start()
            self.period = torch.profiler.record_function(train_trace.PERIOD)
            self.period.__enter__()
        state, metrics = self.inner(state, batches, draws)
        if check and self.main:
            self._records_after(i, metrics)
        if self.traced is not None and i == sum(self.traced) - 1:
            _sync(self.device)
            self.period.__exit__(None, None, None)
            self.prof.stop()
        if self.window is not None and i == sum(self.window) - 1:
            _sync(self.device)
            self.t_close = time.perf_counter()
        self.calls += 1
        return state, metrics


# ------------------------------------------------------------ faults


def _exchange_left_out(trainer) -> None:
    """Every rank keeps its own gradients: no all-reduce."""
    trainer.group.reduce_gradients = lambda groups, metrics=(): [m.float() for m in metrics]


def _half_of_batch(step):
    """Each rank's second half of rows replaced by its first half."""

    def inner(state, batches, draws):
        half = batches.d_shoeprints.shape[0] // 2
        cut = type(batches)(*(torch.cat([x[:half], x[:half]]) for x in batches))
        return step(state, cut, draws)

    return inner


def _state_unchanged(trainer, step):
    """The step computed, then the whole state restored: parameters, Adam
    moments, EMA, ADA, the replay buffer and the step count."""

    def tensors(st):
        mods = [st.generator, st.mapping, st.discriminator, st.extractor, st.ema_generator]
        out = [p for m in mods for p in m.parameters()]
        for opt in (st.opt_d, st.opt_g, st.opt_m, st.opt_s):
            out += [v for s in opt.state.values() for v in s.values() if torch.is_tensor(v)]
        return [*out, st.buffer.images, st.buffer.count]

    def inner(state, batches, draws):
        opts = (state.opt_d, state.opt_g, state.opt_m, state.opt_s)
        fresh = [not o.state for o in opts]
        before = [t.detach().clone() for t in tensors(state)]
        step_count, ada, buffer = state.step, state.ada, state.buffer
        state, metrics = step(state, batches, draws)
        for o, empty in zip(opts, fresh, strict=True):
            if empty:
                o.state.clear()
        state.buffer = buffer
        with torch.no_grad():
            for t, b in zip(tensors(state), before, strict=True):
                t.copy_(b)
        state.step, state.ada = step_count, ada
        return state, metrics

    return inner


JAX_PACKAGE = "one_to_many_gan_tpu"


def plant(fault: str | None, trainer, step):
    """-> (the step with ``fault`` planted under it, a function that takes
    the fault's patches of the program's modules out again)."""
    from one_to_many_gan_torch.core import train_step as ts

    originals = {"r1_loss_and_grad": ts.r1_loss_and_grad, "augment": ts.augment,
                 "path_loss": ts.path_loss}
    loaded = set(sys.modules)

    def undo():
        for name, fn in originals.items():
            setattr(ts, name, fn)
        if trainer.group is not None:  # the exchange's patch of the (lasting) group
            trainer.group.__dict__.pop("reduce_gradients", None)
        if fault == "jax_loaded" and JAX_PACKAGE not in loaded:
            sys.modules.pop(JAX_PACKAGE, None)

    if fault in (None, "control"):
        return step, undo
    if fault == "exchange":
        _exchange_left_out(trainer)
        return step, undo
    if fault == "half":
        return _half_of_batch(step), undo
    if fault == "unchanged":
        return _state_unchanged(trainer, step), undo
    if fault == "feed":
        unpack = trainer._unpack_group
        trainer._unpack_group = lambda group: [
            type(b)(*(x.clamp(-0.99, 0.99) for x in b)) for b in unpack(group)]
        return step, undo
    if fault == "r1":
        ts.r1_loss_and_grad = lambda d, x, gamma, h=None: torch.zeros((), device=x.device)
        return step, undo
    if fault == "path":
        path_loss = originals["path_loss"]
        ts.path_loss = lambda f1, f2, h: 0.0 * path_loss(f1, f2, h)
        return step, undo
    if fault == "jax_loaded":
        sys.modules.setdefault(JAX_PACKAGE, ModuleType(JAX_PACKAGE))
        return step, undo
    if fault == "p0":
        augment = originals["augment"]
        ts.augment = lambda x, p, draws, **kw: augment(x, torch.zeros_like(torch.as_tensor(p)),
                                                       draws, **kw)
        return step, undo
    msg = f"unknown fault {fault!r}"
    raise ValueError(msg)


# ------------------------------------------------------------ the ranks


def build(group, spec: dict):
    """One rank's Trainer on the run's data and weights -> (trainer,
    wrapper); ``wrapper.undo()`` takes a planted fault out again."""
    from one_to_many_gan_torch.augment.controller import init_ada_state
    from one_to_many_gan_torch.config import load_config
    from one_to_many_gan_torch.core.trainer import Trainer

    laps = {"rank_start": time.perf_counter()}
    config = load_config(spec["config_path"])
    device = group.device
    prints, marks = dataset(config, spec["traffic"], spec["seed"], device)
    prints, marks = prints.cpu().numpy(), marks.cpu().numpy()
    laps["data"] = time.perf_counter()
    trainer = Trainer(config, shoeprint_images=prints, shoemark_images=marks, verbose=False,
                      group=group)
    laps["trainer"] = time.perf_counter()
    st = trainer.state
    weights = make_weights(config, spec["seed"], device)
    for k, attr in NETS.items():
        getattr(st, attr).load_state_dict(weights[k])
    st.ema_generator.load_state_dict(weights["g"])
    st.ada = init_ada_state(device, p=spec["traffic"]["ada_p"])
    del weights
    laps["weights"] = time.perf_counter()
    step = Step(trainer, spec, RowIndex(prints), RowIndex(marks))
    step.inner, step.undo = plant(spec.get("fault"), trainer, step.inner)
    step.watch_r1()
    laps["index"] = time.perf_counter()
    step.laps = laps
    return trainer, step


@torch.no_grad()
def ranks_max_abs_diff(trainer) -> float:
    """The largest absolute difference of any parameter or Adam moment
    from rank 0's, over every rank (the same on each)."""
    import torch.distributed as dist

    st = trainer.state
    mods = [st.generator, st.mapping, st.discriminator, st.extractor, st.ema_generator]
    tensors = [p for m in mods for p in m.parameters()]
    for opt in (st.opt_d, st.opt_g, st.opt_m, st.opt_s):
        tensors += [s[k] for s in opt.state.values() for k in ("exp_avg", "exp_avg_sq")]
    worst = torch.zeros((), dtype=torch.float64, device=trainer.device)
    for t in tensors:
        ref = t.detach().clone()
        dist.broadcast(ref, 0)
        worst = torch.maximum(worst, (t.detach() - ref).abs().max().double())
    dist.all_reduce(worst, op=dist.ReduceOp.MAX)
    return float(worst)


def _no_pause_save():
    from one_to_many_gan_torch.core import trainer as trainer_module

    trainer_module.save_checkpoint = lambda *args, **kwargs: None


def rank_main(group, spec: dict) -> None:
    """One rank of a benchmark run: set-up, the warm-up, the window, the
    records; writes ``rank<r>.pt`` into the run's directory."""
    torch.backends.cudnn.benchmark = False
    run_dir = Path(spec["run_dir"])
    traffic = spec["traffic"]
    trainer, step = build(group, spec)
    device = trainer.device
    _no_pause_save()
    if spec["trace"]:
        with _profiler(device):
            torch.ones(8, device=device).sum().item()
    trainer.run(max_steps=traffic["warmup_steps"])
    _sync(device)
    step.laps["warmup"] = time.perf_counter()
    per_step = (time.perf_counter() - step.t_warm) / (traffic["warmup_steps"]
                                                       - spec["time_from"])
    period = traffic["period_steps"]
    n = max(traffic["min_periods"], int(spec["seconds"] / per_step / period)) * period
    n = group.gather_int(n)[0]
    first = traffic["warmup_steps"]
    step.window = (first, n)
    if spec["trace"]:
        step.traced = (first + traffic["trace_period"] * period, period)
    trainer.start_step = trainer.state.step  # the loop's steps and draws go on from there
    trainer.run(max_steps=n)
    _sync(device)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    out = {"rank": group.rank, "rows": step.rows, "r1": step.r1, "peak": peak,
           "ranks_max_abs_diff": ranks_max_abs_diff(trainer),
           "forbidden": harness.forbidden_modules()}
    if step.prof is not None:
        path = run_dir / f"trace{group.rank}.json"
        step.prof.export_chrome_trace(str(path))
        step.prof = None
        tr = train_trace.TrainTrace.load(path)
        tr.bound_to_period()
        out["busy_s"], out["window_s"] = tr.busy_s(), tr.window_s
        if group.rank != 0:
            path.unlink()
        else:
            out["trace"] = str(path)
    if trainer.main:
        out |= {"draws": step.draws, "losses": step.losses, "grads": step.grads,
                "changes": step.changes, "steps": n, "per_step_warm": per_step,
                "laps": step.laps,
                "t_open": step.t_open, "t_close": step.t_close}
    del trainer, step
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    torch.save(out, run_dir / f"rank{group.rank}.pt")


# ------------------------------------------------------------ the check


def global_batches(ranks: list[dict], prints: torch.Tensor, marks: torch.Tensor,
                   steps: int) -> tuple[list[dict], int]:
    """The check steps' global batches (NHWC float32 in [-1, 1], rank 0's
    rows first) from the dataset by the rows each rank was fed; ->
    (batches, rows matched to no dataset image)."""
    data = {"d_shoeprints": prints, "d_shoemarks": marks,
            "g_shoeprints": prints, "g_shoemarks": marks}
    out, unmatched = [], 0
    for i in range(steps):
        batch = {}
        for k, images in data.items():
            rows = [r for rank in ranks for r in rank["rows"][i][k]]
            unmatched += sum(idx < 0 for idx, _ in rows)
            picked = []
            for idx, flipped in rows:
                img = images[max(idx, 0)]
                picked.append(img.flip(1) if flipped else img)
            batch[k] = torch.stack(picked).float() / 127.5 - 1.0
        out.append(batch)
    return out, unmatched


def _draws_to(draws, device):
    if isinstance(draws, dict):
        return {k: v if k == "buffer" else _draws_to(v, device) for k, v in draws.items()}
    return draws.to(device) if torch.is_tensor(draws) else draws


def reference_run(config: dict, traffic: dict, seed: int, rank0: dict, batches: list[dict],
                  device, precision: str = "float32"):
    """The reference's steps on the run's weights, rows and draws."""
    draws = [_draws_to(d, device) for d in rank0["draws"]]
    return otm_train.run_steps(config, make_weights(config, seed, device), batches, draws,
                               ada_p=traffic["ada_p"], rows=traffic["reference_rows"],
                               device=device, precision=precision)


def _worst(program: dict, reference: dict, keep=None) -> tuple[float, str]:
    """The worst leaf's gap of norms, ``|a - b| / max(b, median b)`` per
    network, over the leaves ``keep`` accepts; -> (gap, leaf)."""
    worst, where = 0.0, ""
    for k, ref in reference.items():
        leaves = [n for n in ref if keep is None or keep(k, n)]
        if not leaves:
            continue
        med = statistics.median(ref[n] for n in leaves)
        for n in leaves:
            gap = abs(program[k][n] - ref[n]) / max(ref[n], med, 1e-30)
            if gap > worst:
                worst, where = gap, f"{k}.{n}"
    return worst, where


def compare(program, reference) -> dict:
    """The program's records against the reference's (``losses``, with
    ``r1`` among them, ``grads``, ``changes``); -> every reading:
    ``loss0_max_rel_err`` (the first step's D and G losses, R1 and the
    path term in them), ``loss_max_rel_err`` (over every check step),
    ``r1_rel_err`` and ``path_rel_err`` (the R1 term and the raw path
    term: the largest gap over the check steps, over the reference's
    largest term, so that a term left out, or made on a step the
    reference makes none, reads about 1), ``grad_norm_gap`` (the worst
    leaf's gap of first-gradient norms), ``change_norm_gap`` (the worst
    leaf's gap of change norms over the leaves whose reference gradient
    is at least a thousandth of its network's median leaf's), with the
    worst leaves and every step's loss terms' relative errors."""
    def rel(i, k):
        ref = reference.losses[i][k]
        return abs(program.losses[i][k] - ref) / max(abs(ref), 1e-12)

    def term_gap(k):
        pairs = [(p[k], r[k]) for p, r in zip(program.losses, reference.losses, strict=True)]
        top = max(abs(r) for _, r in pairs)
        return max(abs(a - b) for a, b in pairs) / max(top, 1e-30)

    steps = range(len(reference.losses))
    med = {k: statistics.median(v.values()) for k, v in reference.grads.items()}

    def moving(k, n):
        net = "g" if k == "ema" else k
        return reference.grads[net][n] >= 1e-3 * med[net]

    grad, grad_leaf = _worst(program.grads, reference.grads)
    change, change_leaf = _worst(program.changes, reference.changes, moving)
    return {
        "loss0_max_rel_err": max(rel(0, k) for k in LOSSES),
        "loss_max_rel_err": max(rel(i, k) for i in steps for k in LOSSES),
        "r1_rel_err": term_gap("r1"),
        "path_rel_err": term_gap("path_loss"),
        "grad_norm_gap": grad,
        "change_norm_gap": change,
        "grad_worst_leaf": grad_leaf,
        "change_worst_leaf": change_leaf,
        "terms_rel_err": [{k: rel(i, k) for k in TERMS} for i in steps],
        "excluded_leaves": sorted(f"{k}.{n}" for k in reference.changes
                                  for n in reference.changes[k] if not moving(k, n)),
    }


def _same(a, b) -> bool:
    """Equal nested dicts, lists and tensors (values and dtypes)."""
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, list | tuple):
        return (isinstance(b, list | tuple) and len(a) == len(b)
                and all(_same(x, y) for x, y in zip(a, b, strict=True)))
    if torch.is_tensor(a):
        return (torch.is_tensor(b) and a.dtype == b.dtype and a.shape == b.shape
                and torch.equal(a.cpu(), b.cpu()))
    return a == b


def program_records(ranks: list[dict]) -> SimpleNamespace:
    """Rank 0's records, its losses with the global R1 term of each check
    step (the ranks' mean: each rank's term is over its own rows; 0 where
    a rank made none)."""
    program = SimpleNamespace(**ranks[0])
    program.losses = [{**loss, "r1": statistics.fmean(r["r1"].get(i, 0.0) for r in ranks)}
                      for i, loss in enumerate(ranks[0]["losses"])]
    return program


def judge(config: dict, traffic: dict, seed: int, ranks: list[dict], device,
          precisions=("float32",), cache: dict | None = None) -> dict:
    """The ranks' records against the reference's steps on ``device``; ->
    ``compare``'s readings, the ranks' largest difference and the rows
    matched to no dataset image. With a second precision (the control,
    "fp8"), also ``control``: ``compare``'s readings of the reference at
    that precision against the float32 reference's, on the same steps.
    ``cache`` (a dict kept between calls on one seed) hands a reference
    run on again where its rows and draws are these, value for value;
    ``references_run`` counts the runs made anew."""
    prints, marks = dataset(config, traffic, seed, device)
    batches, unmatched = global_batches(ranks, prints, marks, traffic["check_steps"])
    del prints, marks
    inputs = (batches, ranks[0]["draws"])
    runs, fresh = [], 0
    for p in precisions:
        hit = (cache or {}).get(p)
        if hit is not None and _same(hit[0], inputs):
            runs.append(hit[1])
            continue
        runs.append(reference_run(config, traffic, seed, ranks[0], batches, device, p))
        fresh += 1
        if cache is not None:
            cache[p] = (inputs, runs[-1])
    values = compare(program_records(ranks), runs[0])
    values |= {"ranks_max_abs_diff": ranks[0]["ranks_max_abs_diff"],
               "feed_rows_unmatched": unmatched, "references_run": fresh}
    if len(runs) > 1:
        values["control"] = compare(runs[1], runs[0])
    return values


def check(values: dict, limits: dict) -> dict:
    return {name: {"value": values[name], "limit": limit} for name, limit in limits.items()}


# ------------------------------------------------------------ one run


def program_config_path(cell: dict, run_dir: Path, seed: int) -> Path:
    return harness.write_program_config(
        cell["config_file"]["config"], run_dir / "config.toml",
        training={"checkpoint_directory": str(run_dir / "checkpoints"),
                  "random_seed": int(seed) & synth.SEED_MASK},
        data={"shoeprint_data_dir": str(run_dir / "prints"),
              "shoemark_data_dir": str(run_dir / "marks")},
    )


def spawn_ranks_only(fn, cell: dict, spec: dict, device) -> int:
    """``fn(group, spec)`` on the cell's ranks (the port's launcher); ->
    their number."""
    from one_to_many_gan_torch.parallel import distributed

    world = cell["config_file"]["config"]["tpu"]["data_parallel"]
    distributed.spawn(fn, world, device.type, args=(spec,))
    return world


def spawn_ranks(fn, cell: dict, spec: dict, device) -> list[dict]:
    """``fn(group, spec)`` on the cell's ranks; -> each rank's record."""
    world = spawn_ranks_only(fn, cell, spec, device)
    return [torch.load(Path(spec["run_dir"]) / f"rank{r}.pt", weights_only=False)
            for r in range(world)]


def run(ctx) -> dict:
    """One run of a training cell (module docstring); ``ctx``: ``cell``,
    ``seed``, ``seconds``, ``trace``, ``device``, ``run_dir``, ``t_start``,
    ``log``, and ``fault`` (a fault planted under the timed path, or
    None)."""
    from one_to_many_gan_torch.config import load_config

    cell, traffic, log = ctx.cell, ctx.cell["traffic_file"], ctx.log
    device = ctx.device
    os.environ.setdefault("USE_FLAX", "0")
    config_path = program_config_path(cell, ctx.run_dir, ctx.seed)
    config = load_config(config_path)
    spec = {"config_path": str(config_path), "run_dir": str(ctx.run_dir), "seed": ctx.seed,
            "seconds": ctx.seconds, "trace": bool(ctx.trace), "traffic": traffic,
            "check_steps": traffic["check_steps"], "time_from": traffic["time_from"],
            "fault": getattr(ctx, "fault", None)}
    ranks = spawn_ranks(rank_main, cell, spec, device)
    bad = sorted({m for r in ranks for m in r["forbidden"]})
    if bad:
        log(f"a rank has loaded {bad}: the benchmark runs without JAX")
        raise SystemExit(4)
    rank0 = ranks[0]
    setup_s = rank0["t_open"] - ctx.t_start
    window_s = rank0["t_close"] - rank0["t_open"]
    batch = config["training"]["batch_size"]
    rate = rank0["steps"] * batch / window_s
    peak = max(r["peak"] for r in ranks)
    marks = [("spawn", ctx.t_start), *sorted(rank0["laps"].items(), key=lambda kv: kv[1]),
             ("window", rank0["t_open"])]
    log("set-up laps (s): " + ", ".join(f"{b[0]} {b[1] - a[1]:.2f}"
                                        for a, b in zip(marks, marks[1:])))
    log(f"setup_s {setup_s:.3f}; warm-up {rank0['per_step_warm'] * 1e3:.1f} ms a step; window "
        f"{rank0['steps']} steps in {window_s:.3f} s: {rate:.3f} images/s; peak "
        f"{[r['peak'] for r in ranks]}")

    t = time.perf_counter()
    ref_device = torch.device(device.type, 0) if device.type == "cuda" else device
    values = judge(config, traffic, ctx.seed, ranks, ref_device)
    log(f"reference of {traffic['check_steps']} steps in {time.perf_counter() - t:.2f} s: "
        + json.dumps({k: v for k, v in values.items() if k != "excluded_leaves"}))
    checks = check(values, cell["limits"]["limits"])
    finite = all(np.isfinite(v) for r in rank0["losses"] for v in r.values())
    result = {
        "attempted": rank0["steps"],
        "failed": 0,
        "checks": checks,
        "readings": values,
        "correct": finite and all(c["value"] <= c["limit"] for c in checks.values()),
        "end_to_end": {"train_images_per_s": rate, "setup_s": setup_s},
        "memory_peak_bytes": peak,
    }
    if ctx.trace and "trace" in rank0:
        from benchmark import train_formulas

        tr, annotations = train_trace.load(rank0["trace"])
        tr.bound_to_period()
        tr.rank_busy = [r["busy_s"] for r in ranks]
        result["run"] = SimpleNamespace(
            trace=tr, annotations=annotations, steps=traffic["period_steps"], chips=len(ranks),
            rates={"train_images_per_s": rate},
            work={"flops_per_image": train_formulas.flops_per_image(config)},
            peaks=harness.peaks(), precision=config["tpu"]["precision"])
        result["breakdown"] = {"device_ops": tr.top_device_ops(10),
                               "idle_gaps": tr.idle_gaps(10, tr.spans())}
    return result
