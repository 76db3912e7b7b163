"""The training loop around the fused step, with checkpoints and resume.

The JAX package's ``core/trainer.py`` on the port: ``Trainer`` builds
the models, the training state and five data streams from the config;
``run()`` trains ``training.training_steps`` fused steps, logs every
``log_interval`` steps in the reference's format (``<run>/log``, and
``<run>/metrics.jsonl``), and every ``checkpoint_interval`` steps and at
the end writes the image grids, the validation FID/KID and a checkpoint.

- **Checkpoints** are the reference's ``<run>/models/<step>.tar`` files,
  in its schema (``migrate.py``), plus the ADA window and the step, so a
  resume continues exactly where the run stopped. A save writes a
  temporary file and renames it into place; older files beyond
  ``tpu.keep_checkpoints`` are deleted only after that.
- **Resume** (``tpu.resume``, the default): the latest checkpoint is
  restored and both training streams skip the ``2 * step`` batches the
  steps before it consumed. Each step's draws come from a
  ``torch.Generator`` seeded from ``(random_seed, step)`` and each
  checkpoint's from ``(random_seed, 7_000_000 + step)``, so a run paused
  and resumed equals one that never stopped (bit for bit under
  ``training.deterministic_cuda_kernels``).
- **Groups**: ``tpu.steps_per_call`` steps form a group (clamped to a
  divisor of both intervals, with a warning); the port runs a group's
  steps back to back. ``tpu.split_phases`` forces groups of 1, as the JAX
  package does (``core/trainer.py``); the port's step is already the D
  phase and the G phase as two calls, each freeing its graph before the
  next, so the split changes nothing else and gives the same bits.
- **EMA** (``tpu.ema_decay > 0``): the EMA generator is saved in the
  checkpoint (``migrate.py``), restored on resume, and is what the grids,
  the validation FID/KID and the artifact sample from.
- **Data**: a producer thread prepares ``tpu.prefetch`` groups ahead:
  the uint8 batches (flipped on the host) in pinned memory, copied to
  the device on a stream of their own, and normalised there to [-1, 1]
  (``x.float() / 127.5 - 1.0``, the op order of ``normalize_u8``). With
  ``tpu.native_loader`` the folders are decoded by the C++ loader and the
  grids' float batches assembled by it (``data/native.py``), as in the
  JAX package.
- **TensorBoard** (``tpu.tensorboard``): every log line's means also go
  to ``<run>/tensorboard`` as scalars (``utils/tensorboard.py``); the
  ``tensorboard`` package is checked for when the Trainer is built.
- **Stops**: ``run(max_steps)`` pauses early and then saves a model-only
  checkpoint (no grids, no FID) when it stops off the cadence; SIGTERM
  (handled on the main thread only) stops at the next group with that
  same save; a non-finite interval mean raises ``TrainingDiverged`` at
  the log line, before that step's checkpoint (``tpu.halt_on_nonfinite``).
- **Profile**: at ``tpu.profile_step`` the group holding that step runs
  under ``torch.profiler``; the trace goes to ``<run>/trace/`` and the
  device's busy and idle share to ``Trainer.profile``.

- **Data parallelism** (a ``group``, ``parallel.DataParallel``, of
  ``tpu.data_parallel`` ranks, one card each): every rank builds the
  Trainer and runs the loop. Rank 0's state is broadcast at start (after
  a resume every rank has read the same file onto its card). The data is
  the JAX single-host mesh's: one global stream per domain
  (``host_count`` 1), of which each rank gathers only its rows
  (``BatchIterator(rows=...)``); each step's draws are the global batch's,
  made alike on every rank. Rank 0 alone writes the log lines, grids,
  evaluation (on its replica), TensorBoard, traces and checkpoints; the
  others wait at a host-side barrier whose timeout covers the
  evaluation. A SIGTERM to any rank stops every rank at the same group
  boundary; the logged means are global, so a non-finite one raises on
  every rank. The checkpoint schema is one card's: a checkpoint of four
  ranks resumes on one card, and the reverse. The ranks may span
  several nodes (torchrun, ``parallel/distributed.py``); on resume each
  reads the checkpoint itself, and when the ranks restored different
  steps (a node that does not see the same ``checkpoint_directory``)
  every rank raises before the first step.

- **Spatial parallelism** (``tpu.spatial_parallel`` = S > 1; the
  group's ``spatial`` subgroup): the ``data_parallel x S`` ranks form
  the JAX package's ("data", "spatial") grid. The S ranks of a data row
  read the same rows of the global batch, and the step gives each its
  band of rows of every image (``core/train_step.py``,
  ``parallel/halo.py``). The state, the buffer included, stays whole and
  identical on every rank, so checkpoints keep one card's schema: a 2x2
  run resumes in one process and the reverse.

``tpu.compilation_cache_dir`` (a JAX compile cache) is ignored.
"""

from __future__ import annotations

import json
import math
import queue
import signal
import threading
import time
import warnings
from pathlib import Path

import numpy as np
import torch

from one_to_many_gan_torch.config import Config, check_training_options
from one_to_many_gan_torch.core.evaluation import (
    Logger,
    image_checkpoint,
    run_dir,
    val_checkpoint,
)
from one_to_many_gan_torch.core.state import Models, TrainState, init_train_state
from one_to_many_gan_torch.core.train_step import Batches, draw_step, make_train_step
from one_to_many_gan_torch.data import BatchIterator, ShoeDataset
from one_to_many_gan_torch.migrate import (
    CheckpointManager,
    checkpoint_manager,
    from_reference_checkpoint,
    to_reference_checkpoint,
)
from one_to_many_gan_torch.parallel import distributed, replicate
from one_to_many_gan_torch.utils import tensorboard

# Checkpoint draws are seeded from (random_seed, CHECKPOINT_SEED_OFFSET + step).
CHECKPOINT_SEED_OFFSET = 7_000_000


class TrainingDiverged(RuntimeError):
    """A non-finite interval-mean metric (``tpu.halt_on_nonfinite``).

    Raised at the log line, before the same step's checkpoint, so the
    poisoned state is never saved; a resume restarts from the latest
    good checkpoint."""


def seeded_generator(seed: int, step: int, device) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded from ``(seed, step)``."""
    state = np.random.SeedSequence([seed, step]).generate_state(2, np.uint32)
    return torch.Generator(device).manual_seed(int(state[0]) << 32 | int(state[1]))


def save_checkpoint(mgr: CheckpointManager, step: int, state: TrainState) -> Path:
    if state.step != step:
        msg = f"saving step {step} of a state at step {state.step}"
        raise ValueError(msg)
    return mgr.save(step, to_reference_checkpoint(state))


def restore_checkpoint(mgr: CheckpointManager, state: TrainState) -> tuple[TrainState, int]:
    """Restore the latest checkpoint into ``state`` if there is one;
    -> (state, start step)."""
    latest = mgr.latest_step()
    if latest is None:
        return state, 0
    return from_reference_checkpoint(mgr.load(latest), state, step=latest), latest


class _Prefetcher:
    """A producer thread that prepares the groups of ``schedule`` ahead,
    at most ``depth`` waiting; ``get()`` raises what the producer raised."""

    def __init__(self, make_group, schedule: list[int], depth: int):
        self._queue: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._make_group = make_group
        self._thread = threading.Thread(target=self._produce, args=(schedule,), daemon=True)
        self._thread.start()

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._queue.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _produce(self, schedule: list[int]) -> None:
        try:
            for k in schedule:
                if not self._put(self._make_group(k)):
                    return
        except Exception as exc:  # noqa: BLE001 — handed to the consumer, which raises it
            self._put(exc)

    def get(self):
        item = self._queue.get()
        if isinstance(item, Exception):
            raise item
        return item

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=60)


class Trainer:
    """Builds everything from ``config``; ``run()`` executes the loop.

    ``shoeprint_images`` / ``shoemark_images`` ([N, H, W, C] uint8) stand
    in for the data directories. ``device`` None means CUDA, and raises
    without a GPU. ``group`` (``parallel.DataParallel``) makes this
    Trainer one rank of a data-parallel run on the group's device
    (``device`` is then ignored); without one, a ``tpu.data_parallel``
    that resolves to more than one rank raises by name.
    """

    def __init__(
        self,
        config: Config,
        *,
        shoeprint_images: np.ndarray | None = None,
        shoemark_images: np.ndarray | None = None,
        verbose: bool = True,
        device=None,
        group=None,
    ):
        check_training_options(config)
        self.config = config
        self.group = group
        self.main = group is None or group.is_main
        self.verbose = verbose and self.main
        seed = config["training"]["random_seed"]
        self.seed = seed
        if group is None:
            self.models = Models(config, device=device, seed=seed)
            ranks = distributed.data_parallel_ranks(config, self.models.device.type)
            if ranks > 1:
                msg = (
                    f"tpu.data_parallel = {config['tpu']['data_parallel']!r} x "
                    f"tpu.spatial_parallel = {config['tpu']['spatial_parallel']!r} runs {ranks} "
                    "ranks: train through `python -m one_to_many_gan_torch.train` (or "
                    "torchrun), or pass a parallel.DataParallel group"
                )
                raise ValueError(msg)
        else:
            if group.spatial_ranks != config["tpu"]["spatial_parallel"]:
                msg = (f"tpu.spatial_parallel = {config['tpu']['spatial_parallel']!r}, but the "
                       f"group has {group.spatial_ranks} spatial ranks")
                raise ValueError(msg)
            self.models = Models(config, device=group.device, seed=seed)
        self.device = self.models.device

        k_req = 1 if config["tpu"]["split_phases"] else max(1, config["tpu"]["steps_per_call"])
        k = math.gcd(math.gcd(k_req, config["evaluation"]["log_interval"]),
                     config["evaluation"]["checkpoint_interval"])
        if k != k_req:
            warnings.warn(
                f"tpu.steps_per_call={k_req} does not divide the log/checkpoint "
                f"intervals; clamped to {k}",
                stacklevel=2,
            )
        self.steps_per_call = k
        self.state = init_train_state(config, self.models, seed=seed)
        self.train_step = make_train_step(config, self.models, group)

        if config["tpu"]["tensorboard"]:
            tensorboard.require()
        image_size = tuple(config["data"]["image_size"])
        channels = config["data"]["image_channels"]
        native = config["tpu"]["native_loader"]
        if shoeprint_images is None:
            shoeprint_images = ShoeDataset(
                config["data"]["shoeprint_data_dir"], mode="train",
                image_size=image_size, channels=channels, native=native,
            ).images
        if shoemark_images is None:
            shoemark_images = ShoeDataset(
                config["data"]["shoemark_data_dir"], mode="train",
                image_size=image_size, channels=channels, native=native,
            ).images
        self.shoemark_images = shoemark_images
        batch = config["training"]["batch_size"]

        def train_iter(images, offset, *, as_float=False, rows=None):
            return BatchIterator(images, batch, shuffle=True, flip_prob=0.5,
                                 seed=seed + offset, native=native, as_float=as_float,
                                 rows=rows)

        # The D and G sub-steps' streams (uint8: normalised on the device),
        # owned by the producer thread, each rank gathering its rows; the
        # grids' streams of their own (rank 0's).
        rows = None if group is None else group.rows(batch)
        self.shoeprint_iter = train_iter(shoeprint_images, 1, rows=rows)
        self.shoemark_iter = train_iter(shoemark_images, 2, rows=rows)
        self.grid_print_iter = train_iter(shoeprint_images, 3, as_float=True)
        self.grid_mark_iter = train_iter(shoemark_images, 4, as_float=True)
        # the reference flips in every mode, the validation loader's too
        self.val_iter = BatchIterator(
            shoeprint_images, config["evaluation"]["inference_batch_size"],
            shuffle=False, flip_prob=0.5, seed=seed,
        )

        self.logger = Logger(config["training"]["training_steps"])
        self._tb: tensorboard.TensorBoardWriter | None = None  # made at the first log
        self._reals_cache: dict = {}
        self.timings: dict[str, float] = {}  # seconds of the latest checkpoint's parts
        self.profile: dict | None = None
        self.ckpt_mgr = checkpoint_manager(config)
        self.start_step = 0
        if config["tpu"]["resume"]:
            self.state, self.start_step = restore_checkpoint(self.ckpt_mgr, self.state)
            if self.start_step:
                if self.verbose:
                    print(f"Resumed from checkpoint at step {self.start_step}")
                # each step took one D and one G batch of each domain
                self.shoeprint_iter.skip(2 * self.start_step)
                self.shoemark_iter.skip(2 * self.start_step)
            if group is not None:
                self._check_ranks_resume_alike(group)
        replicate(group, self.state)
        self._copy_stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None

    def _check_ranks_resume_alike(self, group) -> None:
        """Raise on every rank unless every rank restored the same step:
        a rank that saw no checkpoint (or an older one) would run another
        number of steps, and the collectives would hang."""
        steps = group.gather_int(self.start_step)
        if min(steps) != max(steps):
            behind = {r: s for r, s in enumerate(steps) if s != max(steps)}
            msg = (f"ranks {sorted(behind)} resumed from steps {sorted(set(behind.values()))} "
                   f"(0: no checkpoint) where others resumed from step {max(steps)}, under "
                   f"{self.ckpt_mgr.directory}: every node must see the same "
                   "training.checkpoint_directory (a shared file system)")
            raise RuntimeError(msg)

    # ------------------------------------------------------------ data

    def _next_batches_np(self) -> Batches:
        return Batches(
            d_shoeprints=next(self.shoeprint_iter),
            d_shoemarks=next(self.shoemark_iter),
            g_shoeprints=next(self.shoeprint_iter),
            g_shoemarks=next(self.shoemark_iter),
        )

    def _make_group(self, k: int):
        """The next ``k`` steps' uint8 batches as one [4k, B, H, W, C]
        tensor on the device (on CUDA: from pinned memory, on the copy
        stream, with an event the consumer waits on)."""
        host = torch.from_numpy(np.stack([x for _ in range(k) for x in self._next_batches_np()]))
        if self._copy_stream is None:
            return host, None
        host = host.pin_memory()
        with torch.cuda.stream(self._copy_stream):
            dev = host.to(self.device, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record(self._copy_stream)
        return dev, ready

    def _unpack_group(self, group) -> list[Batches]:
        """Normalise a group on the current stream -> its steps' batches."""
        u8, ready = group
        if ready is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(ready)
            u8.record_stream(stream)  # allocated on the copy stream, read here
        x = u8.float() / 127.5 - 1.0
        return [Batches(*x[4 * i : 4 * i + 4].unbind(0)) for i in range(x.shape[0] // 4)]

    @staticmethod
    def _schedule(start: int, total: int, k: int) -> list[int]:
        out = []
        step = start
        while step < total:
            out.append(min(k, total - step))
            step += out[-1]
        return out

    # ------------------------------------------------------------ loop

    def run(self, max_steps: int | None = None) -> TrainState:
        config = self.config
        final = config["training"]["training_steps"]
        total = final if max_steps is None else min(final, self.start_step + max_steps)
        ckpt_interval = config["evaluation"]["checkpoint_interval"]
        schedule = self._schedule(self.start_step, total, self.steps_per_call)

        depth = config["tpu"]["prefetch"]
        prefetcher = _Prefetcher(self._make_group, schedule, depth) if depth > 0 else None
        get_group = prefetcher.get if prefetcher is not None else None

        self._preempted = False

        def on_term(signum, frame):  # noqa: ARG001
            self._preempted = True
            if self.verbose:
                print("SIGTERM: checkpointing and exiting at the next step boundary")

        try:
            prev_handler = signal.signal(signal.SIGTERM, on_term)
        except ValueError:  # not the main thread: no handler, no preemption stop
            prev_handler = None

        step = self.start_step
        try:
            step = self._run_loop(schedule, step, get_group, total)
        finally:
            if prev_handler is not None:
                signal.signal(signal.SIGTERM, prev_handler)
            if prefetcher is not None:
                prefetcher.close()
        if step < final and step % ckpt_interval != 0 and step > self.start_step:
            # a pause or a preemption off the cadence: a model-only save, so
            # that a resume does not replay the steps since the last one
            if self.main:
                save_checkpoint(self.ckpt_mgr, step, self.state)
            self._barrier()
        return self.state

    def _barrier(self) -> None:
        if self.group is not None:
            self.group.barrier()

    def _run_loop(self, schedule, step, get_group, total) -> int:
        config = self.config
        final = config["training"]["training_steps"]
        log_interval = config["evaluation"]["log_interval"]
        ckpt_interval = config["evaluation"]["checkpoint_interval"]
        profile_step = config["tpu"]["profile_step"]
        path = run_dir(config)
        t0 = time.perf_counter()
        for k in schedule:
            profiling = self.main and bool(profile_step) and step <= profile_step < step + k
            if profiling:
                prof = self._start_profile()
                t_prof = time.perf_counter()
            group = get_group() if get_group is not None else self._make_group(k)
            for i, batches in enumerate(self._unpack_group(group)):
                draws = draw_step(seeded_generator(self.seed, step + i, self.device),
                                  config, self.models)
                self.state, metrics = self.train_step(self.state, batches, draws)
                self.logger.append_metrics(metrics)
            if profiling:
                self._stop_profile(prof, k, t_prof, path)
            step += k

            if step % log_interval == 0 or step == total:
                line, means = self.logger.summary(step)
                if self.verbose:
                    rate = (step - self.start_step) / (time.perf_counter() - t0)
                    print(line + f" [{rate:.2f} it/s]", flush=True)
                if self.main:
                    path.mkdir(parents=True, exist_ok=True)
                    with (path / "log").open("a") as f:
                        f.write(line + "\n")
                    with (path / "metrics.jsonl").open("a") as f:
                        f.write(json.dumps({"step": step, **means}) + "\n")
                if self.main and config["tpu"]["tensorboard"]:
                    if self._tb is None:
                        self._tb = tensorboard.TensorBoardWriter(path / "tensorboard")
                    self._tb.write(step, means)
                if config["tpu"]["halt_on_nonfinite"] and not all(
                    np.isfinite(v) for v in means.values()
                ):
                    bad = [name for name, v in means.items() if not np.isfinite(v)]
                    msg = (
                        f"non-finite metrics {bad} in the interval ending at step {step}; "
                        "halting before checkpointing the poisoned state; a resume "
                        "restarts from the latest saved checkpoint (tpu.halt_on_nonfinite)"
                    )
                    raise TrainingDiverged(msg)

            # on the cadence, and at the true end (a pause is no end)
            if step % ckpt_interval == 0 or step == final:
                self.checkpoint(step)
            preempted = self._preempted
            if self.group is not None:
                preempted = self.group.any(preempted)
            if preempted:
                break
        return step

    def _start_profile(self):
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
            torch.cuda.synchronize(self.device)
        prof = profile(activities=activities)
        prof.start()
        return prof

    def _stop_profile(self, prof, steps: int, t_start: float, path: Path) -> None:
        """Stop the trace once the group's steps have finished on the
        device; keep the device's busy share of the group's wall time in
        ``self.profile``."""
        from torch.autograd import DeviceType

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        wall_s = time.perf_counter() - t_start
        prof.stop()
        trace_dir = path / "trace"
        trace_dir.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(trace_dir / "trace.json"))
        busy_ms = None
        if self.device.type == "cuda":
            busy_ms = sum(
                getattr(evt, "self_device_time_total", 0.0) / 1e3
                for evt in prof.key_averages() if evt.device_type == DeviceType.CUDA
            )
        self.profile = {
            "steps": steps, "wall_ms": wall_s * 1e3, "device_busy_ms": busy_ms,
            "idle_share": None if busy_ms is None else 1.0 - busy_ms / (wall_s * 1e3),
        }
        if self.verbose:
            print(f"profile of {steps} steps: {self.profile}")

    def checkpoint(self, step: int) -> None:
        """Image grids, validation FID/KID and the model checkpoint of
        ``step``; the draws from ``(random_seed, 7_000_000 + step)``.
        Under data parallelism rank 0 does it on its replica while the
        others wait."""
        if not self.main:
            self._barrier()
            return
        gen = seeded_generator(self.seed, CHECKPOINT_SEED_OFFSET + step, self.device)
        t0 = time.perf_counter()
        image_checkpoint(step, self.config, self.models, self.state,
                         self.grid_print_iter, self.grid_mark_iter, gen)
        t1 = time.perf_counter()
        val_checkpoint(step, self.config, self.models, self.state, self.val_iter, gen,
                       real_images=self.shoemark_images, reals_cache=self._reals_cache)
        t2 = time.perf_counter()
        save_checkpoint(self.ckpt_mgr, step, self.state)
        t3 = time.perf_counter()
        self.timings = {"image": t1 - t0, "val": t2 - t1, "save": t3 - t2}
        self._barrier()
