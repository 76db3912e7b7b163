"""Train: the ``Trainer`` loop from image folders, or fused steps on noise.

    python -m one_to_many_gan_torch.train [config.toml] [--device cpu]

Builds a ``Trainer`` from the config (the image folders
``data.shoeprint_data_dir`` / ``data.shoemark_data_dir``, ``<dir>/train/``)
and runs it: reference-format log lines every ``log_interval`` steps,
image grids, validation FID/KID and a ``<run>/models/<step>.tar``
checkpoint every ``checkpoint_interval`` steps and at the end; with
``tpu.resume`` (the default) it continues from the run's latest
checkpoint (``Resumed from checkpoint at step N``). Exit code 42 on
``TrainingDiverged`` (a non-finite interval mean under
``tpu.halt_on_nonfinite``): a resume would replay it. SIGTERM saves and
exits at the next step group.

    python -m one_to_many_gan_torch.train config.toml --synthetic-steps 3 \
        [--seed 0] [--ada-p 0.6] [--device cpu]

runs fused steps without data, checkpoints or logs: each on four fresh
uniform [-1, 1) batches and fresh draws from
``torch.Generator(device).manual_seed(seed)``, with fresh weights from
``--seed`` and the ADA probability starting at ``--ada-p``, printing one
JSON line per step: the metrics of both phases, whether it was a path
step (``step % tpu.path_interval == 0``), the buffer's and the ADA
window's counts, and the step's wall time (ms, synchronised on CUDA).

Both modes run on ``cuda`` unless ``--device cpu``, and raise without a
GPU. With ``training.deterministic_cuda_kernels = true`` two runs give
the same bits (``device.use_deterministic_kernels``; the cuBLAS
workspace is set before CUDA starts).

Data and spatial parallelism: when ``tpu.data_parallel x
tpu.spatial_parallel`` resolves to more than one rank
(``parallel.distributed.data_parallel_ranks``: -1 is every visible card
a spatial column leaves; more than there are raise), both modes run one
rank per card, each image's rows split over the ``spatial_parallel``
ranks of its data row (``parallel/halo.py``): the
CLI builds the CUDA kernels once, then starts the ranks itself (one
process each, NCCL over a free local port) and waits for them, or, under
torchrun, this process is one of them. With ``--device cpu`` the ranks
are gloo processes (``data_parallel x spatial_parallel`` of them; -1 is
one data row). A rank's
failure ends every rank, and the CLI exits with its code (42 for
``TrainingDiverged``). Rank 0 prints; ``--synthetic-steps`` then times
each step of the data-parallel step on its card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

from one_to_many_gan_torch.augment import init_ada_state
from one_to_many_gan_torch.config import Config, load_config
from one_to_many_gan_torch.core.state import Models, TrainState, init_train_state
from one_to_many_gan_torch.core.train_step import (
    Batches,
    draw_step,
    make_train_step,
    synthetic_batch,
)
from one_to_many_gan_torch.device import select_device, set_cublas_workspace
from one_to_many_gan_torch.parallel import distributed, replicate, shard_batch

DIVERGED_EXIT_CODE = 42


def setup(config: Config, *, seed: int = 0, ada_p: float = 0.0, device=None):
    """-> (models, state, generator): fresh weights from ``seed``, the ADA
    probability set to ``ada_p``, a ``torch.Generator`` seeded with
    ``seed`` on the models' device."""
    models = Models(config, device=device, seed=seed)
    state = init_train_state(config, models, seed=seed)
    state.ada = init_ada_state(models.device, p=ada_p)
    generator = torch.Generator(models.device).manual_seed(seed)
    return models, state, generator


def run_step(config: Config, models: Models, state: TrainState, train_step, generator,
             group=None):
    """One fused step on four fresh synthetic batches and fresh draws (the
    global batch's; with ``group`` the step takes this rank's rows)."""
    b = config["training"]["batch_size"]
    batches = [shard_batch(group, synthetic_batch(generator, b, models.image_size,
                                                  models.channels)) for _ in range(4)]
    return train_step(state, Batches(*batches), draw_step(generator, config, models))


def run_synthetic(config: Config, steps: int, *, seed: int, ada_p: float, device,
                  group=None) -> None:
    """``--synthetic-steps``: fused steps on noise, one JSON line each
    (rank 0's, with ``group``)."""
    if group is not None:
        device = group.device
    models, state, generator = setup(config, seed=seed, ada_p=ada_p, device=device)
    replicate(group, state)
    train_step = make_train_step(config, models, group)
    interval = config["tpu"]["path_interval"]
    for step in range(steps):
        path_step = state.step % interval == 0
        t0 = time.perf_counter()
        state, metrics = run_step(config, models, state, train_step, generator, group)
        if models.device.type == "cuda":
            torch.cuda.synchronize(models.device)
        ms = (time.perf_counter() - t0) * 1e3
        line = {k: float(v) for k, v in metrics.items()}
        line.update(step=step, path_step=path_step, ms=ms,
                    buffer_count=int(state.buffer.count), ada_count=int(state.ada.count),
                    device=str(models.device), ranks=1 if group is None else group.world)
        if group is None or group.is_main:
            print(json.dumps(line), flush=True)


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("config", nargs="?", default="config.toml")
    ap.add_argument("--synthetic-steps", type=int, default=None,
                    help="run this many fused steps on noise instead of the Trainer")
    ap.add_argument("--seed", type=int, default=0, help="--synthetic-steps only")
    ap.add_argument("--ada-p", type=float, default=0.0, help="--synthetic-steps only")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    return ap


def _run(config: Config, args, group=None) -> None:
    """Either mode in this process (one rank of ``group``, if given)."""
    if args.synthetic_steps is not None:
        run_synthetic(config, args.synthetic_steps, seed=args.seed, ada_p=args.ada_p,
                      device=args.device, group=group)
        return
    from one_to_many_gan_torch.core.trainer import Trainer, TrainingDiverged

    try:
        Trainer(config, device=args.device, group=group).run()
    except TrainingDiverged as exc:
        print(f"TrainingDiverged: {exc}", file=sys.stderr)
        sys.exit(DIVERGED_EXIT_CODE)


def _rank(group, argv: list[str]) -> None:
    """One data-parallel rank of the CLI (``distributed.spawn``'s target)."""
    args = _parser().parse_args(argv)
    _run(load_config(args.config), args, group)


def main(argv: list[str] | None = None) -> None:
    argv = sys.argv[1:] if argv is None else list(argv)
    args = _parser().parse_args(argv)
    config = load_config(args.config)
    if config["training"]["deterministic_cuda_kernels"]:
        set_cublas_workspace()  # before anything touches CUDA; the ranks inherit it
    device_type = select_device(args.device).type
    ranks = distributed.data_parallel_ranks(config, device_type)
    if ranks == 1:
        _run(config, args)
        return
    timeout_s = distributed.barrier_timeout_s(config)
    spatial = config["tpu"]["spatial_parallel"]
    if distributed.torchrun_present():
        world = int(os.environ["WORLD_SIZE"])
        if world != ranks:
            msg = (f"torchrun started {world} ranks; tpu.data_parallel x "
                   f"tpu.spatial_parallel resolves to {ranks}")
            raise ValueError(msg)
        group = distributed.ensure_initialized(device_type, timeout_s=timeout_s,
                                               spatial=spatial)
        _run(config, args, group)
        return
    if device_type == "cuda":
        from one_to_many_gan_torch.ops.cuda import build

        build.build_kernels()  # once, before the ranks would each build them
    try:
        distributed.spawn(_rank, ranks, device_type, (argv,), timeout_s=timeout_s,
                          spatial=spatial)
    except distributed.RankFailed as exc:
        print(f"train: {exc}", file=sys.stderr)
        sys.exit(exc.exitcode)


if __name__ == "__main__":
    main()
