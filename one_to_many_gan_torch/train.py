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
"""

from __future__ import annotations

import argparse
import json
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
from one_to_many_gan_torch.device import set_cublas_workspace

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


def run_step(config: Config, models: Models, state: TrainState, train_step, generator):
    """One fused step on four fresh synthetic batches and fresh draws."""
    b = config["training"]["batch_size"]
    batches = Batches(*(
        synthetic_batch(generator, b, models.image_size, models.channels) for _ in range(4)
    ))
    return train_step(state, batches, draw_step(generator, config, models))


def run_synthetic(config: Config, steps: int, *, seed: int, ada_p: float, device) -> None:
    """``--synthetic-steps``: fused steps on noise, one JSON line each."""
    models, state, generator = setup(config, seed=seed, ada_p=ada_p, device=device)
    train_step = make_train_step(config, models)
    interval = config["tpu"]["path_interval"]
    for step in range(steps):
        path_step = state.step % interval == 0
        t0 = time.perf_counter()
        state, metrics = run_step(config, models, state, train_step, generator)
        if models.device.type == "cuda":
            torch.cuda.synchronize(models.device)
        ms = (time.perf_counter() - t0) * 1e3
        line = {k: float(v) for k, v in metrics.items()}
        line.update(step=step, path_step=path_step, ms=ms,
                    buffer_count=int(state.buffer.count), ada_count=int(state.ada.count),
                    device=str(models.device))
        print(json.dumps(line), flush=True)


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("config", nargs="?", default="config.toml")
    ap.add_argument("--synthetic-steps", type=int, default=None,
                    help="run this many fused steps on noise instead of the Trainer")
    ap.add_argument("--seed", type=int, default=0, help="--synthetic-steps only")
    ap.add_argument("--ada-p", type=float, default=0.0, help="--synthetic-steps only")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    config = load_config(args.config)
    if config["training"]["deterministic_cuda_kernels"]:
        set_cublas_workspace()  # before anything touches CUDA
    if args.synthetic_steps is not None:
        run_synthetic(config, args.synthetic_steps, seed=args.seed, ada_p=args.ada_p,
                      device=args.device)
        return
    from one_to_many_gan_torch.core.trainer import Trainer, TrainingDiverged

    try:
        Trainer(config, device=args.device).run()
    except TrainingDiverged as exc:
        print(f"TrainingDiverged: {exc}", file=sys.stderr)
        sys.exit(DIVERGED_EXIT_CODE)


if __name__ == "__main__":
    main()
