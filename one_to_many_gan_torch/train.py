"""Run fused training steps (the D phase, then the G phase) on synthetic
batches.

    python -m one_to_many_gan_torch.train config.toml \
        [--steps 3] [--seed 0] [--ada-p 0.6] [--device cpu]

Builds the models and the training state from the config with fresh
weights from ``--seed``, then runs ``--steps`` fused steps, each on four
fresh uniform [-1, 1) batches and fresh draws from
``torch.Generator(device).manual_seed(seed)``, with the ADA probability
starting at ``--ada-p``. Prints one JSON line per step: the metrics of
both phases, whether it was a path step (``step % tpu.path_interval ==
0``), the buffer's and the ADA window's counts, and the step's wall time
(ms, synchronised on CUDA). Runs on ``cuda`` unless ``--device cpu``;
raises without a GPU. With ``training.deterministic_cuda_kernels = true``
two runs with one seed give the same bits (``device.use_deterministic_kernels``).
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from one_to_many_gan_torch.augment import init_ada_state
from one_to_many_gan_torch.config import Config, load_config
from one_to_many_gan_torch.device import set_cublas_workspace
from one_to_many_gan_torch.core.state import Models, TrainState, init_train_state
from one_to_many_gan_torch.core.train_step import (
    Batches,
    draw_step,
    make_train_step,
    synthetic_batch,
)


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


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("config")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ada-p", type=float, default=0.0)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    config = load_config(args.config)
    if config["training"]["deterministic_cuda_kernels"]:
        set_cublas_workspace()  # before anything touches CUDA
    models, state, generator = setup(
        config, seed=args.seed, ada_p=args.ada_p, device=args.device
    )
    train_step = make_train_step(config, models)
    interval = config["tpu"]["path_interval"]
    for step in range(args.steps):
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


if __name__ == "__main__":
    main()
