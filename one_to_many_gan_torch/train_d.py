"""Run the discriminator phase of training on synthetic batches.

    python -m one_to_many_gan_torch.train_d config.toml \
        [--steps 3] [--seed 0] [--ada-p 0.6] [--device cpu]

Builds the models from the config with fresh weights from ``--seed``,
then runs ``--steps`` D phases on uniform [-1, 1) batches and draws from
``torch.Generator(device).manual_seed(seed)``, with the ADA probability
starting at ``--ada-p``. Prints one JSON line per step: the metrics, the
buffer's and the ADA window's counts, and the step's wall time (ms,
synchronised on CUDA). Runs on ``cuda`` unless ``--device cpu``; raises
without a GPU. The generator stays as initialised: ``train.py`` runs the
fused step, both phases. One process only: an explicit
``tpu.data_parallel > 1`` is refused by name (-1 runs one process here).
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from one_to_many_gan_torch import train
from one_to_many_gan_torch.config import Config, load_config
from one_to_many_gan_torch.device import set_cublas_workspace
from one_to_many_gan_torch.core.state import Models, TrainState
from one_to_many_gan_torch.core.train_step import draw_d_phase, make_d_phase, synthetic_batch


def setup(config: Config, *, seed: int = 0, ada_p: float = 0.0, device=None):
    """-> (models, state, d_phase, generator): ``train.setup``'s, and the D
    phase."""
    models, state, generator = train.setup(config, seed=seed, ada_p=ada_p, device=device)
    return models, state, make_d_phase(config, models), generator


def run_step(config: Config, models: Models, state: TrainState, d_phase, generator):
    """One D phase on a fresh synthetic batch pair and fresh draws."""
    b = config["training"]["batch_size"]
    prints = synthetic_batch(generator, b, models.image_size, models.channels)
    marks = synthetic_batch(generator, b, models.image_size, models.channels)
    return d_phase(state, prints, marks, draw_d_phase(generator, config, models))


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("config")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ada-p", type=float, default=0.0)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    config = load_config(args.config)
    if config["tpu"]["data_parallel"] > 1:
        msg = (f"tpu.data_parallel = {config['tpu']['data_parallel']!r} is not ported to "
               "train_d (one process); train.py runs data-parallel steps; set it to 1")
        raise NotImplementedError(msg)
    if config["training"]["deterministic_cuda_kernels"]:
        set_cublas_workspace()  # before anything touches CUDA
    models, state, d_phase, generator = setup(
        config, seed=args.seed, ada_p=args.ada_p, device=args.device
    )
    for step in range(args.steps):
        t0 = time.perf_counter()
        state, metrics = run_step(config, models, state, d_phase, generator)
        if models.device.type == "cuda":
            torch.cuda.synchronize(models.device)
        ms = (time.perf_counter() - t0) * 1e3
        line = {k: float(v) for k, v in metrics.items()}
        line.update(step=step, ms=ms, buffer_count=int(state.buffer.count),
                    ada_count=int(state.ada.count), device=str(models.device))
        print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
