"""Training dynamics over several seeds, in either package, at a small size.

``scripts/compare_dynamics.py`` holds one run against one run. Two runs
of one package with different seeds can lie further apart than its
bounds, so one seed a package cannot tell a difference between the
packages from the spread between seeds. This script runs the same small
configuration through the JAX package's or the PyTorch port's
``Trainer`` for several seeds (``training.random_seed``: the weights,
the data order and every draw), and compares the packages' final-quarter
means against their seeds' spread.

    python scripts/dynamics_seed_spread.py jax   OUT --seeds 0 1 2 3
    python scripts/dynamics_seed_spread.py torch OUT --seeds 0 1 2 3 [--device cpu]
    python scripts/dynamics_seed_spread.py compare OUT

The configuration is ``scripts/train_dynamics.py``'s below 256x256
(``min_latent_resolution`` = size / 4, 64 synthetic images a domain,
buffer 32, the small ADA window), float32, the lazy path term every 8
steps, groups of 10 steps, the JAX package's XLA warp (its Pallas warp
runs interpreted off a TPU; its compiled programs are cached in
``OUT/jax_cache`` for the later seeds). Each run writes
``OUT/<package>_seed<seed>.json`` in the schema of
``docs/dynamics/dynamics_log_*.json``. ``compare`` prints, for each
logged series, each package's mean and sample standard deviation over
its seeds of the final-quarter mean, and the difference of the two
means in units of the standard error of that difference (Welch's t).
"""

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402

N_DATA, PATH_INTERVAL, STEPS_PER_CALL = 64, 8, 10
SERIES = {
    "rec": "rec_losses", "idt": "idt_losses", "style": "style_losses",
    "kl": "kl_losses", "path": "path_losses", "gan": "gan_losses",
    "d_loss": "disc_losses", "ada_p": "ada_ps",
}


def _config(presets, size, batch, steps, seed, tmp, log, cache_dir):
    return presets.tiny_config(
        (size, size),
        batch,
        min_latent=size // 4,
        w_dim=6,
        training={
            "training_steps": steps,
            "random_seed": seed,
            "image_buffer_size": 32,
            "checkpoint_directory": tmp,
            "training_run": "dynamics",
        },
        ada={"ada_overfitting_measurement_n_images": 256,
             "ada_adjustment_size": 5.12e-4 * 4},
        evaluation={
            "log_interval": log,
            "checkpoint_interval": steps,
            "n_evaluation_images": 16,
            "inference_batch_size": 8,
        },
        tpu={
            "precision": "float32",
            "steps_per_call": STEPS_PER_CALL,
            "resume": False,
            "ada_pallas": False,
            "path_interval": PATH_INTERVAL,
            "keep_checkpoints": 1,
            "compilation_cache_dir": cache_dir,
        },
    )


def run(args) -> None:
    if args.package == "jax":
        from one_to_many_gan_tpu import presets
        from one_to_many_gan_tpu.core.trainer import Trainer
        from one_to_many_gan_tpu.data import synthetic_images

        extra = {}
        # later seeds load the first seed's compiled programs from disk
        cache_dir = str(args.out / "jax_cache")
    else:
        from one_to_many_gan_torch import presets
        from one_to_many_gan_torch.core.trainer import Trainer
        from one_to_many_gan_torch.data import synthetic_images

        extra = {"device": args.device}
        cache_dir = None
    size = args.size
    prints = synthetic_images(N_DATA, (size, size), seed=0)
    marks = synthetic_images(N_DATA, (size, size), seed=777)
    args.out.mkdir(parents=True, exist_ok=True)
    for seed in args.seeds:
        with tempfile.TemporaryDirectory(prefix="dynamics_seed_") as tmp:
            config = _config(presets, size, args.batch, args.steps, seed, tmp, args.log,
                             cache_dir)
            trainer = Trainer(config, shoeprint_images=prints, shoemark_images=marks,
                              verbose=False, **extra)
            history: list[dict] = []
            summary = trainer.logger.summary

            def tapping_summary(step, summary=summary, history=history):
                line, means = summary(step)
                history.append({"step": step, **{k: float(v) for k, v in means.items()}})
                return line, means

            trainer.logger.summary = tapping_summary
            t0 = time.perf_counter()
            trainer.run()
            wall = time.perf_counter() - t0
        payload = {
            "steps": args.steps, "size": size, "batch": args.batch, "split_phases": False,
            "path_interval": PATH_INTERVAL, "wall_s": round(wall, 1),
            "images_per_sec": round(args.steps * args.batch / wall, 2),
            "package": args.package, "seed": seed, "history": history,
        }
        path = args.out / f"{args.package}_seed{seed}.json"
        path.write_text(json.dumps(payload, indent=1))
        kl = final_quarter(history, "kl_losses")
        print(f"{args.package} seed {seed}: {wall:.0f} s, final-quarter kl {kl:.4f} -> {path}",
              flush=True)


def final_quarter(history: list[dict], key: str) -> float:
    n = max(1, len(history) // 4)
    return float(np.mean([h[key] for h in history[-n:]]))


def compare(args) -> None:
    logs: dict[str, list[dict]] = {"jax": [], "torch": []}
    for path in sorted(args.out.glob("*_seed*.json")):
        log = json.loads(path.read_text())
        logs[log["package"]].append(log)
    for package, runs in logs.items():
        if len(runs) < 2:
            sys.exit(f"compare: {package} has {len(runs)} seed(s) under {args.out}; need 2+")
    shapes = {(r["steps"], r["size"], r["batch"]) for runs in logs.values() for r in runs}
    if len(shapes) != 1:
        sys.exit(f"compare: runs of different shapes {sorted(shapes)}")
    steps, size, batch = shapes.pop()
    print(f"{steps} steps, {size}x{size}, batch {batch}; seeds: jax "
          f"{[r['seed'] for r in logs['jax']]}, torch {[r['seed'] for r in logs['torch']]}")
    print(f"{'series':8s} {'jax mean':>10s} {'jax sd':>9s} {'torch mean':>10s} "
          f"{'torch sd':>9s} {'diff %':>8s} {'welch t':>8s}")
    for name, key in SERIES.items():
        a = np.array([final_quarter(r["history"], key) for r in logs["jax"]])
        b = np.array([final_quarter(r["history"], key) for r in logs["torch"]])
        se = np.sqrt(a.var(ddof=1) / len(a) + b.var(ddof=1) / len(b))
        t = (b.mean() - a.mean()) / se if se > 0 else float("nan")
        diff = 100.0 * (b.mean() - a.mean()) / abs(a.mean()) if a.mean() else float("nan")
        print(f"{name:8s} {a.mean():10.5f} {a.std(ddof=1):9.5f} {b.mean():10.5f} "
              f"{b.std(ddof=1):9.5f} {diff:8.1f} {t:8.2f}")


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("package", choices=("jax", "torch", "compare"))
    parser.add_argument("out", type=Path)
    parser.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3])
    parser.add_argument("--steps", type=int, default=600)
    parser.add_argument("--size", type=int, default=32)
    parser.add_argument("--batch", type=int, default=8)
    parser.add_argument("--log", type=int, default=20, help="log interval")
    parser.add_argument("--device", default=None,
                        help="the port's device (default cuda; 'cpu' to run there)")
    args = parser.parse_args()
    if args.package == "compare":
        compare(args)
    else:
        run(args)


if __name__ == "__main__":
    main()
