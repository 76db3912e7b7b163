"""Training-dynamics run of the PyTorch port: does it train like the JAX
package?

The port's counterpart of ``scripts/train_dynamics.py`` at its 256x256
operating point (``docs/dynamics/dynamics_log_256_pi8.json``): the port's
``Trainer`` on structured synthetic data (32 images a domain, prints
from seed 0, marks from seed 777), batch 16, bfloat16 activations,
``min_latent_resolution`` 64, buffer 32, the lazy path term every 8
steps, a small ADA window (256 images, adjustment x4) so that p reacts
within the run, logs every 100 steps, a checkpoint every
``max(500, steps // 4)`` steps with 16 validation images, groups of 10
steps. The JAX run also kept a generator EMA (``ema_decay`` 0.999),
which the port does not have yet; the EMA is read only by evaluation,
so the training losses do not depend on it.

    python scripts/train_dynamics_torch.py [steps] [out_dir] [seed]

``out_dir`` defaults to ``build/dynamics_torch``; ``seed`` (default 0)
is ``training.random_seed``: the weights, the data
order and every draw; the JAX runs all share one seed, so a second seed
of the port measures how far two seeds' trajectories lie apart.

Runs on the GPU. Writes ``<out_dir>/dynamics_log.json`` in the JAX
run's schema (``steps``, ``size``, ``batch``, ``split_phases``,
``path_interval``, ``wall_s``, ``images_per_sec``, ``history``: the
interval means of the 11 logged series) plus the card's name and power
limit, and copies the run's text log and last translation grid there;
checkpoints stay in a temporary directory. Then, on any host:

    python scripts/compare_dynamics.py docs/dynamics/dynamics_log_256.json \\
        <out_dir>/dynamics_log.json overlay.png

Exits 1 unless the reconstruction and identity losses fall by 30 %,
the ADA probability rises above 0.02 and every logged value is finite
(the JAX script's checks).
"""

import json
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402

SIZE, BATCH, PATH_INTERVAL, N_DATA = 256, 16, 8, 32


def main() -> None:
    steps = int(sys.argv[1]) if len(sys.argv) > 1 else 3000
    out = Path(sys.argv[2]) if len(sys.argv) > 2 else Path("build/dynamics_torch")
    seed = int(sys.argv[3]) if len(sys.argv) > 3 else 0

    import torch

    from one_to_many_gan_torch.core.trainer import Trainer
    from one_to_many_gan_torch.data import synthetic_images
    from one_to_many_gan_torch.presets import tiny_config

    if not torch.cuda.is_available():
        print("train_dynamics_torch: no CUDA device", file=sys.stderr)
        sys.exit(2)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    with tempfile.TemporaryDirectory(prefix="dynamics_torch_") as tmp:
        config = tiny_config(
            (SIZE, SIZE),
            BATCH,
            min_latent=64,
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
                "log_interval": 100,
                "checkpoint_interval": max(500, steps // 4),
                "n_evaluation_images": 16,
                "inference_batch_size": 8,
            },
            tpu={
                "precision": "bfloat16",
                "steps_per_call": 10,
                "resume": False,
                "ada_pallas": True,
                "path_interval": PATH_INTERVAL,
                "keep_checkpoints": 1,
            },
        )
        prints = synthetic_images(N_DATA, (SIZE, SIZE), seed=0)
        marks = synthetic_images(N_DATA, (SIZE, SIZE), seed=777)
        trainer = Trainer(config, shoeprint_images=prints, shoemark_images=marks)

        history: list[dict] = []
        summary = trainer.logger.summary

        def tapping_summary(step):
            line, means = summary(step)
            history.append({"step": step, **means})
            return line, means

        trainer.logger.summary = tapping_summary
        t0 = time.perf_counter()
        trainer.run()
        wall = time.perf_counter() - t0

        out.mkdir(parents=True, exist_ok=True)
        run_dir = Path(tmp) / "dynamics"
        shutil.copy(run_dir / "log", out / "run_log.txt")
        shutil.copy(run_dir / "images" / f"translation_{steps}.png",
                    out / f"translation_{steps}.png")
    payload = {
        "steps": steps,
        "size": SIZE,
        "batch": BATCH,
        "split_phases": False,
        "path_interval": PATH_INTERVAL,
        "wall_s": round(wall, 1),
        "images_per_sec": round(steps * BATCH / wall, 2),
        "device": smi,
        "package": "one_to_many_gan_torch",
        "seed": seed,
        "ema": False,
        "history": history,
    }
    (out / "dynamics_log.json").write_text(json.dumps(payload, indent=1))

    q = history[: max(1, len(history) // 4)]
    early_rec = float(np.mean([h["rec_losses"] for h in q]))
    late_rec = float(np.mean([h["rec_losses"] for h in history[-len(q):]]))
    early_idt = float(np.mean([h["idt_losses"] for h in q]))
    late_idt = float(np.mean([h["idt_losses"] for h in history[-len(q):]]))
    first, last = history[0], history[-1]
    print(f"\nwall {wall:.0f}s  ({payload['images_per_sec']} img/s, {smi})")
    print(f"rec  {early_rec:.4f} -> {late_rec:.4f}")
    print(f"idt  {early_idt:.4f} -> {late_idt:.4f}")
    print(f"ada_p {first['ada_ps']:.4f} -> {last['ada_ps']:.4f}")
    print(f"d_real_acc last {last['disc_real_accs']:.3f}")
    ok = True
    for name, val in (("rec", late_rec < 0.7 * early_rec),
                      ("idt", late_idt < 0.7 * early_idt),
                      ("ada_p_rises", last["ada_ps"] > 0.02),
                      ("finite", all(np.isfinite(v) for h in history for v in h.values()))):
        print(f"  {name}: {'OK' if val else 'FAIL'}")
        ok &= bool(val)
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
