"""Evaluation: the training log, the image grids and validation FID/KID.

The JAX package's ``core/evaluation.py``, on the port's models:

- ``Logger``: the reference's 11 series and its log line, byte for byte
  (``%.6g`` values, the trailing ``", "``). The metrics stay on the
  device as 0-d tensors; ``summary`` moves them to the host with one
  stacked ``.cpu()`` per log interval, not one sync per metric per step.
- ``image_checkpoint``: the 9x8 translation grid (a source print over
  its 8 translations, one column per source) and the 5x8 decoding grid
  (print, its reconstruction, its translation with the mark's style,
  the mark, the mark's reconstruction).
- ``val_checkpoint``: ``n_evaluation_images`` translations at θ = 1
  without style mixing, written as PNGs, and their FID and KID against
  the shoemark train images, tagged with the extractor's name in the
  text log and in ``metrics.jsonl``.

Both sample from ``eval_generator(state)``: the EMA generator when
``tpu.ema_decay > 0``, else the trained one; the mapping network and the
style extractor are the trained ones (the JAX package's
``eval_params_g``).

``save_grid`` keeps the reference's layout (rows x cols, column-major
input, each image min-max scaled on its own) but composes the grid with
numpy and PIL, without matplotlib: its figure styling (axes, dpi, bbox)
is not kept. The cells are separated by a white gap of a tenth of a
cell. Steps here count completed training steps: ``translation_16.png``
and ``Step 16 | fid: ...`` after the 16th step, as in the JAX package.
"""

from __future__ import annotations

import json
import math
from pathlib import Path

import numpy as np
import torch
from PIL import Image

from one_to_many_gan_torch.config import Config
from one_to_many_gan_torch.core.state import Models, TrainState, eval_generator
from one_to_many_gan_torch.models import apply_domain, draw_style_rngs


class Logger:
    """Accumulate per-step metrics; emit the reference's mean-summary line."""

    SERIES = (
        "total_disc_losses",
        "disc_real_accs",
        "disc_fake_accs",
        "total_gen_losses",
        "gan_losses",
        "idt_losses",
        "rec_losses",
        "kl_losses",
        "path_losses",
        "style_losses",
        "ada_ps",
    )
    # the fused step's metric behind each series
    METRICS = (
        "disc_loss",
        "disc_real_acc",
        "disc_fake_acc",
        "total_gen_loss",
        "gan_loss",
        "identity_loss",
        "reconstruction_loss",
        "kl_loss",
        "path_loss",
        "style_loss",
        "ada_p",
    )

    def __init__(self, training_steps: int):
        self.training_steps = training_steps
        self.initialise_trackers()

    def initialise_trackers(self):
        self._steps: list[dict] = []

    def append_metrics(self, metrics: dict):
        """Keep one step's metrics (0-d tensors, left on their device)."""
        self._steps.append({k: metrics[k] for k in self.METRICS})

    def summary(self, step: int) -> tuple[str, dict[str, float]]:
        """-> (the reference-format line, the interval's means by series
        name, in sorted order); resets the trackers. The means are numpy's
        float32 means of each series, as the JAX package's."""
        values = torch.stack([
            torch.as_tensor(m[k]).reshape(()).float()
            for m in self._steps for k in self.METRICS
        ]).cpu().numpy().reshape(len(self._steps), len(self.METRICS))
        # by name, as the JAX package's device_get of the series' dict gives them
        mean = {
            name: float(np.mean(np.ascontiguousarray(values[:, j])))
            for j, name in sorted(enumerate(self.SERIES), key=lambda jn: jn[1])
        }
        string = (
            f"Step: {step}/{self.training_steps}, "
            f"D loss: {mean['total_disc_losses']:.6g}, "
            f"D real/fake acc: {mean['disc_real_accs']:.6g}"
            f"/{mean['disc_fake_accs']:.6g}, "
            f"Total G loss: {mean['total_gen_losses']:.6g}, "
            f"Gan loss {mean['gan_losses']:.6g}, "
            f"Idt loss {mean['idt_losses']:.6g}, "
            f"Rec loss {mean['rec_losses']:.6g}, "
            f"KL loss {mean['kl_losses']:.6g}, "
            f"Path loss {mean['path_losses']:.6g}, "
            f"Style loss: {mean['style_losses']:.6g}, "
            f"ADA: {mean['ada_ps']:.6g}, "
        )
        self.initialise_trackers()
        return string, mean


def to_display(img: np.ndarray) -> np.ndarray:
    """Per-image min-max normalize to [0,1] (the reference's save_grid)."""
    lo, hi = img.min(), img.max()
    return (img - lo) / (hi - lo + 1e-12)


def save_grid(
    columns: list[list[np.ndarray]], save_path: Path | str, grid_size: tuple[int, int]
) -> None:
    """Save a grid of [H, W, C] images; ``columns`` is column-major like
    the reference's: ``columns[c][r]`` is the image at (row r, col c)."""
    rows, cols = grid_size
    h, w, c = np.asarray(columns[0][0]).shape
    gap = max(1, h // 10)
    canvas = np.full((rows * h + (rows - 1) * gap, cols * w + (cols - 1) * gap, c), 255,
                     np.uint8)
    for col in range(cols):
        for row in range(rows):
            img = to_display(np.asarray(columns[col][row], np.float32))
            y, x = row * (h + gap), col * (w + gap)
            canvas[y : y + h, x : x + w] = np.round(img * 255.0).astype(np.uint8)
    Image.fromarray(canvas[:, :, 0] if c == 1 else canvas).save(save_path, compress_level=1)


def run_dir(config: Config) -> Path:
    return config["training"]["checkpoint_directory"] / config["training"]["training_run"]


def _gather(iterator, n: int) -> np.ndarray:
    """Draw batches until n samples are collected."""
    chunks = []
    total = 0
    while total < n:
        b = next(iterator)
        chunks.append(b)
        total += b.shape[0]
    return np.concatenate(chunks)[:n]


def _nchw(images: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(images)).to(device).permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> np.ndarray:
    return x.float().permute(0, 2, 3, 1).cpu().numpy()


def _styles(models: Models, state: TrainState, generator: torch.Generator, b: int):
    """``b`` style stacks at θ = 1, without mixing."""
    n_blocks = models.n_style_blocks
    rngs = draw_style_rngs(generator, b, models.w_dim, n_blocks, 0.0)
    return apply_domain(state.mapping.style_vector(rngs, n_blocks, mix_styles=False), 1.0)


@torch.no_grad()
def image_checkpoint(
    step: int,
    config: Config,
    models: Models,
    state: TrainState,
    shoeprint_iter,
    shoemark_iter,
    generator: torch.Generator,
) -> None:
    """Save ``images/translation_{step}.png`` (9x8) and
    ``images/decoding_{step}.png`` (5x8); the style draws come from
    ``generator``."""
    gen, extractor = eval_generator(state), state.extractor
    device, n_blocks = models.device, models.n_style_blocks
    out_dir = run_dir(config) / "images"
    out_dir.mkdir(parents=True, exist_ok=True)

    prints = _gather(shoeprint_iter, 8)
    marks = _gather(shoemark_iter, 8)
    w = _styles(models, state, generator, 8)
    print_latents = gen.encode(_nchw(prints, device))
    mark_latents = gen.encode(_nchw(marks, device))

    # Translation grid: per column, one source x 8 styles in one decode.
    columns = []
    for col in range(8):
        latent_n = print_latents[col][None].expand(8, *print_latents.shape[1:])
        sweep = _nhwc(gen.decode(latent_n, w))
        columns.append([prints[col], *list(sweep)])
    save_grid(columns, out_dir / f"translation_{step}.png", (9, 8))

    # Decoding grid.
    w0 = torch.zeros((n_blocks, 8, models.w_dim), dtype=torch.float32, device=device)
    recon_prints = _nhwc(gen.decode(print_latents, w0))
    mark_w = extractor(_nchw(marks, device))
    mark_w_stack = mark_w[None].expand(n_blocks, *mark_w.shape)
    recon_marks = _nhwc(gen.decode(mark_latents, mark_w_stack))
    translated = _nhwc(gen.decode(print_latents, mark_w_stack))
    decoding = [
        [prints[c], recon_prints[c], translated[c], marks[c], recon_marks[c]]
        for c in range(8)
    ]
    save_grid(decoding, out_dir / f"decoding_{step}.png", (5, 8))


@torch.no_grad()
def val_checkpoint(
    step: int,
    config: Config,
    models: Models,
    state: TrainState,
    shoeprint_val_iter,
    generator: torch.Generator,
    *,
    real_images: np.ndarray,
    reals_cache: dict | None = None,
) -> tuple[float, float]:
    """Translate ``n_evaluation_images`` val prints at θ = 1 (no mixing;
    draws from ``generator``), save them as ``val/{i}.png``, and log the
    FID and KID of their features against ``real_images``'.

    ``reals_cache``: a per-run dict that keeps the reals' features by
    extractor name (the reals never change within a run).
    """
    from one_to_many_gan_torch.metrics import default_extractor
    from one_to_many_gan_torch.metrics.fid import compute_stats, frechet_distance, kernel_distance

    val_dir = run_dir(config) / "val"
    val_dir.mkdir(parents=True, exist_ok=True)
    n_eval = config["evaluation"]["n_evaluation_images"]
    batch = config["evaluation"]["inference_batch_size"]

    generated = []
    i = 0
    for _ in range(math.ceil(n_eval / batch)):
        images = _nchw(next(shoeprint_val_iter), models.device)
        w = _styles(models, state, generator, images.shape[0])
        out = _nhwc(eval_generator(state)(images, w))
        out_u8 = np.clip((out + 1.0) * 127.5, 0, 255).astype(np.uint8)
        for img in out_u8:
            Image.fromarray(img.squeeze(-1) if img.shape[-1] == 1 else img).save(
                val_dir / f"{i}.png"
            )
            i += 1
        generated.append(out_u8)
    generated = np.concatenate(generated)[:n_eval]

    extractor, extractor_name = default_extractor(
        require_inception=config["tpu"]["require_inception_fid"], device=models.device
    )
    gen_feats = extractor(generated)
    if reals_cache is not None and extractor_name in reals_cache:
        real_feats = reals_cache[extractor_name]
    else:
        real_feats = extractor(real_images)
        if reals_cache is not None:
            reals_cache[extractor_name] = real_feats
    fid_score = frechet_distance(compute_stats(gen_feats), compute_stats(real_feats))
    kid_score = kernel_distance(gen_feats, real_feats, subset_size=min(1000, n_eval))

    log = f"Step {step} | fid: {fid_score}, kid: {kid_score} [{extractor_name}]"
    print(log)
    path = run_dir(config)
    path.mkdir(parents=True, exist_ok=True)
    with (path / "log").open("a") as f:
        f.write(log + "\n")
    with (path / "metrics.jsonl").open("a") as f:
        record = {"step": step, "fid": fid_score, "kid": kid_score,
                  "fid_extractor": extractor_name}
        f.write(json.dumps(record) + "\n")
    return fid_score, kid_score
