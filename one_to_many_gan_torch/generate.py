"""1->N inference CLI: one shoeprint -> N style-conditioned shoemarks.

    python -m one_to_many_gan_torch.generate config.toml \
        --source path/to/shoeprint.png --n 64 --out out_dir \
        [--artifact model.npz] [--seed 0] [--theta 1.0] [--device cpu] [--int8]

Generates with an inference artifact (``--artifact``: ``export.py``'s,
or the JAX package's) or else with the configured run's latest
checkpoint (``<run>/models/<step>.tar``; its EMA generator when it has
one); without either, with fresh weights from ``--seed`` and a warning.
Encodes the source once and decodes all N styles in one batched call on
the device (``cuda`` unless ``--device cpu``; raises without a GPU). The
style draws come from ``torch.Generator(device).manual_seed(seed)``.
``--int8`` decodes with the modulated convs on int8 codes (``serve.py``'s
int8 serving; the same weights).
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np


def generate(
    config_path: str,
    source: str,
    n: int,
    out_dir: str,
    seed: int = 0,
    theta: float = 1.0,
    artifact: str | None = None,
    device: str | None = None,
    int8: bool = False,
) -> list[Path]:
    import torch
    from PIL import Image

    from one_to_many_gan_torch.config import load_config
    from one_to_many_gan_torch.convert import from_jax_params
    from one_to_many_gan_torch.core.inference import make_inference_fns
    from one_to_many_gan_torch.core.state import Models
    from one_to_many_gan_torch.data.datasets import _load_image
    from one_to_many_gan_torch.data.pipeline import normalize_u8
    from one_to_many_gan_torch.export import load_inference_artifact
    from one_to_many_gan_torch.migrate import latest_checkpoint, load_inference_weights

    config = load_config(config_path)
    models = Models(config, device=device, seed=seed, int8_decode=int8)
    if artifact is not None:
        params_g, params_m, step, _ema = load_inference_artifact(artifact)
        from_jax_params(models, params_g, params_m)
        print(f"loaded inference artifact at step {step}")
    else:
        ckpt, step = latest_checkpoint(config)
        if ckpt is None:
            print("warning: no checkpoint found; generating with fresh weights")
        else:
            ema = load_inference_weights(ckpt, models)
            print(f"loaded checkpoint at step {step}" + (" (EMA generator)" if ema else ""))

    img_u8 = _load_image(
        Path(source),
        tuple(config["data"]["image_size"]),
        config["data"]["image_channels"],
    )
    img = torch.from_numpy(normalize_u8(img_u8[None])[0])
    gen = torch.Generator(models.device).manual_seed(seed)
    z = torch.randn((n, models.w_dim), generator=gen, device=models.device)

    _, one_to_many, _ = make_inference_fns(models)
    outs = one_to_many(img, z, theta).float().cpu().numpy()

    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    paths = []
    for i, arr in enumerate(np.clip((outs + 1.0) * 127.5, 0, 255).astype(np.uint8)):
        p = out / f"shoemark_{i:04d}.png"
        Image.fromarray(arr.squeeze(-1) if arr.shape[-1] == 1 else arr).save(p)
        paths.append(p)
    print(f"wrote {len(paths)} images to {out}")
    return paths


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("config")
    ap.add_argument("--source", required=True)
    ap.add_argument("--n", type=int, default=64)
    ap.add_argument("--out", default="generated")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--theta", type=float, default=1.0)
    ap.add_argument(
        "--artifact",
        default=None,
        help="an exported inference artifact (npz); without it, the run's latest "
        "checkpoint, or fresh weights from --seed when it has none",
    )
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument(
        "--int8",
        action="store_true",
        help="run the decoder's modulated convs on int8 codes (the int8 conv "
        "kernel on the card's tensor cores); the same weights",
    )
    args = ap.parse_args(argv)
    generate(args.config, args.source, args.n, args.out, args.seed, args.theta,
             artifact=args.artifact, device=args.device, int8=args.int8)


if __name__ == "__main__":
    main()
