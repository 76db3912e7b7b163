"""The inference artifact: the generator and the mapping network in one
``.npz``, in the JAX package's layout.

A training checkpoint (``<run>/models/<step>.tar``) holds four networks,
four Adams, ADA and the replay buffer; serving needs two networks. The
artifact holds their leaves flattened as ``g/params/...`` and
``m/params/...`` in the JAX trees' layout (HWIO convs, ``[in, out]``
linears, through ``convert.to_jax_params``), plus ``__step__`` and
``__ema__``: with EMA on (``tpu.ema_decay > 0``; the checkpoint then
carries the EMA generator) the generator leaves are the EMA weights and
``__ema__`` is True, as the JAX package's export writes them. The JAX package's
``export.load_inference_artifact`` reads it, and so does the one here;
the port's server and CLI serve it with ``--artifact``.

    python -m one_to_many_gan_torch.export config.toml --out model.npz [--device cpu]

writes the artifact of the configured run's latest checkpoint.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np


def _unflatten(flat: dict, prefix: str):
    root: dict = {}
    for full_key, value in flat.items():
        parts = full_key.split("/")
        if parts[0] != prefix:
            continue
        node = root
        for part in parts[1:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value
    return root


def export_inference_artifact(config, out_path: Path | str, *, device=None) -> Path:
    """Write the artifact of the configured run's latest checkpoint to
    ``out_path`` (its EMA generator when it has one; the weights pass
    through ``Models`` on ``device``: None means CUDA). Raises
    ``FileNotFoundError`` without a checkpoint."""
    from one_to_many_gan_torch.convert import _flatten, to_jax_params
    from one_to_many_gan_torch.core.state import Models
    from one_to_many_gan_torch.migrate import latest_checkpoint, load_inference_weights

    ckpt, step = latest_checkpoint(config)
    if ckpt is None:
        msg = f"no checkpoint of run {config['training']['training_run']!r} to export"
        raise FileNotFoundError(msg)
    models = Models(config, device=device)
    ema = load_inference_weights(ckpt, models)
    params_g, params_m = to_jax_params(models)
    flat: dict = {}
    _flatten(params_g, "g", flat)
    _flatten(params_m, "m", flat)
    flat["__step__"] = np.int64(step)
    flat["__ema__"] = np.bool_(ema)
    out_path = Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(out_path, **flat)
    return out_path


def load_inference_artifact(path: Path | str):
    """-> (params_g, params_m, step, ema): the JAX variable trees as nested
    dicts of numpy arrays, for ``convert.from_jax_params``."""
    with np.load(Path(path)) as z:
        flat = {k: z[k] for k in z.files}
    step = int(flat.pop("__step__"))
    ema = bool(flat.pop("__ema__"))
    return _unflatten(flat, "g"), _unflatten(flat, "m"), step, ema


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("config")
    ap.add_argument("--out", default="model.npz")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from one_to_many_gan_torch.config import load_config

    path = export_inference_artifact(load_config(args.config), args.out, device=args.device)
    print(f"wrote {path} ({path.stat().st_size / 1e6:.1f} MB)")


if __name__ == "__main__":
    main()
