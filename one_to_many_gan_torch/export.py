"""Read the JAX package's deployment artifact.

The JAX package's ``export`` module writes the EMA generator (when
enabled) and the mapping network into one compressed ``.npz``: leaves
flattened as ``g/params/...`` and ``m/params/...``, plus ``__step__`` and
``__ema__``. The port serves from that file; it cannot read the Orbax
training checkpoints, which need a JAX library.
"""

from __future__ import annotations

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


def load_inference_artifact(path: Path | str):
    """-> (params_g, params_m, step, ema): the JAX variable trees as nested
    dicts of numpy arrays, for ``convert.from_jax_params``."""
    with np.load(Path(path)) as z:
        flat = {k: z[k] for k in z.files}
    step = int(flat.pop("__step__"))
    ema = bool(flat.pop("__ema__"))
    return _unflatten(flat, "g"), _unflatten(flat, "m"), step, ema
