"""Config system: TOML -> nested dict.

Reads the same schema as the JAX package (``configs/default.toml``): the
six reference sections plus the optional ``[tpu]`` section, whose
defaults are filled in below. Of ``[tpu]`` the port reads ``precision``
("float32" or "bfloat16" activations) and, for training,
``ada_antialias`` and ``path_interval``; ``check_training_options``
refuses the training options it does not run yet. ``ada_pallas`` chooses between two TPU
implementations of the ADA warp; the port always computes the Pallas
kernel's numerics, so it ignores the key; ``compilation_cache_dir`` is a
JAX compile cache, also ignored. The other keys are validated so that
one file configures both packages.
"""

from __future__ import annotations

import math
import tomllib
from pathlib import Path
from typing import Any

Config = dict[str, Any]

_TPU_DEFAULTS: dict[str, Any] = {
    "precision": "float32",
    "data_parallel": -1,
    "spatial_parallel": 1,
    "ema_decay": 0.0,
    "r1_gamma": 0.0,
    "r1_interval": 16,
    "remat": "none",
    "remat_d": "same",
    "split_phases": False,
    "g_loss_split": False,
    "path_interval": 1,
    "steps_per_call": 1,
    "resume": True,
    "native_loader": False,
    "profile_step": 0,
    "ada_antialias": True,
    "ada_supersample": False,
    "ada_pallas": False,
    "prefetch": 2,
    "s2d_pack": False,
    "compilation_cache_dir": "/tmp/jax_cache",
    "keep_checkpoints": 3,
    "halt_on_nonfinite": True,
    "require_inception_fid": False,
    "tensorboard": False,
}

_REQUIRED_SECTIONS = (
    "training",
    "optimisation",
    "ada",
    "evaluation",
    "architecture",
    "data",
)


def _validate(config: dict[str, Any]) -> None:
    for section in _REQUIRED_SECTIONS:
        if section not in config:
            msg = f"config missing required section [{section}]"
            raise KeyError(msg)
    gran = config["optimisation"]["path_loss_jacobian_granularity"]
    if len(gran) != 2 or gran[0] > gran[1]:
        msg = f"path_loss_jacobian_granularity must be [min, max], got {gran}"
        raise ValueError(msg)
    if len(config["data"]["image_size"]) != 2:
        msg = "data.image_size must be [height, width]"
        raise ValueError(msg)
    if config["tpu"]["precision"] not in ("float32", "bfloat16"):
        msg = f"tpu.precision must be float32|bfloat16, got {config['tpu']['precision']}"
        raise ValueError(msg)
    remat = config["tpu"]["remat"]
    if isinstance(remat, bool):  # back-compat with the boolean knob
        remat = "full" if remat else "none"
        config["tpu"]["remat"] = remat
    if remat not in ("none", "conv", "full"):
        msg = f"tpu.remat must be none|conv|full (or bool), got {remat!r}"
        raise ValueError(msg)
    remat_d = config["tpu"]["remat_d"]
    if remat_d not in ("same", "none", "conv", "full"):
        msg = f"tpu.remat_d must be same|none|conv|full, got {remat_d!r}"
        raise ValueError(msg)
    path_interval = config["tpu"]["path_interval"]
    if not isinstance(path_interval, int) or path_interval < 1:
        msg = f"tpu.path_interval must be an int >= 1, got {path_interval!r}"
        raise ValueError(msg)


def load_config(path: Path | str) -> Config:
    """Load a TOML file of hyperparameters into a nested dict; the three
    directory entries become ``Path``s and ``[tpu]`` gets its defaults."""
    path = Path(path)
    with path.open("rb") as f:
        config: dict[str, Any] = tomllib.load(f)

    config["training"]["checkpoint_directory"] = Path(
        config["training"]["checkpoint_directory"]
    )
    config["data"]["shoeprint_data_dir"] = Path(config["data"]["shoeprint_data_dir"])
    config["data"]["shoemark_data_dir"] = Path(config["data"]["shoemark_data_dir"])

    tpu = dict(_TPU_DEFAULTS)
    tpu.update(config.get("tpu", {}))
    config["tpu"] = tpu

    _validate(config)
    return config


def n_downsamples(config: Config) -> int:
    """Encoder/decoder resampling depth:
    ceil(log2(min(image_size) / min_latent_resolution))."""
    min_res = min(config["data"]["image_size"])
    return math.ceil(math.log2(min_res / config["architecture"]["min_latent_resolution"]))


# [tpu] training options the port does not run yet, with their off value.
_NOT_PORTED = {
    "r1_gamma": 0.0, "ema_decay": 0.0, "ada_supersample": False, "g_loss_split": False,
    "split_phases": False, "native_loader": False, "tensorboard": False,
}


def check_training_options(config: Config) -> None:
    """Raise ``NotImplementedError``, naming the key, for a training option
    the port does not run yet: R1 (``r1_gamma > 0``), generator EMA
    (``ema_decay > 0``), the 2x supersampled ADA warp (``ada_supersample``),
    the generator loss's two accumulated sub-backwards (``g_loss_split``),
    the D and G phases as two programs (``split_phases``), rematerialisation
    (``remat`` other than "none"), the C++ data loader (``native_loader``),
    TensorBoard (``tensorboard``), and more than one device
    (``data_parallel`` other than 1 or -1, ``spatial_parallel > 1``; -1, all
    devices, is the one card the port trains on).
    ``training.deterministic_cuda_kernels`` is not refused: ``Models``
    runs it (``device.use_deterministic_kernels``)."""
    tpu = config["tpu"]
    refused = [(key, off) for key, off in _NOT_PORTED.items() if tpu[key]]
    if tpu["remat"] != "none":
        refused.append(("remat", "none"))
    if tpu["data_parallel"] not in (1, -1):
        refused.append(("data_parallel", 1))
    if tpu["spatial_parallel"] > 1:
        refused.append(("spatial_parallel", 1))
    if refused:
        key, off = refused[0]
        msg = (
            f"tpu.{key} = {tpu[key]!r} is not ported to PyTorch yet "
            f"(see ROADMAP.md); set it to {off!r}"
        )
        raise NotImplementedError(msg)
