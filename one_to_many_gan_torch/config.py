"""Config system: TOML -> nested dict.

Reads the same schema as the JAX package (``configs/default.toml``): the
six reference sections plus the optional ``[tpu]`` section, whose
defaults are filled in below. Of ``[tpu]`` the port reads ``precision``
("float32" or "bfloat16" activations) and, for training,
``ada_antialias``, ``ada_supersample``, ``path_interval``, ``ema_decay``,
``r1_gamma``, ``r1_interval``, ``remat``, ``remat_d``, ``split_phases``,
``g_loss_split``, ``native_loader``, ``tensorboard``, ``data_parallel``
and ``spatial_parallel`` (``resolve_data_parallel``: ``data_parallel x
spatial_parallel`` ranks, one card each, each image's rows split over
the spatial ranks: ``parallel/halo.py``). ``ada_pallas`` chooses between two TPU
implementations of the ADA warp; the port always computes the Pallas
kernel's numerics, so it ignores the key; ``s2d_pack`` repacks the
low-channel 3x3 convs space-to-depth for the TPU's matrix unit, the same
conv (which the JAX package holds exact), so the port ignores it too;
``compilation_cache_dir`` is a JAX compile cache, also ignored. The other
keys are validated so that one file configures both packages.
"""

from __future__ import annotations

import math
import tomllib
import warnings
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


def check_training_options(config: Config) -> None:
    """Raise ``ValueError`` for a ``data_parallel`` that is neither -1 nor
    at least 1, or a ``spatial_parallel`` below 1. Every training option
    runs: ``core/train_step.py``, ``core/trainer.py``, ``data/``,
    ``parallel/`` and ``Models`` take them."""
    tpu = config["tpu"]
    dp = tpu["data_parallel"]
    if not isinstance(dp, int) or (dp != -1 and dp < 1):
        msg = f"tpu.data_parallel must be -1 (all visible cards) or >= 1, got {dp!r}"
        raise ValueError(msg)
    sp = tpu["spatial_parallel"]
    if not isinstance(sp, int) or sp < 1:
        msg = f"tpu.spatial_parallel must be an int >= 1, got {sp!r}"
        raise ValueError(msg)


def resolve_data_parallel(config: Config, n_devices: int) -> int:
    """The number of data-parallel ranks (data rows) ``config`` asks for on
    a host with ``n_devices`` cards, as the JAX package's Trainer and
    ``make_mesh`` resolve it: ``spatial_parallel`` must divide the cards;
    -1 takes ``n_devices // spatial_parallel``; a value that does not
    divide ``batch_size`` is clamped to the largest one that does, with a
    warning; ``data_parallel x spatial_parallel`` over the cards raises
    ``ValueError`` (never fewer cards than asked for). The run takes
    ``data_parallel x spatial_parallel`` ranks."""
    check_training_options(config)
    dp = config["tpu"]["data_parallel"]
    sp = config["tpu"]["spatial_parallel"]
    batch_size = config["training"]["batch_size"]
    if n_devices % sp:
        msg = f"tpu.spatial_parallel={sp} must divide the device count {n_devices}"
        raise ValueError(msg)
    if dp == -1:
        dp = n_devices // sp
    dp_req = dp
    while dp > 1 and batch_size % dp != 0:
        dp -= 1
    if dp != dp_req:
        warnings.warn(
            f"tpu.data_parallel={dp_req} does not divide batch_size={batch_size}; "
            f"clamped to {dp}",
            stacklevel=2,
        )
    if dp * sp > n_devices:
        mesh = f"tpu.data_parallel={dp}" if sp == 1 else (
            f"tpu.data_parallel={dp} x tpu.spatial_parallel={sp}")
        msg = f"{mesh} needs {dp * sp} devices, have {n_devices}"
        raise ValueError(msg)
    return dp
