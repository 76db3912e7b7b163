"""Programmatic config presets (dry runs, tests), and the copy of a config
written for several devices that a given number of cards runs."""

from __future__ import annotations

import re
from pathlib import Path
from typing import Any

from one_to_many_gan_torch.config import _TPU_DEFAULTS, Config, _validate, load_config


def tiny_config(
    image_size: tuple[int, int],
    batch_size: int,
    *,
    min_latent: int = 8,
    w_dim: int = 6,
    n_resnet_blocks: int = 7,
    buffer_size: int = 8,
    root: str = "/tmp/otm_preset",
    tpu: dict | None = None,
    **section_overrides: dict,
) -> Config:
    """Build a complete in-memory config without touching disk.

    Extra keyword args named after config sections (``training=...``,
    ``evaluation=...``, ...) merge key-by-key into that section.
    """
    config = {
        "training": {
            "batch_size": batch_size,
            "random_seed": 0,
            "training_steps": 10,
            "image_buffer_size": buffer_size,
            "style_mixing_prob": 0.9,
            "deterministic_cuda_kernels": False,
            "gpu_number": 0,
            "checkpoint_directory": Path(root),
            "training_run": "preset",
        },
        "optimisation": {
            "style_cycle_loss_lambda": 5.0,
            "identity_loss_lambda": 5.0,
            "reconstruction_loss_lambda": 5.0,
            "kl_loss_lambda": 0.01,
            "path_loss_lambda": 0.1,
            "path_loss_jacobian_granularity": [0.1, 0.2],
            "learning_rate": 2e-3,
            "mapping_network_learning_rate": 2e-5,
            "adam_betas": [0.5, 0.99],
        },
        "ada": {
            "discriminator_real_acc_target": 0.6,
            "ada_overfitting_measurement_n_images": 4 * batch_size,
            "ada_adjustment_size": 5.12e-4,
        },
        "evaluation": {
            "log_interval": 5,
            "checkpoint_interval": 10,
            "n_evaluation_images": 8,
            "inference_batch_size": 4,
        },
        "architecture": {
            "w_dim": w_dim,
            "add_latent_noise": False,
            "min_latent_resolution": min_latent,
            "n_resnet_blocks": n_resnet_blocks,
            "mapping_network_layers": 2,
        },
        "data": {
            "image_size": list(image_size),
            "image_channels": 1,
            "shoeprint_data_dir": Path(root) / "prints",
            "shoemark_data_dir": Path(root) / "marks",
        },
        "tpu": {**_TPU_DEFAULTS, **(tpu or {})},
    }
    for section, overrides in section_overrides.items():
        if section not in config:
            msg = f"unknown config section {section!r}"
            raise KeyError(msg)
        config[section].update(overrides)
    # directory values may arrive as strings from overrides
    config["training"]["checkpoint_directory"] = Path(
        config["training"]["checkpoint_directory"]
    )
    _validate(config)
    return config


def card_overrides(config: Config, cards: int = 1, *, spatial: bool = False) -> dict[str, Any]:
    """The keys of ``config`` to change so that ``cards`` cards run it, with
    their new values. By default each card is one data-parallel replica:
    ``data_parallel`` ``cards`` and ``batch_size`` ``cards`` times one
    replica's share of the global batch (when the config sets a number of
    replicas; with -1, all visible cards, ``data_parallel`` ``cards`` for
    more than one card and the global batch kept), and ``spatial_parallel``
    1. With ``spatial``, the config's spatial axis is kept: ``data_parallel``
    ``cards // spatial_parallel`` (which must divide) and the global batch
    as written. Only keys whose value changes are listed."""
    if cards < 1:
        msg = f"cards must be >= 1, got {cards}"
        raise ValueError(msg)
    tpu = config["tpu"]
    batch = config["training"]["batch_size"]
    dp = tpu["data_parallel"]
    current = {"data_parallel": dp, "batch_size": batch,
               "spatial_parallel": tpu["spatial_parallel"]}
    if spatial:
        sp = tpu["spatial_parallel"]
        if cards % sp:
            msg = f"spatial_parallel={sp} must divide the {cards} cards"
            raise ValueError(msg)
        return {k: v for k, v in {"data_parallel": cards // sp}.items() if current[k] != v}
    want: dict[str, Any] = {}
    if dp != -1:
        want = {"data_parallel": cards, "batch_size": batch // dp * cards}
    elif cards > 1:
        want = {"data_parallel": cards}
    want["spatial_parallel"] = 1
    return {k: v for k, v in want.items() if current[k] != v}


def _toml_value(value: Any) -> str:
    if isinstance(value, bool):
        return "true" if value else "false"
    if isinstance(value, (str, Path)):
        return '"' + str(value).replace("\\", "\\\\").replace('"', '\\"') + '"'
    return repr(value)


def write_card_config(src: Path | str, dst: Path | str, *, cards: int = 1,
                      spatial: bool = False, **values: Any) -> dict[str, Any]:
    """Write a copy of the TOML file ``src`` to ``dst`` that ``cards`` cards
    run: ``card_overrides`` of it (``spatial``: keeping its spatial axis),
    then ``values`` (other keys, such as the data folders), each by
    replacing its ``key = ...`` line, which must be the file's only line for
    that key. -> every key changed, with its new value, in that order."""
    text = Path(src).read_text()
    changes = {**card_overrides(load_config(src), cards, spatial=spatial), **values}
    for key, value in changes.items():
        line = re.compile(rf"(?m)^{re.escape(key)} = .*$")
        if len(line.findall(text)) != 1:
            msg = f"{src}: expected one line for {key!r}, found {len(line.findall(text))}"
            raise ValueError(msg)
        new = f"{key} = {_toml_value(value)}"
        text = line.sub(lambda _, new=new: new, text)
    Path(dst).write_text(text)
    load_config(dst)  # the copy must load and validate
    return changes
