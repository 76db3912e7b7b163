"""Programmatic config presets (dry runs, tests)."""

from __future__ import annotations

from pathlib import Path

from one_to_many_gan_torch.config import _TPU_DEFAULTS, Config, _validate


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
