"""The serving models, built once from a config: generator + mapping network.

The discriminator and the style extractor come with the training port.
"""

from __future__ import annotations

import torch

from one_to_many_gan_torch.config import Config
from one_to_many_gan_torch.device import compute_dtype, disable_tf32, select_device
from one_to_many_gan_torch.models import Generator, MappingNetwork


class Models:
    """Generator and mapping network on one device, in eval mode.

    Fresh weights are N(0, 1) draws from ``torch.manual_seed(seed)``
    (in a forked RNG state, so the caller's global RNG is untouched);
    ``convert.from_jax_params`` overwrites them with trained weights.
    ``device`` None means CUDA, and raises without a GPU
    (``device.select_device``). A float32 config on CUDA turns TF32 off
    for the process (``device.disable_tf32``).
    """

    def __init__(self, config: Config, *, device: str | torch.device | None = None,
                 seed: int = 0):
        arch = config["architecture"]
        data = config["data"]
        self.device = select_device(device)
        self.dtype = compute_dtype(config)
        if self.device.type == "cuda" and self.dtype == torch.float32:
            disable_tf32()
        self.image_size = tuple(data["image_size"])
        self.channels = data["image_channels"]
        self.w_dim = arch["w_dim"]
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            self.generator = Generator(
                channels=self.channels,
                w_dim=arch["w_dim"],
                image_size=self.image_size,
                min_latent_resolution=arch["min_latent_resolution"],
                n_resnet_blocks=arch["n_resnet_blocks"],
                dtype=self.dtype,
            )
            self.mapping = MappingNetwork(
                features=arch["w_dim"], n_layers=arch["mapping_network_layers"]
            )
        for module in (self.generator, self.mapping):
            module.requires_grad_(False).eval().to(self.device)
        self.n_style_blocks = self.generator.n_style_blocks
