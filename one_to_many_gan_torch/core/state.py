"""The models, built once from a config, and the training state.

``Models`` holds the generator and mapping network, which serving and
training share. ``TrainState`` adds what only training needs, the
discriminator first: it carries what the discriminator phase of training
reads and writes. The style extractor and the generator-side optimizers
come with the generator phase.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from one_to_many_gan_torch.augment.controller import AdaState, init_ada_state
from one_to_many_gan_torch.config import Config
from one_to_many_gan_torch.core.buffer import BufferState, init_buffer
from one_to_many_gan_torch.device import compute_dtype, disable_tf32, select_device
from one_to_many_gan_torch.models import Discriminator, Generator, MappingNetwork


class Models:
    """Generator and mapping network on one device, in eval mode (neither
    has a train-time behaviour), requiring no gradient.

    Fresh weights are N(0, 1) draws from ``torch.manual_seed(seed)``
    (in a forked RNG state, so the caller's global RNG is untouched),
    generator first, then mapping; ``convert.from_jax_params`` overwrites
    them with trained weights. ``device`` None means CUDA, and raises
    without a GPU (``device.select_device``). A float32 config on CUDA
    turns TF32 off for the process (``device.disable_tf32``).
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


def make_optimizers(
    config: Config, discriminator: nn.Module
) -> dict[str, torch.optim.Optimizer]:
    """Adam for the discriminator, as ``optax.adam(lr, b1, b2, eps=1e-8)``:
    torch's bias-corrected update ``lr/bc1 * m / (sqrt(v)/sqrt(bc2) + eps)``
    is optax's ``lr * m_hat / (sqrt(v_hat) + eps)`` rearranged."""
    opt = config["optimisation"]
    return {
        "d": torch.optim.Adam(
            discriminator.parameters(),
            lr=opt["learning_rate"],
            betas=tuple(opt["adam_betas"]),
            eps=1e-8,
        ),
    }


@dataclasses.dataclass
class TrainState:
    """What the discriminator phase reads and writes. The modules and the
    optimizer are updated in place (as torch does); ``ada`` and
    ``buffer`` are replaced by each phase."""

    step: int
    generator: Generator
    mapping: MappingNetwork
    discriminator: Discriminator
    opt_d: torch.optim.Optimizer
    ada: AdaState
    buffer: BufferState


def init_train_state(config: Config, models: Models, *, seed: int = 0) -> TrainState:
    """The state of a fresh run around ``models``: a discriminator with
    N(0, 1) weights from ``torch.manual_seed(seed)`` (forked RNG, as
    ``Models``; in eval mode, on the models' device and in their compute
    dtype), its Adam, ADA at p = 0 and an empty replay buffer."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        discriminator = Discriminator(models.channels, dtype=models.dtype)
    discriminator.eval().to(models.device)
    h, w = models.image_size
    return TrainState(
        step=0,
        generator=models.generator,
        mapping=models.mapping,
        discriminator=discriminator,
        opt_d=make_optimizers(config, discriminator)["d"],
        ada=init_ada_state(models.device),
        buffer=init_buffer(
            config["training"]["image_buffer_size"], (h, w, models.channels), models.device
        ),
    )
