"""The models, built once from a config, and the training state.

``Models`` holds the generator and mapping network, which serving and
training share, without gradients. ``TrainState`` adds what only
training needs: the discriminator, the style extractor, the four Adams
(discriminator, generator, mapping, extractor), the ADA state, the
replay buffer and, with ``tpu.ema_decay > 0``, the generator's EMA
(``ema_generator``, which evaluation, the artifact and serving read:
``eval_generator``), and it turns gradients on for the generator and
mapping.
"""

from __future__ import annotations

import copy
import dataclasses

import torch
from torch import nn

from one_to_many_gan_torch.augment.controller import AdaState, init_ada_state
from one_to_many_gan_torch.config import Config
from one_to_many_gan_torch.core.buffer import BufferState, init_buffer
from one_to_many_gan_torch.device import (
    compute_dtype,
    disable_tf32,
    select_device,
    use_deterministic_kernels,
)
from one_to_many_gan_torch.models import (
    Discriminator,
    Generator,
    MappingNetwork,
    StyleExtractor,
)


class Models:
    """Generator and mapping network on one device, in eval mode (neither
    has a train-time behaviour), requiring no gradient.

    Fresh weights are N(0, 1) draws from ``torch.manual_seed(seed)``
    (in a forked RNG state, so the caller's global RNG is untouched),
    generator first, then mapping; ``convert.from_jax_params`` overwrites
    them with trained weights. ``device`` None means CUDA, and raises
    without a GPU (``device.select_device``). A float32 config on CUDA
    turns TF32 off for the process (``device.disable_tf32``);
    ``training.deterministic_cuda_kernels = true`` makes the process's
    kernels deterministic (``device.use_deterministic_kernels``), so that
    two runs from one seed give the same bits. ``int8_decode`` builds the
    generator with its decoder's modulated convs on int8 codes, for serving
    and generation only (training refuses it, ``core/train_step.py``); its
    parameters are the float generator's, so the same weights load.
    """

    def __init__(self, config: Config, *, device: str | torch.device | None = None,
                 seed: int = 0, int8_decode: bool = False):
        arch = config["architecture"]
        data = config["data"]
        self.device = select_device(device)
        self.dtype = compute_dtype(config)
        if self.device.type == "cuda" and self.dtype == torch.float32:
            disable_tf32()
        if config["training"]["deterministic_cuda_kernels"]:
            use_deterministic_kernels()
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
                int8_decode=int8_decode,
            )
            self.mapping = MappingNetwork(
                features=arch["w_dim"], n_layers=arch["mapping_network_layers"]
            )
        for module in (self.generator, self.mapping):
            module.requires_grad_(False).eval().to(self.device)
        self.n_style_blocks = self.generator.n_style_blocks
        self.int8_decode = int8_decode


def make_optimizers(
    config: Config, modules: dict[str, nn.Module]
) -> dict[str, torch.optim.Optimizer]:
    """One Adam per network of ``modules`` (keys ``d``, ``g``, ``m``, ``s``:
    discriminator, generator, mapping, extractor), as
    ``optax.adam(lr, b1, b2, eps=1e-8)``: torch's bias-corrected update
    ``lr/bc1 * m / (sqrt(v)/sqrt(bc2) + eps)`` is optax's
    ``lr * m_hat / (sqrt(v_hat) + eps)`` rearranged. The mapping network
    learns at ``mapping_network_learning_rate`` (100x lower in the shipped
    configs), the others at ``learning_rate``."""
    opt = config["optimisation"]
    lrs = {"m": opt["mapping_network_learning_rate"]}
    return {
        key: torch.optim.Adam(
            module.parameters(),
            lr=lrs.get(key, opt["learning_rate"]),
            betas=tuple(opt["adam_betas"]),
            eps=1e-8,
        )
        for key, module in modules.items()
    }


@dataclasses.dataclass
class TrainState:
    """What one training step reads and writes. The modules and the
    optimizers are updated in place (as torch does); ``ada`` and
    ``buffer`` are replaced by the discriminator phase, ``step`` counts
    the generator phases. ``ema_generator`` is the generator's
    exponential moving average (``tpu.ema_decay > 0``; None when EMA is
    off): a third ``Generator`` without gradients, updated after each
    generator phase's Adams."""

    step: int
    generator: Generator
    mapping: MappingNetwork
    discriminator: Discriminator
    extractor: StyleExtractor
    opt_d: torch.optim.Optimizer
    opt_g: torch.optim.Optimizer
    opt_m: torch.optim.Optimizer
    opt_s: torch.optim.Optimizer
    ada: AdaState
    buffer: BufferState
    ema_generator: Generator | None = None


def init_train_state(config: Config, models: Models, *, seed: int = 0) -> TrainState:
    """The state of a fresh run around ``models``: a discriminator, then a
    style extractor, with N(0, 1) weights from ``torch.manual_seed(seed)``
    (forked RNG, as ``Models``; in eval mode, on the models' device and in
    their compute dtype), the four Adams, ADA at p = 0 and an empty replay
    buffer; with ``tpu.ema_decay > 0`` the EMA generator starts as a copy
    of the generator (the JAX package's ``init_train_state``). Gradients
    are turned on for ``models``' generator and mapping network, which
    the state trains."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        discriminator = Discriminator(models.channels, dtype=models.dtype)
        extractor = StyleExtractor(models.channels, models.w_dim, dtype=models.dtype)
    for module in (discriminator, extractor):
        module.eval().to(models.device)
    ema = None
    if config["tpu"]["ema_decay"] > 0:
        ema = copy.deepcopy(models.generator).requires_grad_(False)
    for module in (models.generator, models.mapping):
        module.requires_grad_(True)
    opts = make_optimizers(config, {
        "d": discriminator, "g": models.generator, "m": models.mapping, "s": extractor,
    })
    h, w = models.image_size
    return TrainState(
        step=0,
        generator=models.generator,
        mapping=models.mapping,
        discriminator=discriminator,
        extractor=extractor,
        opt_d=opts["d"],
        opt_g=opts["g"],
        opt_m=opts["m"],
        opt_s=opts["s"],
        ada=init_ada_state(models.device),
        buffer=init_buffer(
            config["training"]["image_buffer_size"], (h, w, models.channels), models.device
        ),
        ema_generator=ema,
    )


def eval_generator(state: TrainState) -> Generator:
    """The generator that evaluation, the artifact and serving sample from:
    the EMA weights when EMA is on (``tpu.ema_decay > 0``), else the
    trained generator (the JAX package's ``eval_params_g``)."""
    return state.ema_generator if state.ema_generator is not None else state.generator
