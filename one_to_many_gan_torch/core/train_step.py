"""The discriminator phase of training.

``make_d_phase(config, models)`` returns
``d_phase(state, d_shoeprints, d_shoemarks, draws) -> (state, metrics)``,
the JAX package's ``d_phase`` (``core/train_step.py::make_phase_fns``) in
the same order:

1. mapping -> generator forward at B, without gradient;
2. the replay buffer;
3. ADA augment of the buffered fakes and of the real marks, at the
   probability entering the phase;
4. one discriminator forward and backward on the packed 2B batch
   (``batch_pack``: row ``k*n + j`` is input ``j``'s sample ``k``);
5. Adam on the discriminator;
6. the ADA controller, fed the mean sign of the real scores.

Steps 1-3 are ``make_d_inputs``, step 4 is ``d_loss_and_grad``; a caller
that compares one D pass across devices calls these two, as ``d_phase``
does. Every draw is injected (``DPhaseDraws``; ``draw_d_phase`` makes them
from a ``torch.Generator``). Batches are NHWC in [-1, 1], as in the JAX
package. The metrics keep the JAX names and stay on the device (0-d
tensors): reading them is the caller's sync.

The generator phase, R1 and EMA are not ported yet (ROADMAP.md);
``make_d_phase`` refuses a config that turns R1, EMA or the supersampled
warp on.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from one_to_many_gan_torch.augment import AugmentDraws, augment, draw_augment, make_ada_update
from one_to_many_gan_torch.config import Config, check_training_options
from one_to_many_gan_torch.core.buffer import (
    BufferDraws,
    BufferState,
    buffer_apply,
    draw_buffer,
)
from one_to_many_gan_torch.core.state import Models, TrainState
from one_to_many_gan_torch.losses import discriminator_confidence, lsgan_d_loss
from one_to_many_gan_torch.models import StyleRngs, apply_domain, draw_style_rngs


def batch_pack(xs, dim: int = 0) -> torch.Tensor:
    """Interleave tensors along ``dim``: row ``k*len(xs) + j`` is ``xs[j]``'s
    row ``k`` (the JAX package's shard-local packing)."""
    stacked = torch.stack(list(xs), dim=dim + 1)
    return stacked.reshape(*stacked.shape[:dim], -1, *stacked.shape[dim + 2 :])


def batch_unpack(x: torch.Tensor, n: int, dim: int = 0) -> tuple[torch.Tensor, ...]:
    """Inverse of ``batch_pack``: the ``n`` interleaved groups."""
    r = x.reshape(*x.shape[:dim], -1, n, *x.shape[dim + 1 :])
    return tuple(r.select(dim + 1, j) for j in range(n))


class DPhaseDraws(NamedTuple):
    """The draws of one D phase (the JAX phase's keys 0-3)."""

    style: StyleRngs  # key 0: the fakes' styles
    buffer: BufferDraws  # key 1
    aug_fake: AugmentDraws  # key 2
    aug_real: AugmentDraws  # key 3


def draw_d_phase(
    generator: torch.Generator, config: Config, models: Models, batch: int | None = None
) -> DPhaseDraws:
    """One D phase's draws from ``generator`` (on the models' device), for
    ``batch`` images (default: the config's batch size)."""
    b = batch or config["training"]["batch_size"]
    device = generator.device
    return DPhaseDraws(
        style=draw_style_rngs(
            generator, b, models.w_dim, models.n_style_blocks,
            config["training"]["style_mixing_prob"],
        ),
        buffer=draw_buffer(generator, b, config["training"]["image_buffer_size"], device),
        aug_fake=draw_augment(generator, b, device),
        aug_real=draw_augment(generator, b, device),
    )


def synthetic_batch(
    generator: torch.Generator, b: int, image_size, channels: int
) -> torch.Tensor:
    """A batch of uniform [-1, 1) NHWC images from ``generator``, for runs
    without a dataset."""
    h, w = image_size
    shape = (b, h, w, channels)
    return torch.rand(shape, generator=generator, device=generator.device) * 2.0 - 1.0


def d_loss_and_grad(discriminator, aug_fake: torch.Tensor, aug_real: torch.Tensor):
    """One discriminator forward and backward on the packed [fake; real]
    batch (NHWC). The gradients go to the parameters' ``.grad`` (set
    anew). -> (loss, real_scores, fake_scores), detached, scores NHWC in
    float32 (float64 for a float64 discriminator)."""
    discriminator.zero_grad(set_to_none=True)
    packed = batch_pack([aug_fake, aug_real]).permute(0, 3, 1, 2)
    scores = discriminator(packed)
    scores = scores.to(torch.promote_types(scores.dtype, torch.float32)).permute(0, 2, 3, 1)
    fake_scores, real_scores = batch_unpack(scores, 2)
    loss = lsgan_d_loss(real_scores, fake_scores)
    loss.backward()
    return loss.detach(), real_scores.detach(), fake_scores.detach()


def make_d_inputs(config: Config, models: Models):
    """-> ``d_inputs(state, d_shoeprints, d_shoemarks, draws)``: steps 1-3
    of the D phase, without gradient, at the ADA probability ``state.ada.p``
    -> (aug_fake, aug_real, buffer): the discriminator's augmented inputs
    (NHWC, in the activation dtype) and the replay buffer after the push
    (its images tensor is ``state.buffer``'s, updated in place)."""
    check_training_options(config)
    antialias = config["tpu"]["ada_antialias"]
    n_blocks = models.n_style_blocks
    device = models.device
    # ADA runs in the activation dtype: its output feeds only the
    # discriminator (the JAX package's choice).
    aug_dtype = models.dtype

    @torch.no_grad()
    def d_inputs(
        state: TrainState, d_shoeprints: torch.Tensor, d_shoemarks: torch.Tensor,
        draws: DPhaseDraws,
    ) -> tuple[torch.Tensor, torch.Tensor, BufferState]:
        p = state.ada.p
        s = state.mapping.style_vector(draws.style, n_blocks, mix_styles=True)
        prints = d_shoeprints.to(device).permute(0, 3, 1, 2).contiguous()
        fakes = state.generator(prints, apply_domain(s, 1.0)).float().permute(0, 2, 3, 1)
        buffered, buffer = buffer_apply(state.buffer, fakes, draws.buffer)
        aug_fake = augment(buffered.to(aug_dtype), p, draws.aug_fake, antialias=antialias)
        aug_real = augment(
            d_shoemarks.to(device, aug_dtype), p, draws.aug_real, antialias=antialias
        )
        return aug_fake, aug_real, buffer

    return d_inputs


def make_d_phase(config: Config, models: Models):
    """-> ``d_phase(state, d_shoeprints, d_shoemarks, draws)``: one
    discriminator update on ``models.device``; ``state`` is updated in
    place and returned with the metrics ``disc_loss``, ``disc_real_acc``,
    ``disc_fake_acc`` and ``ada_p`` (the probability used)."""
    d_inputs = make_d_inputs(config, models)
    ada_cfg = config["ada"]
    ada_update = make_ada_update(
        ada_cfg["ada_overfitting_measurement_n_images"],
        ada_cfg["ada_adjustment_size"],
        config["training"]["batch_size"],
        ada_cfg["discriminator_real_acc_target"],
    )

    def d_phase(
        state: TrainState, d_shoeprints: torch.Tensor, d_shoemarks: torch.Tensor,
        draws: DPhaseDraws,
    ) -> tuple[TrainState, dict[str, torch.Tensor]]:
        p_used = state.ada.p
        aug_fake, aug_real, state.buffer = d_inputs(state, d_shoeprints, d_shoemarks, draws)
        loss, real_scores, fake_scores = d_loss_and_grad(state.discriminator, aug_fake, aug_real)
        state.opt_d.step()
        sign_real = discriminator_confidence(real_scores)
        sign_fake = -discriminator_confidence(fake_scores)
        state.ada = ada_update(state.ada, sign_real)
        return state, {
            "disc_loss": loss,
            "disc_real_acc": sign_real,
            "disc_fake_acc": sign_fake,
            "ada_p": p_used,
        }

    return d_phase
