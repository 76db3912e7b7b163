"""The fused training step: the discriminator phase, then the generator phase.

``make_train_step(config, models)`` returns
``train_step(state, batches, draws) -> (state, metrics)``, the JAX
package's ``make_train_step`` (``core/train_step.py``): with ``p_used``
the ADA probability entering the step, ``d_phase`` updates the
discriminator, ADA and the buffer, then ``g_phase`` updates the
generator, mapping network and style extractor against the UPDATED
discriminator, augmenting at ``p_used`` (not at the controller's new p).

``make_d_phase(config, models)`` returns
``d_phase(state, d_shoeprints, d_shoemarks, draws) -> (state, metrics)``:

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
does.

``make_g_phase(config, models)`` returns
``g_phase(state, batches, draws, p_used) -> (state, metrics)``:

1. encode the packed [prints; marks] at 2B; the KL loss over the packed
   latents (then latent noise, when ``architecture.add_latent_noise``);
2. the style extractor on the marks, ``w_t`` from the mapping with
   mixing, and ONE decode at 3B: reconstruction (w = 0), identity (the
   marks' extracted style) and translation (``w_t``); L1 of the first two;
3. ADA augment of the translations at ``p_used``, scored by the
   discriminator (the LSGAN generator loss); the extractor on the
   un-augmented translations against ``w_t[-1]`` (the style-cycle loss);
4. on path steps (``step % tpu.path_interval == 0``) the θ-path term: one
   ``extract`` at 2B at the domains θ ± h/2, weighted by
   ``path_loss_lambda * path_interval`` (the JAX package's joint lazy
   structure; other steps never build it and report ``path_loss`` 0);
5. one backward over the generator, mapping and extractor parameters
   only (the discriminator's are frozen for the phase: no weight
   gradient of it is computed and its ``.grad`` is left as it was);
6. three Adams (generator and extractor at ``learning_rate``, mapping at
   ``mapping_network_learning_rate``), then ``step += 1``.

Steps 1-5 are ``make_g_loss``'s ``g_loss_and_grad``, which a caller that
compares the gradients across devices calls as ``g_phase`` does.

Every draw is injected (``DPhaseDraws``, ``GPhaseDraws``: the JAX phases'
keys 0-3 and 4-9 of one ``split(rng, 10)``; ``draw_step`` makes them from
a ``torch.Generator``). Batches are NHWC in [-1, 1], as in the JAX
package. The metrics keep the JAX names and stay on the device (0-d
tensors): reading them is the caller's sync. R1, EMA, the supersampled
warp and ``g_loss_split`` are not ported yet (ROADMAP.md):
``check_training_options`` refuses a config that turns them on.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple

import torch
from torch import nn

from one_to_many_gan_torch.augment import AugmentDraws, augment, draw_augment, make_ada_update
from one_to_many_gan_torch.config import Config, check_training_options
from one_to_many_gan_torch.core.buffer import (
    BufferDraws,
    BufferState,
    buffer_apply,
    draw_buffer,
)
from one_to_many_gan_torch.core.state import Models, TrainState
from one_to_many_gan_torch.losses import (
    discriminator_confidence,
    kl_loss,
    l1_loss,
    lsgan_d_loss,
    lsgan_g_loss,
    path_loss,
    style_cycle_loss,
)
from one_to_many_gan_torch.models import StyleRngs, apply_domain, draw_style_rngs


class Batches(NamedTuple):
    """The four data batches one fused step consumes (NHWC, [-1, 1])."""

    d_shoeprints: torch.Tensor
    d_shoemarks: torch.Tensor
    g_shoeprints: torch.Tensor
    g_shoemarks: torch.Tensor


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


def draw_d_phase(generator: torch.Generator, config: Config, models: Models) -> DPhaseDraws:
    """One D phase's draws from ``generator`` (on the models' device), for
    the config's batch size."""
    b = config["training"]["batch_size"]
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


def _nchw(x: torch.Tensor, device: torch.device) -> torch.Tensor:
    """An NHWC batch as a contiguous NCHW tensor on ``device``."""
    return x.to(device).permute(0, 3, 1, 2).contiguous()


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
        fakes = state.generator(_nchw(d_shoeprints, device), apply_domain(s, 1.0))
        fakes = fakes.float().permute(0, 2, 3, 1)
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


# ------------------------------------------------------------ the G phase


class GPhaseDraws(NamedTuple):
    """The draws of one G phase (the JAX phase's keys 4-9)."""

    theta: torch.Tensor  # key 4: [B] uniform in [0, 1), the path term's domain
    fin_diff_h: torch.Tensor  # key 5: [B] uniform in the Jacobian granularity
    # key 6: standard normal in the packed latents' NHWC shape and dtype,
    # or None unless architecture.add_latent_noise
    latent_noise: torch.Tensor | None
    style: StyleRngs  # key 7: w_t, the translations' styles
    aug: AugmentDraws  # key 8: the translations' augmentation
    path_style: StyleRngs  # key 9: w_path, the path term's styles


def draw_g_phase(generator: torch.Generator, config: Config, models: Models) -> GPhaseDraws:
    """One G phase's draws from ``generator`` (on the models' device), for
    the config's batch size."""
    b = config["training"]["batch_size"]
    device = generator.device
    lo, hi = config["optimisation"]["path_loss_jacobian_granularity"]
    mixing = config["training"]["style_mixing_prob"]
    theta = torch.rand((b,), generator=generator, device=device)
    fin_diff_h = torch.rand((b,), generator=generator, device=device) * (hi - lo) + lo
    noise = None
    if config["architecture"]["add_latent_noise"]:
        gen = models.generator
        h, w = models.image_size
        for _ in gen.enc_down:
            h, w = h // 2, w // 2
        shape = (2 * b, h, w, gen.latent_features)
        noise = torch.randn(shape, generator=generator, device=device).to(models.dtype)
    return GPhaseDraws(
        theta=theta,
        fin_diff_h=fin_diff_h,
        latent_noise=noise,
        style=draw_style_rngs(generator, b, models.w_dim, models.n_style_blocks, mixing),
        aug=draw_augment(generator, b, device),
        path_style=draw_style_rngs(generator, b, models.w_dim, models.n_style_blocks, mixing),
    )


@contextlib.contextmanager
def _frozen(module: nn.Module):
    """``module``'s parameters require no gradient inside the block."""
    flags = [p.requires_grad for p in module.parameters()]
    module.requires_grad_(False)
    try:
        yield
    finally:
        for p, flag in zip(module.parameters(), flags, strict=True):
            p.requires_grad_(flag)


def make_g_loss(config: Config, models: Models):
    """-> ``g_loss_and_grad(state, batches, draws, p_used, path_step)``:
    steps 1-5 of the G phase (with the path term when ``path_step``) ->
    its metrics; the gradients go to the generator's, mapping network's
    and extractor's ``.grad`` (set anew), and to nothing else."""
    check_training_options(config)
    opt = config["optimisation"]
    scale = float(config["tpu"]["path_interval"])
    antialias = config["tpu"]["ada_antialias"]
    n_blocks = models.n_style_blocks
    device = models.device

    def g_loss_and_grad(
        state: TrainState, batches: Batches, draws: GPhaseDraws, p_used: torch.Tensor,
        path_step: bool,
    ) -> dict[str, torch.Tensor]:
        gen, mapping, extractor = state.generator, state.mapping, state.extractor
        prints = _nchw(batches.g_shoeprints, device)
        marks = _nchw(batches.g_shoemarks, device)
        b = prints.shape[0]
        params = [p for m in (gen, mapping, extractor) for p in m.parameters()]
        with _frozen(state.discriminator):
            latents = gen.encode(batch_pack([prints, marks]))
            kl = kl_loss(latents)
            if draws.latent_noise is not None:
                latents = latents + draws.latent_noise.permute(0, 3, 1, 2)
            print_latent, mark_latent = batch_unpack(latents, 2)

            # styles are float32 (float64 in a float64 copy of the models)
            mark_w = extractor(marks)
            w0 = torch.zeros((n_blocks, b, mark_w.shape[-1]), dtype=mark_w.dtype, device=device)
            w_t = mapping.style_vector(draws.style, n_blocks, mix_styles=True)
            out3 = gen.decode(
                batch_pack([print_latent, mark_latent, print_latent]),
                batch_pack([w0, mark_w[None].expand(n_blocks, -1, -1), w_t], dim=1),
            )
            recon, idt, generated = batch_unpack(out3, 3)
            acc = torch.promote_types(out3.dtype, torch.float32)
            rec_loss = l1_loss(recon.to(acc), prints)
            idt_loss = l1_loss(idt.to(acc), marks)

            # GAN: the translations augmented at p_used, scored by the
            # discriminator as the D phase left it.
            aug = augment(generated.permute(0, 2, 3, 1), p_used, draws.aug, antialias=antialias)
            gan = lsgan_g_loss(state.discriminator(aug.permute(0, 3, 1, 2)).to(acc))
            # Style cycle: the style extracted back from the translations.
            style = style_cycle_loss(w_t[-1], extractor(generated))
            total = (
                gan
                + opt["identity_loss_lambda"] * idt_loss
                + opt["reconstruction_loss_lambda"] * rec_loss
                + opt["kl_loss_lambda"] * kl
                + opt["style_cycle_loss_lambda"] * style
            )
            path = torch.zeros((), dtype=acc, device=device)
            if path_step:
                # Both finite-difference legs in one extract at 2B.
                theta, h = draws.theta, draws.fin_diff_h
                w_path = mapping.style_vector(draws.path_style, n_blocks, mix_styles=True)
                w1 = apply_domain(w_path, torch.clamp(theta + h / 2.0, 0.0, 1.0))
                w2 = apply_domain(w_path, torch.clamp(theta - h / 2.0, 0.0, 1.0))
                feats = gen.extract(
                    batch_pack([print_latent, print_latent]), batch_pack([w1, w2], dim=1)
                )
                legs = [batch_unpack(f, 2) for f in feats]
                path = path_loss([f1 for f1, _ in legs], [f2 for _, f2 in legs], h)
                total = total + opt["path_loss_lambda"] * path * scale
            grads = torch.autograd.grad(total, params)
        for p, g in zip(params, grads, strict=True):
            p.grad = g
        return {
            "total_gen_loss": total.detach(),
            "gan_loss": gan.detach(),
            "reconstruction_loss": rec_loss.detach(),
            "identity_loss": idt_loss.detach(),
            "kl_loss": kl.detach(),
            "style_loss": style.detach(),
            "path_loss": path.detach(),
        }

    return g_loss_and_grad


def make_g_phase(config: Config, models: Models):
    """-> ``g_phase(state, batches, draws, p_used)``: one update of the
    generator, mapping network and style extractor on ``models.device``;
    ``state`` is updated in place and returned with the metrics
    ``total_gen_loss``, ``gan_loss``, ``reconstruction_loss``,
    ``identity_loss``, ``kl_loss``, ``style_loss`` and ``path_loss`` (the
    raw path term on path steps, 0 on the others)."""
    g_loss_and_grad = make_g_loss(config, models)
    interval = config["tpu"]["path_interval"]

    def g_phase(
        state: TrainState, batches: Batches, draws: GPhaseDraws, p_used: torch.Tensor
    ) -> tuple[TrainState, dict[str, torch.Tensor]]:
        metrics = g_loss_and_grad(state, batches, draws, p_used, state.step % interval == 0)
        for opt in (state.opt_g, state.opt_m, state.opt_s):
            opt.step()
        state.step += 1
        return state, metrics

    return g_phase


# ---------------------------------------------------------- the fused step


class StepDraws(NamedTuple):
    """The draws of one fused step."""

    d: DPhaseDraws
    g: GPhaseDraws


def draw_step(generator: torch.Generator, config: Config, models: Models) -> StepDraws:
    """One fused step's draws from ``generator``: the D phase's, then the
    G phase's."""
    return StepDraws(
        d=draw_d_phase(generator, config, models),
        g=draw_g_phase(generator, config, models),
    )


def make_train_step(config: Config, models: Models):
    """-> ``train_step(state, batches, draws) -> (state, metrics)``: the D
    phase, then the G phase at the ADA probability entering the step; the
    metrics of both phases."""
    d_phase = make_d_phase(config, models)
    g_phase = make_g_phase(config, models)

    def train_step(
        state: TrainState, batches: Batches, draws: StepDraws
    ) -> tuple[TrainState, dict[str, torch.Tensor]]:
        p_used = state.ada.p
        state, d_metrics = d_phase(state, batches.d_shoeprints, batches.d_shoemarks, draws.d)
        state, g_metrics = g_phase(state, batches, draws.g, p_used)
        return state, {**d_metrics, **g_metrics}

    return train_step
