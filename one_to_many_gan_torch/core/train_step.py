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
   (``batch_pack``: row ``k*n + j`` is input ``j``'s sample ``k``); with
   ``tpu.r1_gamma > 0``, on the steps where ``step % tpu.r1_interval == 0``
   (lazy R1), ``r1_gamma / 2 * r1_penalty`` on the augmented reals in
   float32 (a double backward through D) is added to the loss and its
   gradients to D's; the other steps are the ``r1_gamma = 0`` update;
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
   gradient of it is computed and its ``.grad`` is left as it was); with
   ``tpu.g_loss_split``, two accumulated sub-backwards instead, each
   encoding anew: {kl, rec, idt, gan, style}, then (on path steps) the
   path term, its gradient scaled by the interval (the JAX package's
   memory lever: each holds a fraction of the joint graph);
6. three Adams (generator and extractor at ``learning_rate``, mapping at
   ``mapping_network_learning_rate``); with ``tpu.ema_decay > 0`` the EMA
   generator moves, ``e = e * decay + p * (1 - decay)`` in float32; then
   ``step += 1``.

Steps 1-5 are ``make_g_loss``'s ``g_loss_and_grad``, which a caller that
compares the gradients across devices calls as ``g_phase`` does.

Every draw is injected (``DPhaseDraws``, ``GPhaseDraws``: the JAX phases'
keys 0-3 and 4-9 of one ``split(rng, 10)``; ``draw_step`` makes them from
a ``torch.Generator``). Batches are NHWC in [-1, 1], as in the JAX
package. The metrics keep the JAX names and stay on the device (0-d
tensors): reading them is the caller's sync.

**Data parallelism.** Each ``make_*`` takes an optional ``group``
(``parallel.DataParallel``); without one the step is one process's. With
one, the same program runs in every rank: the batches are this rank's
rows of the global batch, the draws the global batch's (``train_step``
slices them: ``shard_draws``; the buffer's stay global), and the step
computes what one process computes at the global batch, up to float
reassociation: the replay buffer all-gathers the fakes
(``core/buffer.py``), the KL term's moments are the global batch's
(``losses.kl_loss``), each phase's gradients are averaged over the ranks
before its Adam (one flat buffer per optimiser:
``DataParallel.reduce_gradients``; once per phase, after both of
``g_loss_split``'s sub-backwards), and the logged metrics are global
means; so ADA's controller sees the global real-sign mean and ``p``, the
parameters and the buffer stay identical on every rank.
``make_ada_update`` keeps the config's global ``batch_size``.

``tpu.ada_supersample`` takes the 2x supersampled warp in all three
augment calls (the D phase's fakes and reals, the G phase's
translations). ``tpu.remat`` ("none", "conv", "full"; ``ops/remat.py``)
recomputes the G phase's model passes in its backward: the encode, the
decode, the extract, both extractor passes and the discriminator's
scoring; ``tpu.remat_d`` (``"same"`` follows ``remat``) the D phase's
discriminator pass. The R1 term's pass is never wrapped, as in the JAX
package. Losses and gradients are bitwise the same under every mode.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple

import torch
from torch import nn

from one_to_many_gan_torch.augment import (
    AugmentDraws,
    ColorDraws,
    GeometricDraws,
    augment,
    draw_augment,
    make_ada_update,
)
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
    r1_penalty,
    style_cycle_loss,
)
from one_to_many_gan_torch.models import StyleRngs, apply_domain, draw_style_rngs
from one_to_many_gan_torch.ops.remat import make_ckpt


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


def _remat_modes(config: Config) -> tuple[str, str]:
    """(G phase, D phase) rematerialisation modes of ``config``."""
    g_mode, d_mode = config["tpu"]["remat"], config["tpu"]["remat_d"]
    return g_mode, g_mode if d_mode == "same" else d_mode


def d_loss_and_grad(
    discriminator, aug_fake: torch.Tensor, aug_real: torch.Tensor, ckpt=make_ckpt("none")
):
    """One discriminator forward and backward on the packed [fake; real]
    batch (NHWC), the forward through ``ckpt`` (``ops/remat.py``). The
    gradients go to the parameters' ``.grad`` (set anew). -> (loss,
    real_scores, fake_scores), detached, scores NHWC in float32 (float64
    for a float64 discriminator)."""
    discriminator.zero_grad(set_to_none=True)
    packed = batch_pack([aug_fake, aug_real]).permute(0, 3, 1, 2)
    scores = ckpt(discriminator, packed)
    scores = scores.to(torch.promote_types(scores.dtype, torch.float32)).permute(0, 2, 3, 1)
    fake_scores, real_scores = batch_unpack(scores, 2)
    loss = lsgan_d_loss(real_scores, fake_scores)
    loss.backward()
    return loss.detach(), real_scores.detach(), fake_scores.detach()


def make_d_inputs(config: Config, models: Models, group=None):
    """-> ``d_inputs(state, d_shoeprints, d_shoemarks, draws)``: steps 1-3
    of the D phase, without gradient, at the ADA probability ``state.ada.p``
    -> (aug_fake, aug_real, buffer): the discriminator's augmented inputs
    (NHWC, in the activation dtype) and the replay buffer after the push
    (its images tensor is ``state.buffer``'s, updated in place)."""
    check_training_options(config)
    aug_options = {"antialias": config["tpu"]["ada_antialias"],
                   "supersample": config["tpu"]["ada_supersample"]}
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
        buffered, buffer = buffer_apply(state.buffer, fakes, draws.buffer, group)
        aug_fake = augment(buffered.to(aug_dtype), p, draws.aug_fake, **aug_options)
        aug_real = augment(d_shoemarks.to(device, aug_dtype), p, draws.aug_real, **aug_options)
        return aug_fake, aug_real, buffer

    return d_inputs


def r1_loss_and_grad(discriminator, aug_real: torch.Tensor, gamma: float) -> torch.Tensor:
    """``gamma / 2 * r1_penalty`` on the augmented reals (NHWC) in float32
    (float64 for a float64 discriminator: a reference): its gradients are
    added to the discriminator's ``.grad`` (the head's bias has none: D's
    gradient in its input does not depend on it); -> the term, detached."""
    acc = torch.promote_types(aug_real.dtype, torch.float32)
    reals = aug_real.to(acc).permute(0, 3, 1, 2).contiguous()
    params = list(discriminator.parameters())
    loss = (gamma / 2.0) * r1_penalty(discriminator, reals)
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    for p, g in zip(params, grads, strict=True):
        if g is not None:
            p.grad.add_(g)
    return loss.detach()


def refuse_int8(models: Models) -> None:
    """Raise for models built with ``int8_decode``: their decoder rounds its
    operands to int8 codes, so no gradient flows through it (the JAX
    package's ``make_train_step`` refuses them too)."""
    if models.int8_decode:
        msg = "int8_decode models cannot train; build Models(config) instead"
        raise ValueError(msg)


def make_d_phase(config: Config, models: Models, group=None):
    """-> ``d_phase(state, d_shoeprints, d_shoemarks, draws)``: one
    discriminator update on ``models.device``; ``state`` is updated in
    place and returned with the metrics ``disc_loss`` (with the R1 term on
    R1 steps), ``disc_real_acc``, ``disc_fake_acc`` and ``ada_p`` (the
    probability used). With ``group``: this rank's rows and the global
    draws of the phase (``shard_draws``' D part). Refuses int8 models."""
    refuse_int8(models)
    d_inputs = make_d_inputs(config, models, group)
    ckpt_d = make_ckpt(_remat_modes(config)[1])
    r1_gamma = config["tpu"]["r1_gamma"]
    r1_interval = config["tpu"]["r1_interval"]
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
        loss, real_scores, fake_scores = d_loss_and_grad(
            state.discriminator, aug_fake, aug_real, ckpt_d)
        if r1_gamma > 0 and state.step % r1_interval == 0:
            loss = loss + r1_loss_and_grad(state.discriminator, aug_real, r1_gamma)
        sign_real = discriminator_confidence(real_scores)
        sign_fake = -discriminator_confidence(fake_scores)
        if group is not None:
            loss, sign_real, sign_fake = group.reduce_gradients(
                [list(state.discriminator.parameters())], [loss, sign_real, sign_fake])
        state.opt_d.step()
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


def make_g_loss(config: Config, models: Models, group=None):
    """-> ``g_loss_and_grad(state, batches, draws, p_used, path_step)``:
    steps 1-5 of the G phase (with the path term when ``path_step``) ->
    its metrics; the gradients go to the generator's, mapping network's
    and extractor's ``.grad`` (set anew), and to nothing else. With
    ``tpu.g_loss_split`` the gradients are the sum of two sub-backwards
    (the main terms, then the path term on a fresh encode), equal to the
    joint backward's up to float reassociation. With ``group``: this rank's
    rows and draws, the KL term's moments global, the gradients and metrics
    this rank's (``make_g_phase`` reduces them)."""
    check_training_options(config)
    opt = config["optimisation"]
    scale = float(config["tpu"]["path_interval"])
    split = config["tpu"]["g_loss_split"]
    aug_options = {"antialias": config["tpu"]["ada_antialias"],
                   "supersample": config["tpu"]["ada_supersample"]}
    ckpt = make_ckpt(_remat_modes(config)[0])
    n_blocks = models.n_style_blocks
    device = models.device

    def encode(gen, prints, marks, draws):
        """-> (print latents, mark latents, KL) of the packed 2B encode."""
        latents = ckpt(gen.encode, batch_pack([prints, marks]))
        kl = kl_loss(latents, group)
        if draws.latent_noise is not None:
            latents = latents + draws.latent_noise.permute(0, 3, 1, 2)
        print_latent, mark_latent = batch_unpack(latents, 2)
        return print_latent, mark_latent, kl

    def main_terms(state, prints, marks, draws, p_used, print_latent, mark_latent, kl):
        """-> (kl + rec + idt + gan + style weighted, their metrics)."""
        gen, mapping, extractor = state.generator, state.mapping, state.extractor
        b = prints.shape[0]
        # styles are float32 (float64 in a float64 copy of the models)
        mark_w = ckpt(extractor, marks)
        w0 = torch.zeros((n_blocks, b, mark_w.shape[-1]), dtype=mark_w.dtype, device=device)
        w_t = mapping.style_vector(draws.style, n_blocks, mix_styles=True)
        out3 = ckpt(
            gen.decode,
            batch_pack([print_latent, mark_latent, print_latent]),
            batch_pack([w0, mark_w[None].expand(n_blocks, -1, -1), w_t], dim=1),
        )
        recon, idt, generated = batch_unpack(out3, 3)
        acc = torch.promote_types(out3.dtype, torch.float32)
        rec_loss = l1_loss(recon.to(acc), prints)
        idt_loss = l1_loss(idt.to(acc), marks)

        # GAN: the translations augmented at p_used, scored by the
        # discriminator as the D phase left it.
        aug = augment(generated.permute(0, 2, 3, 1), p_used, draws.aug, **aug_options)
        gan = lsgan_g_loss(ckpt(state.discriminator, aug.permute(0, 3, 1, 2)).to(acc))
        # Style cycle: the style extracted back from the translations.
        style = style_cycle_loss(w_t[-1], ckpt(extractor, generated))
        total = (
            gan
            + opt["identity_loss_lambda"] * idt_loss
            + opt["reconstruction_loss_lambda"] * rec_loss
            + opt["kl_loss_lambda"] * kl
            + opt["style_cycle_loss_lambda"] * style
        )
        return total, {
            "gan_loss": gan.detach(),
            "reconstruction_loss": rec_loss.detach(),
            "identity_loss": idt_loss.detach(),
            "kl_loss": kl.detach(),
            "style_loss": style.detach(),
        }

    def path_term(state, draws, print_latent):
        """The raw θ-path term: both finite-difference legs in one extract
        at 2B."""
        theta, h = draws.theta, draws.fin_diff_h
        w_path = state.mapping.style_vector(draws.path_style, n_blocks, mix_styles=True)
        w1 = apply_domain(w_path, torch.clamp(theta + h / 2.0, 0.0, 1.0))
        w2 = apply_domain(w_path, torch.clamp(theta - h / 2.0, 0.0, 1.0))
        feats = ckpt(
            state.generator.extract,
            batch_pack([print_latent, print_latent]), batch_pack([w1, w2], dim=1),
        )
        legs = [batch_unpack(f, 2) for f in feats]
        return path_loss([f1 for f1, _ in legs], [f2 for _, f2 in legs], h)

    def g_loss_and_grad(
        state: TrainState, batches: Batches, draws: GPhaseDraws, p_used: torch.Tensor,
        path_step: bool,
    ) -> dict[str, torch.Tensor]:
        gen, mapping, extractor = state.generator, state.mapping, state.extractor
        prints = _nchw(batches.g_shoeprints, device)
        marks = _nchw(batches.g_shoemarks, device)
        params = [p for m in (gen, mapping, extractor) for p in m.parameters()]
        with _frozen(state.discriminator):
            latents = encode(gen, prints, marks, draws)
            total, metrics = main_terms(state, prints, marks, draws, p_used, *latents)
            path = torch.zeros((), dtype=total.dtype, device=device)
            if split:
                grads = list(torch.autograd.grad(total, params))
                if path_step:
                    print_latent, _, _ = encode(gen, prints, marks, draws)
                    path = path_term(state, draws, print_latent)
                    weighted = opt["path_loss_lambda"] * path * scale
                    extra = torch.autograd.grad(weighted, params, allow_unused=True)
                    grads = [g if e is None else g + e
                             for g, e in zip(grads, extra, strict=True)]
                    total = total + weighted
            else:
                if path_step:
                    path = path_term(state, draws, latents[0])
                    total = total + opt["path_loss_lambda"] * path * scale
                grads = torch.autograd.grad(total, params)
        for p, g in zip(params, grads, strict=True):
            p.grad = g
        return {"total_gen_loss": total.detach(), **metrics, "path_loss": path.detach()}

    return g_loss_and_grad


@torch.no_grad()
def ema_update(ema: nn.Module, module: nn.Module, decay: float) -> None:
    """``e = e * decay + p * (1 - decay)`` over the parameters, in place:
    the JAX package's formula with its roundings (each product and the sum
    rounded to the parameters' float32), as three ``_foreach`` ops."""
    e = list(ema.parameters())
    torch._foreach_mul_(e, decay)
    torch._foreach_add_(e, torch._foreach_mul(list(module.parameters()), 1.0 - decay))


def make_g_phase(config: Config, models: Models, group=None):
    """-> ``g_phase(state, batches, draws, p_used)``: one update of the
    generator, mapping network and style extractor on ``models.device``;
    ``state`` is updated in place and returned with the metrics
    ``total_gen_loss``, ``gan_loss``, ``reconstruction_loss``,
    ``identity_loss``, ``kl_loss``, ``style_loss`` and ``path_loss`` (the
    raw path term on path steps, 0 on the others). With ``group``, the
    gradients and the metrics (but ``kl_loss``, global already) are
    averaged over the ranks before the Adams. Refuses int8 models."""
    refuse_int8(models)
    g_loss_and_grad = make_g_loss(config, models, group)
    interval = config["tpu"]["path_interval"]
    decay = config["tpu"]["ema_decay"]

    def g_phase(
        state: TrainState, batches: Batches, draws: GPhaseDraws, p_used: torch.Tensor
    ) -> tuple[TrainState, dict[str, torch.Tensor]]:
        metrics = g_loss_and_grad(state, batches, draws, p_used, state.step % interval == 0)
        if group is not None:
            names = [k for k in metrics if k != "kl_loss"]
            means = group.reduce_gradients(
                [list(m.parameters()) for m in (state.generator, state.mapping, state.extractor)],
                [metrics[k] for k in names])
            metrics = {**metrics, **dict(zip(names, means, strict=True))}
        for opt in (state.opt_g, state.opt_m, state.opt_s):
            opt.step()
        if state.ema_generator is not None:
            ema_update(state.ema_generator, state.generator, decay)
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


def _shard_style(rngs: StyleRngs, group) -> StyleRngs:
    return rngs._replace(z1=group.shard(rngs.z1), z2=group.shard(rngs.z2))


def _shard_augment(draws: AugmentDraws, group) -> AugmentDraws:
    return AugmentDraws(GeometricDraws(*map(group.shard, draws.geom)),
                        ColorDraws(*map(group.shard, draws.color)))


def shard_draws(draws: StepDraws, group) -> StepDraws:
    """This rank's rows of a fused step's global draws: every per-image
    draw sliced (the latent noise by its packed 2B rows), the style
    draws' mixing flag and crossover and the replay buffer's draws kept
    global (every rank runs the buffer over the global batch)."""
    d, g = draws.d, draws.g
    noise = None if g.latent_noise is None else group.shard(g.latent_noise)
    return StepDraws(
        d=DPhaseDraws(style=_shard_style(d.style, group), buffer=d.buffer,
                      aug_fake=_shard_augment(d.aug_fake, group),
                      aug_real=_shard_augment(d.aug_real, group)),
        g=GPhaseDraws(theta=group.shard(g.theta), fin_diff_h=group.shard(g.fin_diff_h),
                      latent_noise=noise, style=_shard_style(g.style, group),
                      aug=_shard_augment(g.aug, group),
                      path_style=_shard_style(g.path_style, group)),
    )


def make_train_step(config: Config, models: Models, group=None):
    """-> ``train_step(state, batches, draws) -> (state, metrics)``: the D
    phase, then the G phase at the ADA probability entering the step; the
    metrics of both phases. With ``group`` (``parallel.DataParallel``),
    ``batches`` are this rank's rows of the global batch and ``draws``
    the global step's (``draw_step`` at the config's batch size, the same
    on every rank); the metrics are the global step's. Refuses int8 models
    (through its phases)."""
    d_phase = make_d_phase(config, models, group)
    g_phase = make_g_phase(config, models, group)

    def train_step(
        state: TrainState, batches: Batches, draws: StepDraws
    ) -> tuple[TrainState, dict[str, torch.Tensor]]:
        if group is not None:
            draws = shard_draws(draws, group)
        p_used = state.ada.p
        state, d_metrics = d_phase(state, batches.d_shoeprints, batches.d_shoemarks, draws.d)
        state, g_metrics = g_phase(state, batches, draws.g, p_used)
        return state, {**d_metrics, **g_metrics}

    return train_step
