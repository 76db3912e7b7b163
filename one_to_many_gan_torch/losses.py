"""The losses of both phases of training (the JAX package's ``losses``)."""

from __future__ import annotations

import torch

from one_to_many_gan_torch.ops import l2_normalize


def lsgan_d_loss(real_scores: torch.Tensor, fake_scores: torch.Tensor) -> torch.Tensor:
    """LSGAN discriminator loss: (MSE(real, 1) + MSE(fake, 0)) / 2."""
    real_loss = (real_scores - 1.0).square().mean()
    fake_loss = fake_scores.square().mean()
    return (real_loss + fake_loss) / 2.0


def lsgan_g_loss(fake_scores: torch.Tensor) -> torch.Tensor:
    """LSGAN generator loss: MSE(fake, 1)."""
    return (fake_scores - 1.0).square().mean()


def discriminator_confidence(scores: torch.Tensor) -> torch.Tensor:
    """Mean sign of scores rescaled from [0,1]-target space to [-1,1]:
    sign(2*score - 1).mean()."""
    return torch.sign(scores * 2.0 - 1.0).mean()


def l1_loss(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a - b).abs().mean()


def style_cycle_loss(original_w: torch.Tensor, reconstructed_w: torch.Tensor) -> torch.Tensor:
    """1 - cos_sim + 0.2 * MSE between the L2-normalised styles [B, w_dim],
    in float32 (float64 for float64 input)."""
    acc = torch.promote_types(
        torch.promote_types(original_w.dtype, reconstructed_w.dtype), torch.float32
    )
    a = l2_normalize(original_w.to(acc), dim=-1)
    b = l2_normalize(reconstructed_w.to(acc), dim=-1)
    # cosine similarity with the norm product clamped at 1e-8
    denom = (torch.linalg.vector_norm(a, dim=-1) * torch.linalg.vector_norm(b, dim=-1)).clamp_min(
        1e-8
    )
    cos = (a * b).sum(dim=-1) / denom
    return (1.0 - cos.mean()) + 0.2 * (a - b).square().mean()


def kl_loss(combined_latents: torch.Tensor) -> torch.Tensor:
    """Pushes the latents toward N(0, 1): mean^2 + (var - 1)^2 over the
    WHOLE packed tensor, with the biased variance."""
    x = combined_latents.to(torch.promote_types(combined_latents.dtype, torch.float32))
    mean = x.mean()
    var = (x - mean).square().mean()
    return mean.square() + (var - 1.0).square()


def path_loss(
    features1: list[torch.Tensor],
    features2: list[torch.Tensor],
    cent_fin_diff_h: torch.Tensor,
) -> torch.Tensor:
    """Finite-difference Jacobian energy over θ, averaged across the
    generator's style-block feature taps: mean over taps of
    mean(((f1 - f2) / h)^2), with per-sample steps ``h`` [B].

    It divides by ``h``, the drawn step, even where clipping θ ± h/2 to
    [0, 1] made the two legs' domains differ by less: the JAX package's
    quirk, kept so that both compute the same loss."""
    h = cent_fin_diff_h.to(torch.promote_types(cent_fin_diff_h.dtype, torch.float32))
    h = h[:, None, None, None]
    total = torch.zeros((), dtype=h.dtype, device=h.device)
    for f1, f2 in zip(features1, features2, strict=True):
        jac = (f1.to(h.dtype) - f2.to(h.dtype)) / h
        total = total + jac.square().mean()
    return total / len(features1)
