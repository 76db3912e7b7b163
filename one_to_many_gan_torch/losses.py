"""The losses of both phases of training (the JAX package's ``losses``).

Under a spatial group (``parallel/halo.py``) the maps they read are
bands of rows, and every mean or sum over a whole image is the bands'
sum over the group (``halo.mean``, ``halo.all_reduce``), differentiable
where the step differentiates it; the value is the whole image's on
every rank.
"""

from __future__ import annotations

import torch

from one_to_many_gan_torch.ops import l2_normalize
from one_to_many_gan_torch.parallel import halo


def lsgan_d_loss(real_scores: torch.Tensor, fake_scores: torch.Tensor) -> torch.Tensor:
    """LSGAN discriminator loss: (MSE(real, 1) + MSE(fake, 0)) / 2."""
    real_loss = halo.mean((real_scores - 1.0).square())
    fake_loss = halo.mean(fake_scores.square())
    return (real_loss + fake_loss) / 2.0


def lsgan_g_loss(fake_scores: torch.Tensor) -> torch.Tensor:
    """LSGAN generator loss: MSE(fake, 1)."""
    return halo.mean((fake_scores - 1.0).square())


def discriminator_confidence(scores: torch.Tensor) -> torch.Tensor:
    """Mean sign of scores rescaled from [0,1]-target space to [-1,1]:
    sign(2*score - 1).mean()."""
    return halo.mean(torch.sign(scores * 2.0 - 1.0))


def l1_loss(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return halo.mean((a - b).abs())


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


def kl_loss(combined_latents: torch.Tensor, group=None) -> torch.Tensor:
    """Pushes the latents toward N(0, 1): mean^2 + (var - 1)^2 over the
    WHOLE packed tensor, with the biased variance.

    With a data-parallel ``group`` (``parallel.DataParallel``) the tensor
    is this rank's rows, and the mean and variance are the global batch's
    (the JAX package computes them on the global array): the local sums
    are all-reduced. The value is the global term on every rank. Its
    gradient is this rank's rows' share of the global term's, times the
    world size, so that the mean over ranks that ``reduce_gradients``
    takes gives the global gradient: the one term whose gradient is not a
    mean of per-rank gradients. The variance sums ``(x - mean)^2`` with the
    mean held constant, whose gradient is exactly the global variance's
    (that of the mean through it is ``-2 sum(x - mean) / N^2 = 0``)."""
    x = combined_latents.to(torch.promote_types(combined_latents.dtype, torch.float32))
    if group is None:
        mean = x.mean()
        var = (x - mean).square().mean()
        return mean.square() + (var - 1.0).square()
    s1 = x.sum()
    if group.spatial is None:
        n = x.numel() * group.world
    else:
        n = group.all_reduce_sum(torch.tensor(float(x.numel()), dtype=x.dtype,
                                              device=x.device))
    mean = group.all_reduce_sum(s1) / n + (s1 - s1.detach()) / n
    s2 = (x - mean.detach()).square().sum()
    var = group.all_reduce_sum(s2) / n + (s2 - s2.detach()) / n
    return halo.scale_grad(mean.square() + (var - 1.0).square(), float(group.world))


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
        total = total + halo.mean(jac.square())
    return total / len(features1)


def r1_penalty(discriminator, real_images: torch.Tensor, h: int | None = None) -> torch.Tensor:
    """R1 gradient penalty E[|grad_x D(x)|^2] on real images [B,C,H,W]
    (the JAX package's ``losses.r1_penalty``): the sum over the batch of
    D's per-sample mean patch logit, differentiated with respect to the
    images with ``create_graph=True`` (so the penalty is differentiable in
    D's parameters: a double backward through D), squared and summed per
    sample in float32 (float64 for float64 images), averaged over the
    batch. Under a spatial group the images are bands of ``h`` rows; the
    scalar, the same on every rank, is differentiated at ``1 / S``
    (``halo.share``) so that its band gradients are the image's."""
    x = real_images.detach().requires_grad_(True)
    scalar = halo.mean(discriminator(x, h), (1, 2, 3)).sum()
    (grad,) = torch.autograd.grad(halo.share(scalar), x, create_graph=True)
    acc = torch.promote_types(grad.dtype, torch.float32)
    return halo.all_reduce(grad.to(acc).square().sum(dim=(1, 2, 3))).mean()
