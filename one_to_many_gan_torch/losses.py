"""The discriminator's losses (the generator's come with its phase)."""

from __future__ import annotations

import torch


def lsgan_d_loss(real_scores: torch.Tensor, fake_scores: torch.Tensor) -> torch.Tensor:
    """LSGAN discriminator loss: (MSE(real, 1) + MSE(fake, 0)) / 2."""
    real_loss = (real_scores - 1.0).square().mean()
    fake_loss = fake_scores.square().mean()
    return (real_loss + fake_loss) / 2.0


def discriminator_confidence(scores: torch.Tensor) -> torch.Tensor:
    """Mean sign of scores rescaled from [0,1]-target space to [-1,1]:
    sign(2*score - 1).mean()."""
    return torch.sign(scores * 2.0 - 1.0).mean()
