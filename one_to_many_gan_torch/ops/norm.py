"""Normalization ops (NCHW), the plain PyTorch versions.

``instance_norm`` is the oracle of the CUDA kernel in
``ops/cuda/instance_norm.py`` and its path on CPU tensors.
"""

from __future__ import annotations

import torch


def instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Per-sample, per-channel spatial normalization, no affine params.

    torch ``nn.InstanceNorm2d`` defaults (affine=False, eps=1e-5, biased
    variance). Statistics are accumulated in float32.

    float32: centered two-pass variance. bfloat16: the JAX package's
    moment path, E[x^2]-E[x]^2 in float32 clamped at 0, then the
    normalization arithmetic in bf16.
    """
    if x.dtype == torch.bfloat16:
        xf = x.float()
        mean = xf.mean(dim=(2, 3), keepdim=True)
        sq = xf.square().mean(dim=(2, 3), keepdim=True)
        var = (sq - mean.square()).clamp_min(0.0)
        scale = torch.rsqrt(var + eps).to(torch.bfloat16)
        return (x - mean.to(torch.bfloat16)) * scale
    mean = x.mean(dim=(2, 3), keepdim=True)
    var = (x - mean).square().mean(dim=(2, 3), keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps)


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """L2 normalization matching ``F.normalize`` (clamped norm)."""
    norm = torch.linalg.vector_norm(x, dim=dim, keepdim=True)
    return x / norm.clamp_min(eps)
