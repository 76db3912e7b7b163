"""Inference entry points: translation and the 1->N sweep.

The functions take and return NHWC images ``[..., H, W, C]`` as the JAX
package's do, and take their style draws as tensors: ``z`` of
``[n, w_dim]`` or ``[B, n, w_dim]`` standard normals. Tests hand them the
JAX draws; serving draws them from a ``torch.Generator`` per request
(``serve.py``). The same seed therefore gives *different* shoemarks than
the JAX server, whose draws come from ``jax.random``: the two RNGs
differ, while the function from (image, z, θ) to shoemarks is the same.
"""

from __future__ import annotations

import math

import torch

from one_to_many_gan_torch.core.state import Models
from one_to_many_gan_torch.models import StyleRngs, apply_domain


def _nchw(images: torch.Tensor) -> torch.Tensor:
    return images.permute(0, 3, 1, 2).contiguous()


def _nhwc(images: torch.Tensor) -> torch.Tensor:
    return images.permute(0, 2, 3, 1)


def decode_batch_limit(models: Models) -> int:
    """The most images one ``Generator.decode`` call may take.

    Some of PyTorch's CUDA kernels (the replication pad among them) index
    with 32 bits and refuse a tensor of 2**31 values or more. The
    decoder's largest tensors are at full resolution: the last upsample's
    output (the input of the last up conv, or the latent when there is no
    resampling) and the output conv's reflect-padded input, at most
    ``c * (H + 6) * (W + 6)`` values per image with ``c`` the larger of
    their channel counts.
    """
    gen = models.generator
    h, w = models.image_size
    c_full = gen.dec_up[-1].weight.shape[1] if len(gen.dec_up) else gen.latent_features
    c = max(gen.out_conv.weight.shape[1], c_full)
    return max(1, (2**31 - 1) // (c * (h + 6) * (w + 6)))


def decode_in_chunks(gen, latent: torch.Tensor, w: torch.Tensor, limit: int) -> torch.Tensor:
    """``gen.decode(latent, w)`` in as few equal chunks of at most ``limit``
    images as cover the batch. Each image's decode depends only on its own
    latent and styles, so the result is the same function."""
    n = latent.shape[0]
    if n <= limit:
        return gen.decode(latent, w)
    step = math.ceil(n / math.ceil(n / limit))
    return torch.cat(
        [gen.decode(latent[i : i + step], w[:, i : i + step]) for i in range(0, n, step)]
    )


def make_inference_fns(models: Models):
    """-> (translate, one_to_many, many_to_many), running on ``models.device``
    under ``torch.inference_mode``."""
    gen, mapping = models.generator, models.mapping
    n_blocks = models.n_style_blocks
    device = models.device
    limit = decode_batch_limit(models)

    def _styles(z_flat: torch.Tensor, theta_flat) -> torch.Tensor:
        z = z_flat.to(device, torch.float32)
        rngs = StyleRngs(z1=z, z2=z, mix=torch.tensor(False), crossover=torch.tensor(0))
        s = mapping.style_vector(rngs, n_blocks, mix_styles=False)
        return apply_domain(s, theta_flat)

    @torch.inference_mode()
    def translate(images: torch.Tensor, rngs: StyleRngs, *, domain=1.0, mix=False):
        """[B,H,W,C] sources + one style draw per source -> [B,H,W,C]."""
        rngs = StyleRngs(*(t.to(device) for t in rngs))
        s = mapping.style_vector(rngs, n_blocks, mix_styles=mix)
        w = apply_domain(s, domain)
        return _nhwc(gen(_nchw(images.to(device)), w))

    @torch.inference_mode()
    def one_to_many(image: torch.Tensor, z: torch.Tensor, theta=1.0):
        """One source image [H,W,C] + draws z [n, w_dim] -> [n, H, W, C].

        ``theta`` is the continuous domain coordinate: 0 reproduces the
        source domain (zero style), 1 is the full shoemark domain.
        """
        latent = gen.encode(_nchw(image.to(device)[None]))
        n = z.shape[0]
        latent_n = latent.expand(n, *latent.shape[1:])
        return _nhwc(decode_in_chunks(gen, latent_n, _styles(z, theta), limit))

    @torch.inference_mode()
    def many_to_many(images: torch.Tensor, z: torch.Tensor, thetas: torch.Tensor,
                     rows: slice = slice(None)):
        """The cross-request serving batch: [B,H,W,C] sources, draws
        z [B, n, w_dim] and [B] thetas -> [B*n, H, W, C], request ``i``'s
        n images at rows ``i*n`` .. ``(i+1)*n - 1``; ``rows`` (a slice of
        that flattened style batch) decodes only those rows, one
        data-parallel replica's part.

        One encode at B and one decode at B*n (in chunks where B*n exceeds
        ``decode_batch_limit``). Request ``i``'s output depends only on
        (images[i], z[i], thetas[i]).
        """
        b, n = z.shape[0], z.shape[1]
        latents = gen.encode(_nchw(images.to(device)))
        latent_bn = latents.repeat_interleave(n, dim=0)[rows]
        thetas = torch.as_tensor(thetas, dtype=torch.float32, device=device)
        w = _styles(z.reshape(b * n, -1)[rows], thetas.repeat_interleave(n)[rows])
        return _nhwc(decode_in_chunks(gen, latent_bn, w, limit))

    return translate, one_to_many, many_to_many
