"""Synthetic training data made from the run's seed, on the device.

Every rank of a training cell and the reference make the same images
from the same seed: prints (domain 0) and marks (domain 1), each a dark
sole outline (an ellipse) filled with tread from three random gratings,
on white, with sensor noise; a mark is fainter, noisier and cut off by
a random straight edge, as a partial impression. Made in blocks of
images by one ``torch.Generator`` on ``device``, in uint8 [N, H, W, C].
"""

from __future__ import annotations

import math

import torch

from benchmark.synth import SEED_MASK

BLOCK = 32


def images(seed: int, domain: int, count: int, height: int, width: int, channels: int,
           device) -> torch.Tensor:
    """``count`` synthetic prints (``domain`` 0) or marks (1)."""
    gen = torch.Generator(device).manual_seed((int(seed) * 2 + domain) & SEED_MASK)
    yy = torch.arange(height, dtype=torch.float32, device=device)[None, :, None]
    xx = torch.arange(width, dtype=torch.float32, device=device)[None, None, :]
    out = []
    for start in range(0, count, BLOCK):
        n = min(BLOCK, count - start)

        def u(lo, hi, *shape, n=n):
            return torch.rand((n, *shape), generator=gen, device=device) * (hi - lo) + lo

        cy, cx = (height * u(0.45, 0.55))[:, None, None], (width * u(0.45, 0.55))[:, None, None]
        ay, ax = (height * u(0.38, 0.46))[:, None, None], (width * u(0.32, 0.44))[:, None, None]
        sole = ((yy - cy) / ay) ** 2 + ((xx - cx) / ax) ** 2 < 1.0
        f = u(-0.15, 0.15, 3, 2)
        phase = u(0.0, 2 * math.pi, 3)
        wave = sum(torch.sin(2 * math.pi * (f[:, k, 0, None, None] * yy
                                            + f[:, k, 1, None, None] * xx)
                             + phase[:, k, None, None]) for k in range(3))
        tread = sole & (wave > u(-0.5, 0.5)[:, None, None])
        ink, paper, noise = (40.0, 245.0, 12.0) if domain == 0 else (110.0, 235.0, 24.0)
        img = torch.where(tread, ink, paper)
        if domain == 1:
            angle = u(0.0, 2 * math.pi)[:, None, None]
            cut = (torch.cos(angle) * (xx - cx) + torch.sin(angle) * (yy - cy)
                   > u(-0.1, 0.4)[:, None, None] * min(height, width))
            img = torch.where(cut, paper, img)
        img = img + noise * torch.randn((n, height, width), generator=gen, device=device)
        out.append(img.clamp(0, 255).to(torch.uint8)[..., None].expand(-1, -1, -1, channels))
    return torch.cat(out).contiguous()
