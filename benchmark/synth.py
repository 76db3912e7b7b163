"""Inputs made from the run's seed: weights and synthetic shoeprints.

Both sides of a comparison get the same tensors from here: the program
loads the weights into its modules and serves the prints, and the
reference takes the same weights and the same uint8 pixels.
"""

from __future__ import annotations

import numpy as np
import torch

SEED_MASK = 2**63 - 1


def normals(shapes: dict[str, torch.Size], seed: int, device) -> dict[str, torch.Tensor]:
    """float32 N(0, 1) tensors of ``shapes``, drawn on ``device`` in one
    call of one ``torch.Generator`` seeded with ``seed``."""
    gen = torch.Generator(device).manual_seed(int(seed) & SEED_MASK)
    flat = torch.randn(sum(s.numel() for s in shapes.values()), generator=gen, device=device)
    out, at = {}, 0
    for name, shape in shapes.items():
        out[name] = flat[at : at + shape.numel()].view(shape)
        at += shape.numel()
    return out


def prints(seed: int, count: int, height: int, width: int, channels: int) -> list[np.ndarray]:
    """``count`` synthetic shoeprints, ``[H, W, C]`` uint8: a dark sole
    outline (an ellipse) filled with tread from three random gratings,
    on white, with sensor noise."""
    rng = np.random.default_rng(int(seed) & SEED_MASK)
    yy, xx = np.mgrid[0:height, 0:width].astype(np.float32)
    out = []
    for _ in range(count):
        cy, cx = height * rng.uniform(0.45, 0.55), width * rng.uniform(0.45, 0.55)
        ay, ax = height * rng.uniform(0.38, 0.46), width * rng.uniform(0.32, 0.44)
        sole = ((yy - cy) / ay) ** 2 + ((xx - cx) / ax) ** 2 < 1.0
        wave = np.zeros((height, width), np.float32)
        for _ in range(3):
            fy, fx = rng.uniform(-0.15, 0.15, size=2)
            wave += np.sin(2 * np.pi * (fy * yy + fx * xx) + rng.uniform(0, 2 * np.pi))
        tread = sole & (wave > rng.uniform(-0.5, 0.5))
        img = np.where(tread, 40.0, 245.0) + rng.normal(0.0, 12.0, (height, width))
        img = np.clip(img, 0, 255).astype(np.uint8)
        out.append(np.repeat(img[:, :, None], channels, axis=2))
    return out
