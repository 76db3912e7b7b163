"""The models' ReLU and LeakyReLU, whose kink pattern a caller can record
and pin.

``leaky_relu`` is ``where(x >= 0, x, slope x)``, as JAX's: its derivative
at exactly 0 is 1. Both activations are piecewise linear, so their
derivative jumps at 0. Two passes of one step in different precisions
(float32 against float64, or float32 on two devices) round each input
differently, and an input that lies within that rounding of 0 can land on
the other side in one of them, where the derivative is 0 or ``slope``
instead of 1. One such flip among the ~1e7 inputs of a G phase moves every
gradient upstream of it by up to ~1e-3 of its largest entry.

To tell such flips from an error, a caller records which side each input
took in one pass (``record``) and pins that pattern in another (``pin``):
every activation then takes the recorded side, its values stay its own,
and the pin counts the inputs whose own side differed. Outside those
blocks the activations are plain torch ops. ``fused_instance_norm(x,
relu=True)`` routes its ReLU through here while a block is open.
"""

from __future__ import annotations

import contextlib
from collections.abc import Iterator, Sequence

import torch


class KinkPattern:
    """The sides one pass took: ``masks`` holds one bool tensor per
    activation call, in call order, on the CPU (True: the identity side).
    A pinned pattern also counts, per call, the inputs whose own side
    differed from the mask (``flips``)."""

    def __init__(self, masks: Sequence[torch.Tensor] | None = None):
        self.pinned = masks is not None
        self.masks = list(masks or ())
        self.flips: list[torch.Tensor] = []

    def n_flips(self) -> int:
        return int(sum(f.item() for f in self.flips))


_open: KinkPattern | None = None


@contextlib.contextmanager
def _opened(pattern: KinkPattern) -> Iterator[KinkPattern]:
    global _open
    if _open is not None:
        raise RuntimeError("a kink pattern is already being recorded or pinned")
    _open = pattern
    try:
        yield pattern
    finally:
        _open = None


def record() -> contextlib.AbstractContextManager[KinkPattern]:
    """Record the side of every activation input inside the block."""
    return _opened(KinkPattern())


def pin(masks: Sequence[torch.Tensor]) -> contextlib.AbstractContextManager[KinkPattern]:
    """Make the activations inside the block take the sides in ``masks``
    (a recorded pattern's), in call order."""
    return _opened(KinkPattern(masks))


def kinks_open() -> bool:
    return _open is not None


def _kinked(x: torch.Tensor, own: torch.Tensor, slope: float) -> torch.Tensor:
    pattern = _open
    if pattern.pinned:
        mask = pattern.masks[len(pattern.flips)]
        if mask.shape != x.shape:
            raise RuntimeError(f"pinned kink pattern: call {len(pattern.flips)} has shape "
                               f"{tuple(mask.shape)}, the activation {tuple(x.shape)}")
        mask = mask.to(x.device)
        pattern.flips.append((mask != own).sum())
    else:
        mask = own
        pattern.masks.append(own.cpu())
    return torch.where(mask, x, x * slope)


def relu(x: torch.Tensor) -> torch.Tensor:
    if _open is None:
        return torch.relu(x)
    return _kinked(x, x > 0, 0.0)


def leaky_relu(x: torch.Tensor, slope: float = 0.2) -> torch.Tensor:
    """LeakyReLU with JAX's derivative at 0 (1, the identity branch)."""
    own = x >= 0
    if _open is None:
        return torch.where(own, x, x * slope)
    return _kinked(x, own, slope)
