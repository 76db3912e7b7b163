"""Replication and reflection padding (NCHW) with a deterministic backward.

PyTorch's CUDA backward of ``F.pad(mode="replicate")`` and
``F.pad(mode="reflect")`` adds the padded gradient into the input's with
atomics, in an order that varies from run to run, and raises under
``torch.use_deterministic_algorithms(True)``. ``pad`` runs the same
``F.pad`` forward; its backward folds the padded gradient back with
slices and sums in a fixed order: the interior, plus each edge strip
summed into the border row or column it copies (replicate) or flipped
onto the rows or columns it mirrors (reflect). It reads the padded
gradient once and writes the input gradient once. The JAX package pads
with ``jnp.pad`` outside any kernel, so these are plain torch ops, on
every device and in every mode.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

_MODES = ("replicate", "reflect")


def _segments(n: int, lo: int, hi: int, mode: str) -> list[tuple[slice, slice, str]]:
    """(source in the padded axis, destination in the input axis, how) for
    one axis of input length ``n`` padded by ``lo`` and ``hi``: the
    interior first, then the edge strips. ``how``: ``copy``, ``sum`` (the
    strip into one border index) or ``flip`` (the strip onto the indices
    it mirrors)."""
    segs = [(slice(lo, lo + n), slice(0, n), "copy")]
    if lo:
        dst = slice(0, 1) if mode == "replicate" else slice(1, lo + 1)
        segs.append((slice(0, lo), dst, "sum" if mode == "replicate" else "flip"))
    if hi:
        dst = slice(n - 1, n) if mode == "replicate" else slice(n - 1 - hi, n - 1)
        segs.append((slice(lo + n, lo + n + hi), dst, "sum" if mode == "replicate" else "flip"))
    return segs


def _apply(t: torch.Tensor, how: str, dim: int) -> torch.Tensor:
    if how == "sum":
        return t.sum(dim=dim, keepdim=True)
    if how == "flip":
        return t.flip(dim)
    return t


def _fold(g: torch.Tensor, pad: tuple[int, int, int, int], mode: str) -> torch.Tensor:
    """The input gradient of ``F.pad(x, pad, mode)`` for the padded
    gradient ``g``."""
    left, right, top, bottom = pad
    h = g.shape[-2] - top - bottom
    w = g.shape[-1] - left - right
    rows, cols = _segments(h, top, bottom, mode), _segments(w, left, right, mode)
    (src_h, _, _), (src_w, _, _) = rows[0], cols[0]
    gi = g[..., src_h, src_w].clone(memory_format=torch.contiguous_format)
    for i, (sh, dh, how_h) in enumerate(rows):
        for j, (sw, dw, how_w) in enumerate(cols):
            if i == 0 and j == 0:
                continue
            gi[..., dh, dw] += _apply(_apply(g[..., sh, sw], how_h, -2), how_w, -1)
    return gi


class _Pad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, pad: tuple[int, int, int, int], mode: str):
        ctx.pad, ctx.mode = pad, mode
        return F.pad(x, pad, mode=mode)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return _fold(g, ctx.pad, ctx.mode), None, None


def pad(x: torch.Tensor, pad: tuple[int, int, int, int], mode: str) -> torch.Tensor:
    """``F.pad(x, pad, mode)`` of an NCHW tensor, ``pad`` = (left, right,
    top, bottom) and ``mode`` ``replicate`` or ``reflect``, whose backward
    is deterministic (the module docstring)."""
    if mode not in _MODES:
        msg = f"pad mode {mode!r}: replicate or reflect"
        raise ValueError(msg)
    return _Pad.apply(x, tuple(pad), mode)
