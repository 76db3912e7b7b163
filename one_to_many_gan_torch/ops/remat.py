"""Rematerialisation of the training step's model passes (``tpu.remat``).

The JAX package wraps each model pass of its losses in ``jax.checkpoint``
(``core/train_step.py``, ``_make_ckpt``): "full" keeps each pass's inputs
only and recomputes its whole forward in the backward; "conv" saves the
outputs it names ``conv_out`` (those of every ``EqualizedConv`` and
``ModulatedConv``) and recomputes what lies between them: instance norms,
activations, pads and the FIR resamples. ``make_ckpt`` does the same with
``torch.utils.checkpoint.checkpoint(use_reentrant=False)``; "conv" under a
selective policy that saves the convolutions run inside a ``conv_out()``
block and nothing else. ``ops/equalized.py`` and ``ops/modulated.py``
open one around their ``F.conv2d`` alone, so the depthwise FIR
convolutions of ``ops/resample.py`` are recomputed, as in JAX.

A recompute repeats the forward's ops on the same values, so losses and
gradients are bitwise those without rematerialisation. Two things repeat
with it: kernel launches (a recomputed instance norm launches again, and
counts), and the activations' kink pattern (``ops/activations.py``), which
the recompute replays instead of recording or pinning it again.

``saves`` counts, per operator, the outputs the "conv" policy saved in
forwards (recomputes excluded).
"""

from __future__ import annotations

import collections
import contextlib
from collections.abc import Callable, Iterator

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from one_to_many_gan_torch.ops import activations

MODES = ("none", "conv", "full")

_tagged = False
saves: collections.Counter = collections.Counter()


@contextlib.contextmanager
def conv_out() -> Iterator[None]:
    """The convolution run inside the block is a save point of "conv"."""
    global _tagged
    outer, _tagged = _tagged, True
    try:
        yield
    finally:
        _tagged = outer


def _conv_policy(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    if _tagged and op is torch.ops.aten.convolution.default:
        if not ctx.is_recompute:
            saves[str(op)] += 1
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


@contextlib.contextmanager
def _entered(*contexts) -> Iterator[None]:
    with contextlib.ExitStack() as stack:
        for c in contexts:
            stack.enter_context(c)
        yield


def _contexts(mode: str):
    kink_fwd, kink_recompute = activations.checkpoint_contexts()
    if mode == "full":
        return kink_fwd, kink_recompute
    sac_fwd, sac_recompute = create_selective_checkpoint_contexts(_conv_policy)
    return _entered(sac_fwd, kink_fwd), _entered(sac_recompute, kink_recompute)


def _plain(fn: Callable, *args):
    return fn(*args)


def make_ckpt(mode: str) -> Callable:
    """-> ``ckpt(fn, *args)``, which returns ``fn(*args)`` and, under
    "conv" or "full", recomputes it in the backward (module docstring)."""
    if mode not in MODES:
        msg = f"remat mode must be one of {MODES}, got {mode!r}"
        raise ValueError(msg)
    if mode == "none":
        return _plain

    def ckpt(fn: Callable, *args):
        return checkpoint(fn, *args, use_reentrant=False, context_fn=lambda: _contexts(mode))

    return ckpt
