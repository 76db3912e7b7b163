"""ADA probability controller: integral control on the discriminator's
sign statistics.

Every D step feeds the mean sign of the discriminator's real scores.
Once ``n_batches = ada_e // batch_size`` scores have accumulated, the
NEXT score closes the window: the window mean is taken over
``n_batches + 1`` scores including that boundary score, which also opens
the new window (the reference's append-before-and-after-reset flow, kept
as the JAX package keeps it). Above the target the probability rises by
``ada_adjustment_size * ada_e``, below it falls; it is clamped at 0.

The state is three 0-d tensors on the device, updated with
``torch.where``: no host round trip.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class AdaState(NamedTuple):
    p: torch.Tensor  # float32: current augmentation probability
    count: torch.Tensor  # int32: scores in the open window
    accum: torch.Tensor  # float32: sum of the scores in the open window


def init_ada_state(device: str | torch.device = "cpu", p: float = 0.0) -> AdaState:
    return AdaState(
        p=torch.tensor(p, dtype=torch.float32, device=device),
        count=torch.zeros((), dtype=torch.int32, device=device),
        accum=torch.zeros((), dtype=torch.float32, device=device),
    )


def make_ada_update(ada_e: int, ada_adjustment_size: float, batch_size: int, target: float):
    """-> ``update(state, mean_real_sign) -> AdaState`` for these
    hyperparameters."""
    n_batches = ada_e // batch_size
    adjustment = ada_adjustment_size * ada_e

    def update(state: AdaState, mean_real_sign: torch.Tensor) -> AdaState:
        score = mean_real_sign.float()
        closes = state.count == n_batches
        window_mean = (state.accum + score) / (state.count.float() + 1.0)
        zero = torch.zeros_like(score)
        delta = torch.where(
            window_mean > target,
            zero + adjustment,
            torch.where(window_mean < target, zero - adjustment, zero),
        )
        return AdaState(
            p=torch.where(closes, torch.relu(state.p + delta), state.p),
            count=torch.where(closes, torch.ones_like(state.count), state.count + 1),
            accum=torch.where(closes, score, state.accum + score),
        )

    return update
