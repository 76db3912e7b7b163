"""``train_mfu``'s count: the reference's model FLOPs of a trained image
at the cell's configuration, pinned, and its parts."""

from __future__ import annotations

import copy

import pytest

from benchmark import harness, train_formulas

CONFIG = harness.cell("otm_prod512.train_dp4")["config_file"]["config"]


def test_flops_per_image_is_pinned():
    # one period: step 0 (R1 and path), step 8 (path), 14 plain steps
    steps = {k: train_formulas.step_flops(CONFIG, k) for k in (0, 8, 1)}
    assert steps[0] > steps[8] > steps[1] > 0
    period = steps[0] + steps[8] + 14 * steps[1]
    assert train_formulas.flops_per_image(CONFIG) == pytest.approx(period / 512)
    assert train_formulas.flops_per_image(CONFIG) == pytest.approx(5277.749273178e9, rel=1e-9)


def test_flops_scale_with_the_batch():
    half = copy.deepcopy(CONFIG)
    half["training"]["batch_size"] = 16
    assert train_formulas.step_flops(half, 1) == pytest.approx(
        train_formulas.step_flops(CONFIG, 1) / 2, rel=1e-9)
