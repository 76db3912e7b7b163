"""On the card, at the cell's own size and load: the program as run is
correct and its control (the int8 decode) is not, on three seeds each.

    python -m pytest --noconftest -p no:cacheprovider benchmark/tests/test_benchmark_card.py -m cuda
"""

from __future__ import annotations

import time

import pytest
import torch

from benchmark import harness
from benchmark.run import run_cell
from benchmark.tools.readings import MODES

SEEDS = (2**31 + 1201, 2**31 + 1202, 2**31 + 1203)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["program", "control"])
@pytest.mark.parametrize("workload", [w["name"] for w in harness.manifest()["workloads"]
                                      if w["chips"] == 1])
def test_program_correct_control_not(card, workload, mode):
    cell = harness.cell(workload)
    for seed in SEEDS:
        result = run_cell(cell, seed=seed, seconds=6, trace=False, device=card,
                          t_start=time.perf_counter(), **MODES[mode])
        assert result["correct"] == (mode == "program"), (seed, result["checks"])
