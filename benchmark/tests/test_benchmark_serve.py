"""The serving cell driven end to end on the CPU at a small size (128x64,
two downsamples as at 512x256, n = 8, 4 clients): the program as run
comes out correct, and each fault the cell can have, planted under the
timed path, comes out not correct under the cell's own limit. The
harness's look for a card is skipped: the cell runs through
``run.run_cell`` on the CPU.

The control (the program's int8 decode) is held to the limit on the card,
at the cell's own size (``test_benchmark_card.py``): at this size each
activation scale covers 16 times fewer values, the int8 error is smaller,
and one seed in three reads under the limit (8.4e-5 against 1e-4)."""

from __future__ import annotations

import copy
import time

import pytest
import torch

from benchmark import harness
from benchmark.run import result_line, run_cell
from benchmark.tools.readings import MODES

WORKLOAD = "otm_default_bf16.serve_n64"
SEEDS = (1, 2, 3)


def small_cell() -> dict:
    cell = copy.deepcopy(harness.cell(WORKLOAD))
    config = cell["config_file"]["config"]
    config["data"]["image_size"] = [128, 64]
    config["architecture"]["min_latent_resolution"] = 16
    cell["traffic_file"].update(n=8, buckets=[8], sources=2, clients=4, check_requests=8,
                                warm_batches=[1, 2], trace_from=1, trace_calls=2)
    return cell


def _run(seed: int, mode: str, trace: bool = False) -> dict:
    return run_cell(small_cell(), seed=seed, seconds=5, trace=trace,
                    device=torch.device("cpu"), t_start=time.perf_counter(), **MODES[mode])


@pytest.mark.parametrize("seed", SEEDS)
def test_program_is_correct(seed):
    result = _run(seed, "program")
    assert result["correct"], result["checks"]
    assert result["failed"] == 0 and result["attempted"] >= 2


@pytest.mark.parametrize("mode", ["half", "altered"])
@pytest.mark.parametrize("seed", SEEDS)
def test_faults_are_not_correct(mode, seed):
    result = _run(seed, mode)
    assert not result["correct"], result["checks"]


def test_traced_line_has_the_cells_metrics():
    """A traced run's line on the CPU: the per-layer metrics that need no
    card are there; those of the device trace are left out, not 0."""
    cell = small_cell()
    result = _run(4, "program", trace=True)
    line = result_line(cell, result, True, {})
    names = set(line["metrics"])
    assert {"serve.queue_ms", "serve.engine_ms", "serve.batch_fill"} <= names
    assert not names & {"serve.instance_norm_roofline", "serve.device_idle_pct"}
    assert list(line)[-1] == "checks"
    assert line["metrics"]["serve.batch_fill"]["value"] >= 1.0
