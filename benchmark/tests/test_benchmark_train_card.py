"""On four cards, at the cell's own size: the program as run reads
correct and the control (the reference in float8 put in its place) does
not, on three seeds; each fault planted under the step reads not correct
on three seeds. One launch of the ranks (``tools/train_readings.py``).

    python -m pytest --noconftest -p no:cacheprovider benchmark/tests/test_benchmark_train_card.py -m cuda
"""

from __future__ import annotations

import json

import pytest
import torch

from benchmark import harness
from benchmark.tools import train_readings

WORKLOAD = "otm_prod512.train_dp4"
SEEDS = (2**31 + 2201, 2**31 + 2202, 2**31 + 2203)
FAULTS = ("exchange", "half", "p0", "r1", "path")


@pytest.mark.cuda
def test_program_correct_control_and_faults_not(tmp_path):
    chips = harness.cell(WORKLOAD)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        pytest.skip(f"needs {chips} CUDA cards")
    out = tmp_path / "readings.jsonl"
    seeds = ",".join(map(str, SEEDS))
    assert train_readings.main(["--workload", WORKLOAD, "--seeds", seeds,
                                "--modes", ",".join(("program", *FAULTS)),
                                "--out", str(out)]) == 0
    rows = [json.loads(line) for line in out.read_text().splitlines()]
    assert len(rows) == len(SEEDS) * (1 + len(FAULTS))
    for row in rows:
        if row["mode"] == "program":
            assert row["correct"], row["checks"]
            assert not all(c["value"] <= c["limit"] for c in row["control_checks"].values())
        else:
            assert not row["correct"], (row["mode"], row["checks"])
