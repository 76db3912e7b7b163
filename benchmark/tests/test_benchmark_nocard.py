"""A run on a host without the cards it needs prints no result and fails,
as does a run from a directory that holds only the benchmark's files."""

from __future__ import annotations

import json
import shutil
import subprocess
import sys

import pytest

from benchmark import harness

WORKLOADS = [w["name"] for w in harness.manifest()["workloads"]]


def _run(cwd, workload: str) -> subprocess.CompletedProcess:
    cmd = [*harness.manifest()["command"], "--workload", workload, "--seed", str(2**31 + 7),
           "--seconds", "1", "--trace", "0"]
    cmd[0] = sys.executable if cmd[0].startswith("python") else cmd[0]
    return subprocess.run(cmd, cwd=cwd, capture_output=True, text=True, timeout=300,
                          check=False, env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})


def _has_result(out: str) -> bool:
    for line in out.splitlines():
        try:
            if "correct" in json.loads(line):
                return True
        except (json.JSONDecodeError, TypeError):
            continue
    return False


@pytest.mark.parametrize("workload", WORKLOADS)
def test_no_card_no_result(workload):
    proc = _run(harness.REPO, workload)
    assert proc.returncode != 0
    assert not _has_result(proc.stdout)
    assert "CUDA card" in proc.stderr


def test_only_the_benchmark_files_no_result(tmp_path):
    shutil.copy(harness.REPO / "BENCHMARK.json", tmp_path)
    for path in harness.manifest()["paths"]:
        shutil.copytree(harness.REPO / path, tmp_path / path,
                        ignore=shutil.ignore_patterns("__pycache__"))
    proc = _run(tmp_path, WORKLOADS[0])
    assert proc.returncode != 0
    assert not _has_result(proc.stdout)
