"""``BENCHMARK.json`` against the contract's form, and every name it uses
against the files the harness finds by it."""

from __future__ import annotations

import json
import re

import pytest

from benchmark import harness

BENCH = harness.manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert len(json.dumps(BENCH)) <= 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert 1 <= len(BENCH["command"]) <= 32 and all(_line(w) for w in BENCH["command"])
    for path in BENCH["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", path) and ".." not in path
        assert not path.startswith("/") and (harness.REPO / path).is_dir()


@pytest.mark.parametrize("entry", BENCH["configs"] + BENCH["workloads"] + METRICS,
                         ids=lambda e: e["name"])
def test_names(entry):
    assert NAME.match(entry["name"])
    for key in ("config", "traffic"):
        if key in entry:
            assert NAME.match(entry[key])
    for key in entry.get("reduced", []):
        assert NAME.match(key)
    for key in ("why", "layer", "source"):
        if key in entry:
            assert _line(entry[key])


def test_unique_names():
    for group in (BENCH["configs"], BENCH["workloads"], METRICS):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_fields(metric):
    allowed = {"name", "unit", "better", "source", "workloads"}
    allowed |= {"bound"} if metric in BENCH["end_to_end"] else {"layer", "moves"}
    assert set(metric) <= allowed
    assert UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    assert metric["source"] in SOURCES
    if metric in BENCH["end_to_end"]:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    for w in metric.get("workloads", []):
        assert w in {c["name"] for c in BENCH["workloads"]}


def _reports(metric: dict) -> set[str]:
    return set(metric.get("workloads", [w["name"] for w in BENCH["workloads"]]))


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_moves_an_end_to_end_metric_of_its_cells(metric):
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert metric["moves"] in e2e
    assert _reports(metric) <= _reports(e2e[metric["moves"]])
    assert (harness.ROOT / "metrics" / f"{metric['name']}.py").is_file()


@pytest.mark.parametrize("workload", BENCH["workloads"], ids=lambda w: w["name"])
def test_cells(workload):
    assert workload["chips"] in (1, 4)
    cell = harness.cell(workload["name"])
    names = {m["name"] for m in cell["end_to_end"]}
    assert "setup_s" in names and len(names) >= 2 and cell["per_layer"]
    assert (harness.ROOT / "drivers" / f"{cell['traffic_file']['driver']}.py").is_file()
    assert (harness.ROOT / "reference" / f"{cell['config_file']['reference']}.py").is_file()
    assert cell["limits"]["limits"]


def test_configs_are_used_and_under_paths():
    used = {w["config"] for w in BENCH["workloads"]}
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    for c in BENCH["configs"]:
        assert c["name"] in used
        assert any(c["file"].startswith(p + "/") for p in BENCH["paths"])
        assert len(c["reduced"]) <= 16
        data = harness.load_json(harness.REPO / c["file"])
        assert set(c["reduced"]) == set(data["changed"])


def test_four_chip_cells_at_most_a_quarter():
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)
