"""The training cell's trace loader keeps ``gpu_user_annotation`` ranges
in a list of their own: the device and host operations it keeps are
``Trace.load``'s, so the serving cell's readers read the same numbers
with and without those events, and the training readers find their
ranges."""

from __future__ import annotations

import json
from types import SimpleNamespace

import pytest

from benchmark import harness, train_trace
from benchmark.trace import Trace


def _events(with_annotations: bool) -> list[dict]:
    ev = []

    def x(name, cat, ts, dur):
        ev.append({"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur})

    x(train_trace.PERIOD, "user_annotation", 1000.0, 9000.0)
    for k in range(2):
        t = 1000.0 + 4000.0 * k
        x("otm.train.data_wait", "user_annotation", t, 100.0)
        x("otm.engine.call", "user_annotation", t, 3000.0)
        x("otm.train.d_phase", "user_annotation", t + 100.0, 900.0)
        x("otm.train.g_phase", "user_annotation", t + 1000.0, 2000.0)
        x("conv_kernel", "kernel", t + 200.0, 600.0)
        x("ncclDevKernel_AllReduce_Sum_f32", "kernel", t + 850.0, 100.0)
        x("gemm_kernel", "kernel", t + 1100.0, 1700.0)
        x("ncclDevKernel_AllReduce_Sum_f32", "kernel", t + 2850.0, 150.0)
        x("Memcpy HtoD", "gpu_memcpy", t + 50.0, 40.0)
        if with_annotations:
            x("otm.train.d_phase", "gpu_user_annotation", t + 200.0, 750.0)
            x("otm.train.g_phase", "gpu_user_annotation", t + 1100.0, 1900.0)
            x("otm.engine.call", "gpu_user_annotation", t + 50.0, 2950.0)
    return ev


def _write(tmp_path, with_annotations: bool):
    path = tmp_path / f"trace{int(with_annotations)}.json"
    path.write_text(json.dumps({"traceEvents": _events(with_annotations)}))
    return path


def test_device_and_host_operations_are_trace_loads(tmp_path):
    for flag in (False, True):
        path = _write(tmp_path, flag)
        old, (new, annotations) = Trace.load(path), train_trace.load(path)
        assert new.device_ops == old.device_ops and new.host_ops == old.host_ops
        assert (new.start, new.end) == (old.start, old.end)
        assert len(annotations) == (6 if flag else 0)


@pytest.mark.parametrize("name", ["serve.device_idle_pct", "serve.dispatch_ms"])
def test_serving_readers_read_the_same_with_annotations(tmp_path, name):
    values = []
    for flag in (False, True):
        tr = Trace.load(_write(tmp_path, flag))
        values.append(harness.read_metric(name, SimpleNamespace(trace=tr)))
    assert values[0] == values[1]


def test_training_readers_find_their_ranges(tmp_path):
    tr, annotations = train_trace.load(_write(tmp_path, True))
    tr.bound_to_period()
    assert (tr.start, tr.end) == (1000.0, 10000.0)
    run = SimpleNamespace(trace=tr, annotations=annotations, steps=2, chips=4,
                          rates={"train_images_per_s": 10.0}, work={"flops_per_image": 1e12},
                          peaks=harness.peaks(), precision="bfloat16")
    assert harness.read_metric("train.d_phase_ms", run) == pytest.approx(0.7)
    assert harness.read_metric("train.g_phase_ms", run) == pytest.approx(1.85)
    assert harness.read_metric("train.exchange_ms", run) == pytest.approx(0.25)
    assert harness.read_metric("train.data_wait_ms", run) == pytest.approx(0.1)
    busy = 2 * (40 + 600 + 100 + 1700 + 150) / 1e6
    assert tr.own_busy_s() == pytest.approx(busy)
    assert harness.read_metric("train.device_idle_pct", run) == pytest.approx(
        100 * (1 - busy / 0.009))
    assert harness.read_metric("train_mfu", run) == pytest.approx(
        100 * 10.0 * 1e12 / (4 * 989e12))
    tr.rank_busy = [0.004, 0.006]
    assert tr.busy_s() == pytest.approx(0.005)
    names = [n for n, _, _ in tr.spans()]
    assert names[0] == "otm.train.data_wait" and "otm.engine.call" not in names


def test_readers_find_nothing_without_a_trace():
    run = SimpleNamespace(trace=None, annotations=[], steps=16, chips=4, rates={}, work={},
                          peaks=harness.peaks(), precision="bfloat16")
    for m in harness.cell("otm_prod512.train_dp4")["per_layer"]:
        assert harness.read_metric(m["name"], run) is None, m["name"]
