"""The trace's reduction: busy time is the union of the device's
intervals inside the slice, never a sum of their times."""

from __future__ import annotations

import json

import pytest

from benchmark.trace import Trace


def _trace(tmp_path, events):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": [
        {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
        for cat, name, ts, dur in events]}))
    return Trace.load(path)


def test_busy_is_the_union_of_device_intervals(tmp_path):
    tr = _trace(tmp_path, [
        ("kernel", "a", 0.0, 100.0), ("kernel", "b", 50.0, 100.0),  # overlap: 0..150
        ("gpu_memcpy", "copy", 300.0, 100.0), ("cpu_op", "aten::x", 150.0, 150.0),
        ("kernel", "instance_norm_kernel<bf16>", 1000.0, 10.0),
    ])
    assert tr.window_s == pytest.approx(1010e-6)
    assert tr.busy_s() == pytest.approx((150 + 100 + 10) * 1e-6)
    assert tr.device_time_s(lambda n: "instance_norm" in n) == (pytest.approx(10e-6), 1)
    assert tr.top_device_ops(1) == [["a", pytest.approx(100e-6)]]
    gaps = tr.idle_gaps(2, spans=[("engine", 0.0, 500.0)])
    assert gaps[0] == ["outside the spans: no torch op", pytest.approx(600e-6)]
    assert gaps[1] == ["engine: aten::x", pytest.approx(150e-6)]


def test_busy_is_clipped_to_the_slice(tmp_path):
    tr = _trace(tmp_path, [("kernel", "a", 0.0, 100.0), ("kernel", "b", 200.0, 100.0)])
    tr.start, tr.end = 50.0, 250.0
    assert tr.busy_s() == pytest.approx((50 + 50) * 1e-6)
