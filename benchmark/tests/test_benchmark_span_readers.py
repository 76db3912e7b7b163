"""The readers of the program's spans (``serve.dispatch_ms``,
``serve.engine_host_ms``, ``serve.reply_ms``) on synthetic Chrome traces:
what each reads, and None where a trace holds none of its spans (a
program without them) or the run has no trace."""

from __future__ import annotations

import json
from types import SimpleNamespace

import pytest

from benchmark import harness
from benchmark.trace import Trace

READERS = ("serve.dispatch_ms", "serve.engine_host_ms", "serve.reply_ms")


def _run(tmp_path, spans, kernels=(("k", 0.0, 5000.0),)):
    """A run whose trace holds ``spans`` (name, ts, dur) as the program's
    user annotations, and ``kernels`` on the device."""
    events = [{"ph": "X", "cat": "user_annotation", "name": n, "ts": ts, "dur": dur}
              for n, ts, dur in spans]
    events += [{"ph": "X", "cat": "kernel", "name": n, "ts": ts, "dur": dur}
               for n, ts, dur in kernels]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return SimpleNamespace(trace=Trace.load(path))


def test_dispatch_is_the_median_gap_between_engine_calls(tmp_path):
    calls = [("otm.engine.call", 0.0, 1000.0), ("otm.engine.call", 1040.0, 1000.0),
             ("otm.engine.call", 2100.0, 900.0), ("otm.engine.call", 3050.0, 500.0)]
    # gaps 40, 60 and 50 us; listed out of order
    run = _run(tmp_path, calls[::-1] + [("otm.batcher.deliver", 1000.0, 10.0)])
    assert harness.read_metric("serve.dispatch_ms", run) == pytest.approx(0.050)


def test_engine_host_sums_prepare_and_gather_per_call(tmp_path):
    run = _run(tmp_path, [
        ("otm.engine.call", 0.0, 1000.0), ("otm.engine.prepare", 10.0, 100.0),
        ("otm.engine.decode", 200.0, 500.0), ("otm.engine.gather", 800.0, 150.0),
        ("otm.engine.call", 2000.0, 1000.0), ("otm.engine.prepare", 2010.0, 300.0),
        ("otm.engine.gather", 2800.0, 150.0),
        ("otm.engine.call", 4000.0, 1000.0), ("otm.engine.prepare", 4010.0, 200.0),
        ("otm.engine.gather", 4800.0, 150.0),
        ("otm.engine.prepare", 3100.0, 5000.0),  # inside no call
    ])
    assert harness.read_metric("serve.engine_host_ms", run) == pytest.approx(0.350)


def test_reply_reads_replies_whole_inside_the_slice(tmp_path):
    run = _run(tmp_path, [("otm.http.reply", 100.0, 20.0), ("otm.http.reply", 200.0, 40.0),
                          ("otm.http.reply", 300.0, 30.0), ("otm.http.reply", 4990.0, 900.0),
                          ("otm.http.request", 0.0, 400.0)])
    run.trace.start, run.trace.end = 50.0, 5000.0  # the last reply ends after the slice
    assert harness.read_metric("serve.reply_ms", run) == pytest.approx(0.030)


@pytest.mark.parametrize("name", READERS)
def test_readers_find_nothing_without_the_programs_spans(tmp_path, name):
    parent = _run(tmp_path, [("bench.engine", 0.0, 1000.0), ("bench.engine", 1500.0, 900.0),
                             ("aten::conv2d", 10.0, 100.0)])
    assert harness.read_metric(name, parent) is None
    assert harness.read_metric(name, SimpleNamespace(trace=None)) is None


def test_traced_line_reads_the_programs_spans():
    """A traced run of the serving cell on the CPU (the small cell of
    ``test_benchmark_serve.py``) prints the three metrics."""
    from benchmark.run import result_line
    from benchmark.tests.test_benchmark_serve import _run as run_small
    from benchmark.tests.test_benchmark_serve import small_cell

    line = result_line(small_cell(), run_small(5, "program", trace=True), True, {})
    for name in READERS:
        assert line["metrics"][name]["value"] >= 0.0, name
