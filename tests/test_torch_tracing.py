"""The port's spans and counters on the CPU (``utils/profiling.py``,
``serve.py``, ``core/inference.py``).

``span`` costs a flag check with no profiler and no ``SpanStats``, and
is a ``record_function`` range under one; an engine call's spans nest in
``otm.engine.call`` in the order the call runs them, and the benchmark's
``Trace.load`` keeps them; a burst over HTTP under a profiler started as
the benchmark starts it (every thread) records the handler's, the
dispatcher's and the engine's spans from their own threads; ``/stats``
keeps its keys and adds ``spans``, ``queue_depth_max`` and
``padded_rows``; the device's busy time is the union of its intervals.
A tiny model (32x32, fresh weights) on the CPU.
"""

import json
import threading
import time
import urllib.request
import warnings

import numpy as np
import pytest
import torch

from benchmark.trace import Trace
from one_to_many_gan_torch import serve as port_serve
from one_to_many_gan_torch.presets import tiny_config
from one_to_many_gan_torch.utils import profiling

SIZE = 32
ENGINE_ORDER = ["otm.engine.prepare", "otm.engine.draws", "otm.engine.encode",
                "otm.engine.styles", "otm.engine.decode", "otm.engine.readback",
                "otm.engine.gather"]


@pytest.fixture(scope="module")
def engine(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_tracing")
    config = tiny_config((SIZE, SIZE), 2, root=str(root), min_latent=8, n_resnet_blocks=3)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # no checkpoint: fresh weights
        return port_serve.InferenceEngine(config, buckets=(4, 8), device="cpu")


def _source(seed=0) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, (SIZE, SIZE, 1), dtype=np.uint8)


def _png(image_u8: np.ndarray) -> bytes:
    import io

    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(image_u8[..., 0]).save(buf, format="PNG")
    return buf.getvalue()


def _annotations(path) -> list[dict]:
    return [e for e in profiling.trace_events(path) if e.get("cat") == "user_annotation"]


def _all_threads_profiler():
    """The profiler as the serving benchmark starts it (every thread)."""
    config = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU],
                                  experimental_config=config)


# ------------------------------------------------------------------ span


@pytest.mark.parametrize("with_stats", [False, True])
def test_span_without_a_profiler_enters_no_range(monkeypatch, with_stats):
    entered = []
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: entered.append(name))
    stats = profiling.SpanStats() if with_stats else None
    with profiling.span("otm.test", stats) as first:
        pass
    assert entered == []
    if with_stats:
        snap = stats.snapshot()["otm.test"]
        assert snap["count"] == 1 and snap["max"] >= 0.0
    else:  # one shared null context, nothing allocated
        assert profiling.span("otm.other") is profiling.span("otm.test") is not None
        assert first is None


def test_span_stats_keep_the_last_durations_and_count_all():
    stats = profiling.SpanStats(keep=3)
    for ms in (100.0, 1.0, 2.0, 3.0, 4.0):
        stats.record("otm.x", ms)
    stats.error()
    snap = stats.snapshot()["otm.x"]
    assert snap["count"] == 5 and snap["max"] == 4.0 and snap["p50"] == 3.0
    assert stats.last("otm.x") == 4.0 and stats.errors == 1


def test_engine_spans_nest_in_the_call_in_order(engine, tmp_path):
    with profiling.trace(tmp_path, device="cpu") as path:
        engine.generate_batch([_source(0), _source(1)], [4, 8], [1, 2], [1.0, 0.5])
    spans = _annotations(path)
    (call,) = [e for e in spans if e["name"] == "otm.engine.call"]
    start, end = call["ts"], call["ts"] + call["dur"]
    inside = sorted((e for e in spans if e["name"].startswith("otm.engine.")
                     and e is not call and start <= e["ts"] <= end), key=lambda e: e["ts"])
    assert [e["name"] for e in inside] == ENGINE_ORDER
    assert all(e["ts"] + e["dur"] <= end for e in inside)
    host = {name for name, _, _ in Trace.load(path).host_ops}
    assert {"otm.engine.call", *ENGINE_ORDER} <= host


# ----------------------------------------------------------- the server


@pytest.fixture(scope="module")
def burst(engine, tmp_path_factory):
    """Three requests at once to a new server (a 500 ms window, so they
    form one group in batch bucket 4) under an every-thread profiler;
    -> the trace's user annotations and /stats after the burst."""
    engine.warmup(batched=False)  # a fresh engine.stats
    server = port_serve.make_server(engine, host="127.0.0.1", port=0, window_ms=500.0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    path = tmp_path_factory.mktemp("burst") / "trace.json"
    barrier = threading.Barrier(3)

    def client(i):
        barrier.wait(timeout=30)
        req = urllib.request.Request(f"{base}/generate?n=4&seed={i}&format=npy",
                                     data=_png(_source(i)))
        with urllib.request.urlopen(req, timeout=60) as resp:
            resp.read()

    def get_stats():
        with urllib.request.urlopen(f"{base}/stats", timeout=30) as resp:
            return json.loads(resp.read())

    try:
        with _all_threads_profiler() as prof:
            clients = [threading.Thread(target=client, args=(i,)) for i in range(3)]
            for t in clients:
                t.start()
            for t in clients:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in clients)
            # a client can hold its reply before the handler leaves its
            # span, which is kept in /stats once its range has ended
            deadline = time.monotonic() + 30
            while (get_stats()["spans"].get("otm.http.reply", {}).get("count") != 3
                   and time.monotonic() < deadline):
                time.sleep(0.01)
            time.sleep(0.1)  # the dispatcher's deliver range ends after the boxes are set
        prof.export_chrome_trace(str(path))
        stats = get_stats()
    finally:
        server.shutdown()
        server.server_close()
        server.batcher.close()
        thread.join(timeout=30)
    return _annotations(path), stats


def test_burst_records_spans_from_every_thread(burst):
    spans, _ = burst
    names = [e["name"] for e in spans]
    assert names.count("otm.http.reply") == 3
    assert names.count("otm.batcher.deliver") == 1 and names.count("otm.engine.call") == 1
    assert {"otm.http.decode", "otm.http.wait", "otm.batcher.collect",
            "otm.batcher.launch"} <= set(names)
    threads = {e["tid"] for e in spans if e["name"] in (
        "otm.http.reply", "otm.batcher.deliver", "otm.engine.call")}
    assert len(threads) >= 3


def test_stats_keep_their_keys_and_add_spans_and_counters(burst):
    _, stats = burst
    assert stats["requests"] == 3 and stats["errors"] == 0
    assert set(stats["latency_ms"]) == {"p50", "p95", "max"}
    batching = stats["batching"]
    assert batching["device_calls"] == 1 and batching["coalesced_requests"] == 2
    assert batching["hangs"] == 0 and batching["queue_depth_max"] == 3
    assert batching["padded_rows"] == 1  # 3 requests in batch bucket 4
    spans = stats["spans"]
    assert {"otm.http.request", "otm.batcher.queue", "otm.engine.call",
            "otm.http.reply"} <= set(spans)
    assert spans["otm.batcher.queue"]["count"] == 3 and spans["otm.engine.call"]["count"] == 1
    assert stats["latency_ms"]["max"] == spans["otm.http.request"]["max"]


def test_unbatched_server_times_requests_and_engine_calls(engine):
    engine.warmup(batched=False)
    server = port_serve.make_server(engine, host="127.0.0.1", port=0, max_batch=1)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        req = urllib.request.Request(f"{base}/generate?n=4&format=npy", data=_png(_source()))
        with urllib.request.urlopen(req, timeout=60) as resp:
            resp.read()
        with urllib.request.urlopen(f"{base}/stats", timeout=30) as resp:
            stats = json.loads(resp.read())
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    assert server.batcher is None and "batching" not in stats
    assert stats["requests"] == 1 and stats["spans"]["otm.engine.call"]["count"] == 1


# ------------------------------------------------------- device busy time


@pytest.mark.parametrize(("intervals", "busy_us"), [
    ([], 0.0),
    ([(0.0, 100.0), (50.0, 150.0)], 150.0),  # overlap counted once
    ([(0.0, 100.0), (20.0, 30.0), (200.0, 250.0)], 150.0),  # nested, then apart
    ([(10.0, 20.0)] * 3, 10.0),  # the same interval thrice
])
def test_device_busy_is_the_union_of_intervals(intervals, busy_us):
    busy = profiling.device_busy_s(intervals)
    assert busy == pytest.approx(busy_us * 1e-6)
    if intervals:
        window = max(b for _, b in intervals) - min(a for a, _ in intervals)
        assert busy * 1e6 <= window + 1e-9  # a share of the window <= 1


def test_device_intervals_keep_device_operations_clipped(tmp_path):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": [
        {"ph": "X", "cat": "kernel", "name": "k", "ts": 0, "dur": 100},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 150, "dur": 100},
        {"ph": "X", "cat": "gpu_user_annotation", "name": "otm.engine.decode", "ts": 0,
         "dur": 400},
        {"ph": "X", "cat": "user_annotation", "name": "otm.engine.call", "ts": 0, "dur": 400},
        {"ph": "i", "cat": "kernel", "name": "instant", "ts": 5},
    ]}))
    events = profiling.trace_events(path)
    assert profiling.device_intervals(events) == [(0.0, 100.0), (150.0, 250.0)]
    assert profiling.device_intervals(events, within=(50.0, 200.0)) == [(50.0, 100.0),
                                                                       (150.0, 200.0)]
