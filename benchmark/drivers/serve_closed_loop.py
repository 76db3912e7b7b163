"""Closed-loop serving: the port's HTTP server under a fixed number of
clients that each wait for their reply.

Set-up: the program's config is written from the configuration file;
weights and synthetic prints are made from the seed; the program's
``InferenceEngine`` is built, given the weights, and warmed at the n
bucket and the batch buckets the traffic uses; ``make_server`` serves on
a free port of 127.0.0.1; the clients' process (``benchmark/clients.py``)
starts. The window opens when the clients are ready and lasts
``--seconds``. With ``--trace 1`` the benchmark's spans wrap the
batcher's ``submit`` and the engine's ``generate_batch`` (the engine's
calls run one at a time and each ends in its copy to the host), and
``torch.profiler`` records ``trace_calls`` whole engine calls from the
``trace_from``-th of the window.

After the window: the card's peak memory is read, the program is shut
down and freed, and a sample of the replies finished in the window is
held to the plain float32 reference (TF32 off) computed from the same
weights, prints, seeds and thetas.
"""

from __future__ import annotations

import gc
import io
import json
import statistics
import subprocess
import sys
import threading
import time
import warnings
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

from benchmark import formulas, harness, synth
from benchmark.trace import Trace


def _png(image_u8: np.ndarray) -> bytes:
    from PIL import Image

    img = image_u8[:, :, 0] if image_u8.shape[-1] == 1 else image_u8
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="PNG")
    return buf.getvalue()


def make_weights(ref, config: dict, seed: int, device) -> tuple[dict, dict]:
    """The generator's and the mapping network's weights from ``seed``,
    in one draw on ``device``."""
    gen, mapping = ref.build(config, "meta")
    shapes = {f"g.{k}": v.shape for k, v in gen.state_dict().items()}
    shapes |= {f"m.{k}": v.shape for k, v in mapping.state_dict().items()}
    draws = synth.normals(shapes, seed, device)
    return (ref.init_weights({k[2:]: v for k, v in draws.items() if k.startswith("g.")}),
            ref.init_weights({k[2:]: v for k, v in draws.items() if k.startswith("m.")}))


class _Spans:
    """The benchmark's spans around the batcher and the engine.

    Each engine call runs in a thread of its own (the batcher's
    watchdog), so the profiler is started and stopped by the window's
    thread (``serve``), at the request of the first and after the last
    traced call, which wait for it: the traced slice holds whole calls."""

    def __init__(self, engine, batcher, traffic: dict, device, run_dir: Path):
        self.engine, self.batcher = engine, batcher
        self.trace_from, self.trace_calls = traffic["trace_from"], traffic["trace_calls"]
        self.device, self.run_dir = device, run_dir
        self.open = False
        self.calls = 0
        self.entries: dict[int, float] = {}
        self.queue_ms: list[float] = []
        self.engine_ms: list[float] = []
        self.traced_batches: list[int] = []
        self.prof = None
        self.trace_path = None
        self.cv = threading.Condition()
        self.pending = None
        self._submit, self._generate = batcher.submit, engine.generate_batch
        batcher.submit, engine.generate_batch = self.submit, self.generate_batch

    def submit(self, src, n, seed, theta):
        self.entries[id(src)] = time.monotonic()
        return self._submit(src, n, seed, theta)

    def _ask(self, what: str) -> None:
        """Have the window's thread start or stop the profiler; wait."""
        with self.cv:
            if not self.open:
                return
            self.pending = what
            self.cv.notify_all()
            while self.pending is not None and self.open:
                self.cv.wait()

    def serve(self, t_end: float) -> None:
        """Open the window, start and stop the profiler when asked, and
        close the window at ``t_end``."""
        with self.cv:
            self.open = True
            while (remaining := t_end - time.monotonic()) > 0:
                if self.pending == "start":
                    self.prof = _profiler(self.device)
                    self.prof.start()
                elif self.pending == "stop":
                    self.stop_profile()
                else:
                    self.cv.wait(remaining)
                    continue
                self.pending = None
                self.cv.notify_all()
            self.open = False
            self.pending = None
            self.cv.notify_all()

    def stop_profile(self) -> None:
        if self.prof is not None and self.trace_path is None:
            self.prof.stop()
            self.trace_path = self.run_dir / "trace.json"
            self.prof.export_chrome_trace(str(self.trace_path))

    def generate_batch(self, images, ns, seeds, thetas):
        t = time.monotonic()
        for im in images:
            entered = self.entries.pop(id(im), None)
            if entered is not None and self.open:
                self.queue_ms.append((t - entered) * 1e3)
        traced = self.open and self.trace_from <= self.calls < self.trace_from + self.trace_calls
        if traced and self.prof is None:
            self._ask("start")
            t = time.monotonic()
        with torch.profiler.record_function("bench.engine"):
            out = self._generate(images, ns, seeds, thetas)
        if self.open:
            self.engine_ms.append((time.monotonic() - t) * 1e3)
            if traced and self.prof is not None:
                self.traced_batches.append(self.engine.batch_bucket_for(len(images)))
            self.calls += 1
            if self.calls == self.trace_from + self.trace_calls:
                self._ask("stop")
        return out


def _profiler(device):
    """CPU and CUDA activity of every thread (the engine's calls run in
    threads of their own) where this torch can record them."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    try:
        config = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    except (AttributeError, TypeError):
        return torch.profiler.profile(activities=activities)
    return torch.profiler.profile(activities=activities, experimental_config=config)


def _warm_profiler(device) -> None:
    """The profiler's first start initialises its tracer; do it in set-up."""
    with _profiler(device):
        torch.ones(8, device=device).sum().item()


def run(ctx) -> dict:
    """One run of a serving cell (module docstring); ``ctx``: ``cell``,
    ``seed``, ``seconds``, ``trace``, ``device``, ``run_dir``,
    ``t_start`` (``time.perf_counter`` at the process's start), ``log``,
    and ``engine_options`` / ``wrap_engine`` (controls and faults: None in
    the benchmark's own runs)."""
    from one_to_many_gan_torch.config import load_config
    from one_to_many_gan_torch.serve import InferenceEngine, make_server

    cell, traffic, log = ctx.cell, ctx.cell["traffic_file"], ctx.log
    device, run_dir, seed = ctx.device, ctx.run_dir, ctx.seed
    parts: dict[str, float] = {}
    t = time.perf_counter()
    parts["imports"] = t - ctx.t_start

    def lap(name: str) -> None:
        nonlocal t
        now = time.perf_counter()
        parts[name] = now - t
        t = now

    config = load_config(harness.write_program_config(
        ctx.cell["config_file"]["config"], run_dir / "config.toml",
        training={"checkpoint_directory": str(run_dir / "checkpoints")},
        data={"shoeprint_data_dir": str(run_dir / "prints"),
              "shoemark_data_dir": str(run_dir / "marks")},
    ))
    ref = harness.reference(ctx.cell["config_file"]["reference"])
    h, w = config["data"]["image_size"]
    c = config["data"]["image_channels"]
    n = traffic["n"]
    w_g, w_m = make_weights(ref, config, seed, device)
    sources = synth.prints(seed, traffic["sources"], h, w, c)
    source_paths = []
    for i, src in enumerate(sources):
        path = run_dir / f"source_{i}.png"
        path.write_bytes(_png(src))
        source_paths.append(str(path))
    lap("inputs")

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # "serving fresh weights": replaced below
        engine = InferenceEngine(config, buckets=traffic["buckets"], device=device,
                                 **(getattr(ctx, "engine_options", None) or {}))
    for replica in engine.replicas:
        replica.generator.load_state_dict(w_g)
        replica.mapping.load_state_dict(w_m)
    if getattr(ctx, "wrap_engine", None) is not None:
        ctx.wrap_engine(engine)
    lap("engine")

    for bb in traffic["warm_batches"]:
        engine.generate_batch([sources[0]] * bb, [n] * bb, [0] * bb, [1.0] * bb)
    if ctx.trace:
        _warm_profiler(device)
    lap("warmup")

    server = make_server(engine, "127.0.0.1", 0, max_batch=traffic["max_batch"],
                         window_ms=traffic["window_ms"])
    server_thread = threading.Thread(target=server.serve_forever, kwargs={"poll_interval": 0.05},
                                     name="bench-server")
    server_thread.start()
    spans = _Spans(engine, server.batcher, traffic, device, run_dir) if ctx.trace else None
    spec = {
        "port": server.server_address[1], "sources": source_paths, "n": n,
        "thetas": traffic["thetas"], "clients": traffic["clients"], "seed": seed,
        "seconds": ctx.seconds, "sample": traffic["check_requests"],
        "timeout_s": traffic["request_timeout_s"], "image_shape": [h, w, c],
        "out_dir": str(run_dir),
    }
    (run_dir / "clients.json").write_text(json.dumps(spec))
    clients = subprocess.Popen(
        [sys.executable, "-m", "benchmark.clients", str(run_dir / "clients.json")],
        cwd=harness.REPO, stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True,
    )
    try:
        if clients.stdout.readline().strip() != "ready":
            msg = "the clients' process did not start"
            raise RuntimeError(msg)
        lap("server_and_clients")
        setup_s = time.perf_counter() - ctx.t_start
        t0 = time.monotonic()
        before = (server.batcher.batches, server.batcher.coalesced)
        clients.stdin.write(f"{t0!r}\n")
        clients.stdin.flush()
        t_end = t0 + ctx.seconds
        if spans is not None:
            spans.serve(t_end)
        time.sleep(max(0.0, t_end - time.monotonic()))
        after = (server.batcher.batches, server.batcher.coalesced)
        done = clients.stdout.readline().strip()
        clients.wait(timeout=traffic["request_timeout_s"] + 30)
    finally:
        if clients.poll() is None:
            clients.kill()
            clients.wait()
        if spans is not None:
            spans.stop_profile()
        server.shutdown()
        server.server_close()
        server.batcher.close()
        server_thread.join()
    if done != "done" or clients.returncode != 0:
        msg = f"the clients' process failed (exit {clients.returncode})"
        raise RuntimeError(msg)

    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    del engine, server
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    log(f"setup_s {setup_s:.3f}: " + ", ".join(f"{k} {v:.3f}" for k, v in parts.items()))
    data = json.loads((run_dir / "requests.json").read_text())
    records = data["records"]
    finished = [r for r in records if r["ok"] and r["t_done"] <= t_end]
    failed = [r for r in records if not r["ok"]]
    for r in failed[:5]:
        log(f"failed request {r['client']}/{r['k']}: status {r['status']} {r['error']}")
    latencies = sorted((r["t_done"] - r["t_send"]) * 1e3 for r in finished)
    images_per_s = n * len(finished) / ctx.seconds
    if latencies:
        p95 = float(np.percentile(latencies, 95))
        log(f"window {ctx.seconds} s: {len(records)} requests sent, {len(finished)} finished "
            f"in it, {len(failed)} failed; latency ms p50 {statistics.median(latencies):.2f} "
            f"p95 {p95:.2f} ({sum(x > p95 for x in latencies)} beyond) max {latencies[-1]:.2f}; "
            f"device calls {after[0] - before[0]}, coalesced {after[1] - before[1]}")
    else:
        p95 = float("nan")
        log(f"window {ctx.seconds} s: {len(records)} requests sent, none finished in it")

    values = compare(ctx, ref, config, w_g, w_m, sources, data["sample"], n)
    limits = ctx.cell["limits"]["limits"]
    checks = {name: {"value": values[name], "limit": limit} for name, limit in limits.items()}
    result = {
        "attempted": len(records),
        "failed": len(failed),
        "checks": checks,
        "readings": values,
        "correct": not failed and bool(data["sample"])
        and all(ch["value"] <= ch["limit"] for ch in checks.values()),
        "end_to_end": {"serve_images_per_s": images_per_s, "serve_p95_ms": p95,
                       "setup_s": setup_s},
        "memory_peak_bytes": peak,
    }
    if spans is not None:
        work = formulas.serve_work(ref, config, n, 1)
        by_batch = {bb: formulas.serve_work(ref, config, n, bb)["instance_norm_bytes"]
                    for bb in set(spans.traced_batches)}
        trace = Trace.load(spans.trace_path) if spans.trace_path else None
        engine_spans = []
        if trace is not None:
            engine_spans = [op for op in trace.host_ops if op[0] == "bench.engine"]
            if engine_spans:
                trace.start = min(op[1] for op in engine_spans)
                trace.end = max(op[2] for op in engine_spans)
        result["run"] = SimpleNamespace(
            spans={"serve.queue": spans.queue_ms, "serve.engine": spans.engine_ms},
            counters={"batches": after[0] - before[0], "coalesced": after[1] - before[1]},
            trace=trace,
            work={"flops_per_image": work["flops_per_image"],
                  "instance_norm_bytes": sum(by_batch[bb] for bb in spans.traced_batches)},
            rates={"serve_images_per_s": images_per_s},
            peaks=harness.peaks(),
            precision=config["tpu"]["precision"],
        )
        if trace is not None:
            result["breakdown"] = {"device_ops": trace.top_device_ops(10),
                                   "idle_gaps": trace.idle_gaps(10, engine_spans)}
    return result


def readings(served: np.ndarray, want: np.ndarray) -> dict:
    """Per request: the share of its pixels more than 16 uint8 levels
    from the reference's, the mean squared difference in levels, and the
    worst image's."""
    d = served.astype(np.float64) - want.astype(np.float64)
    per_image = (d**2).reshape(d.shape[0], -1).mean(axis=1)
    return {"over16": float(np.mean(np.abs(d) > 16)), "mse": float(per_image.mean()),
            "worst_image_mse": float(per_image.max())}


def compare(ctx, ref, config, w_g, w_m, sources, sample, n) -> dict:
    """The sampled replies against the reference; -> the readings: the
    share of a request's pixels more than 16 levels from the reference's,
    averaged over the sampled requests (the compared number) and at its
    worst, and the worst request's and the worst image's mean squared
    difference in uint8 levels."""
    device, log = ctx.device, ctx.log
    t = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen, mapping = ref.build(config, device)
    gen.load_state_dict(w_g)
    mapping.load_state_dict(w_m)
    w_dim = config["architecture"]["w_dim"]
    per_request = []
    with torch.inference_mode():
        for s in sample:
            z = torch.randn((n, w_dim), generator=torch.Generator(device).manual_seed(s["seed"]),
                            device=device)
            src = torch.from_numpy(sources[s["source"]]).to(device)
            want = ref.one_to_many(gen, mapping, src, z, s["theta"]).cpu().numpy()
            per_request.append(readings(np.load(s["path"]), want))
    values = {
        "mean_share_over_16_levels": float(np.mean([r["over16"] for r in per_request]))
        if per_request else float("nan"),
        "worst_share_over_16_levels": max((r["over16"] for r in per_request),
                                          default=float("nan")),
        "worst_request_mse": max((r["mse"] for r in per_request), default=float("nan")),
        "worst_image_mse": max((r["worst_image_mse"] for r in per_request),
                               default=float("nan")),
    }
    log(f"reference over {len(sample)} requests ({len(sample) * n} images) in "
        f"{time.perf_counter() - t:.2f} s: " + ", ".join(f"{k} {v:.6g}" for k, v in values.items())
        + "; per request over16 " + " ".join(f"{r['over16']:.3g}" for r in per_request))
    return values
