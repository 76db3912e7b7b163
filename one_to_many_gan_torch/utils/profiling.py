"""Profiling: a ``torch.profiler`` trace of a block, the program's spans,
and the device's busy time in a trace.

- ``trace(log_dir, device)``: records the block's CPU activity on every
  thread, and its CUDA activity when ``device`` is a card, and writes a
  Chrome trace (``chrome://tracing``, Perfetto, TensorBoard's profile
  plugin) under ``log_dir``. The device is synchronised before recording
  starts and before it stops, so the trace holds the block's device work
  whole.
- ``span(name, stats)``: a named range of host work. While any profiler
  runs it is a ``torch.profiler.record_function`` range, on the
  profiler's clock beside the kernels it launches; with ``stats`` (a
  ``SpanStats``) its duration is also kept there. Otherwise it costs a
  flag check.
- ``trace_events(path)``, ``device_intervals(events)``,
  ``device_busy_s(intervals)``: a Chrome trace's complete events, its
  device operations' intervals, and their union in seconds (overlapping
  operations count once).
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from collections import deque
from pathlib import Path

import numpy as np
import torch
from torch.autograd import profiler as _autograd_profiler

from one_to_many_gan_torch.device import select_device

# Chrome-trace categories of work on the device.
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")

_NO_SPAN = contextlib.nullcontext()


def _profiler(device: torch.device):
    """CPU activity, and CUDA activity on a card, of every thread where
    this torch records them (the server's handlers, dispatcher and engine
    calls, and the Trainer's producer, are threads of their own)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    try:
        config = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    except (AttributeError, TypeError):
        return profile(activities=activities)
    return profile(activities=activities, experimental_config=config)


@contextlib.contextmanager
def trace(log_dir: Path | str, device=None):
    """Trace the block on ``device`` (None: ``cuda``, raising without a
    GPU). Yields the path of the trace file, ``<log_dir>/<time>.<pid>
    .trace.json``, written when the block ends (also when it raises)."""
    device = select_device(device)
    path = Path(log_dir) / f"{time.strftime('%Y%m%d-%H%M%S')}.{os.getpid()}.trace.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    prof = _profiler(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    prof.start()
    try:
        yield path
    finally:
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        prof.stop()
        prof.export_chrome_trace(str(path))


class SpanStats:
    """Durations of named spans, the last ``keep`` of each, and an error
    count; safe to share between threads."""

    def __init__(self, keep: int = 10_000):
        self._lock = threading.Lock()
        self._keep = keep
        self._ms: dict[str, deque] = {}
        self._counts: dict[str, int] = {}
        self.errors = 0

    def record(self, name: str, ms: float) -> None:
        with self._lock:
            if name not in self._ms:
                self._ms[name] = deque(maxlen=self._keep)
                self._counts[name] = 0
            self._ms[name].append(ms)
            self._counts[name] += 1

    def error(self) -> None:
        with self._lock:
            self.errors += 1

    def last(self, name: str) -> float:
        """The latest duration of ``name``, in ms."""
        with self._lock:
            return self._ms[name][-1]

    def snapshot(self) -> dict[str, dict]:
        """Per span: ``count`` (all recorded), and ``p50``, ``p95`` and
        ``max`` in ms over the kept durations."""
        with self._lock:
            kept = {name: (self._counts[name], np.asarray(ms, np.float64))
                    for name, ms in self._ms.items()}
        return {
            name: {"count": count,
                   "p50": round(float(np.percentile(ms, 50)), 2),
                   "p95": round(float(np.percentile(ms, 95)), 2),
                   "max": round(float(ms.max()), 2)}
            for name, (count, ms) in kept.items()
        }


class _TimedSpan:
    """A span whose duration goes to a ``SpanStats``."""

    __slots__ = ("name", "range", "stats", "t0")

    def __init__(self, name: str, stats: SpanStats):
        self.name, self.stats, self.range = name, stats, None

    def __enter__(self):
        if _autograd_profiler._is_profiler_enabled:
            self.range = torch.profiler.record_function(self.name)
            self.range.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        ms = (time.perf_counter() - self.t0) * 1e3
        if self.range is not None:
            self.range.__exit__(*exc)
        self.stats.record(self.name, ms)  # after the range: a reader of stats finds it whole
        return False


def span(name: str, stats: SpanStats | None = None):
    """A context manager naming the host work inside it (module
    docstring). The flag read is torch's own, set by every profiler for
    all threads; ``record_function`` is entered only while it is set,
    since it costs microseconds even with no profiler running."""
    if stats is not None:
        return _TimedSpan(name, stats)
    if _autograd_profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _NO_SPAN


def trace_events(path: Path | str) -> list[dict]:
    """The complete (``"ph": "X"``) events of a Chrome trace."""
    events = json.loads(Path(path).read_text()).get("traceEvents", [])
    return [e for e in events if e.get("ph") == "X" and "dur" in e]


def device_intervals(events: list[dict], within: tuple[float, float] | None = None,
                     ) -> list[tuple[float, float]]:
    """``(start_us, end_us)`` of each device operation (kernel, copy,
    memset), clipped to ``within`` when given."""
    out = []
    for e in events:
        if e.get("cat") not in DEVICE_CATS:
            continue
        a, b = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        if within is not None:
            a, b = max(a, within[0]), min(b, within[1])
        if b > a:
            out.append((a, b))
    return out


def device_busy_s(intervals: list[tuple[float, float]]) -> float:
    """Seconds covered by the union of ``intervals`` (in µs): time in
    which some operation ran on the device, each instant counted once."""
    busy, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b <= end:
            continue
        busy += b - max(a, end)
        end = b
    return busy / 1e6
