"""Reduce a ``torch.profiler`` trace to what the per-layer readers read.

The profiler runs over a slice of the window and writes a Chrome trace;
``Trace.load`` keeps its device operations (kernels, copies, memsets)
and its host operations, each as ``(name, start_us, end_us)``. Device
busy time is the union of the device operations' intervals, never a sum
of their times, so overlapping kernels count once.
"""

from __future__ import annotations

import bisect
import json
from collections import defaultdict
from pathlib import Path

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")


def union(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    """Merged, sorted intervals."""
    merged: list[list[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


class Trace:
    """Device and host operations of one profiled slice, in microseconds
    on one clock; ``start``, ``end``: the slice's bounds."""

    def __init__(self, device_ops, host_ops, start: float, end: float):
        self.device_ops = sorted(device_ops, key=lambda e: e[1])
        self.host_ops = sorted(host_ops, key=lambda e: e[1])
        self.start, self.end = start, end

    @classmethod
    def load(cls, path: Path | str):
        """From a Chrome trace; the slice's bounds are its first and last
        device operation until a caller sets them."""
        events = json.loads(Path(path).read_text()).get("traceEvents", [])
        device, host = [], []
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            op = (e.get("name", "?"), float(e["ts"]), float(e["ts"]) + float(e["dur"]))
            if e.get("cat") in DEVICE_CATS:
                device.append(op)
            elif e.get("cat") in HOST_CATS:
                host.append(op)
        start = min((op[1] for op in device), default=0.0)
        end = max((op[2] for op in device), default=0.0)
        return cls(device, host, start, end)

    @property
    def window_s(self) -> float:
        return (self.end - self.start) / 1e6

    def busy_s(self) -> float:
        """Seconds of the slice in which some operation ran on the device."""
        spans = [(max(s, self.start), min(e, self.end)) for _, s, e in self.device_ops]
        return sum(b - a for a, b in union([(s, e) for s, e in spans if e > s])) / 1e6

    def device_time_s(self, match) -> tuple[float, int]:
        """(summed seconds, count) of the device operations whose name
        ``match(name)`` accepts."""
        ops = [(s, e) for name, s, e in self.device_ops if match(name)]
        return sum(e - s for s, e in ops) / 1e6, len(ops)

    def top_device_ops(self, k: int = 10) -> list[list]:
        total: dict[str, float] = defaultdict(float)
        for name, s, e in self.device_ops:
            total[name] += (e - s) / 1e6
        return [[name, t] for name, t in sorted(total.items(), key=lambda x: -x[1])[:k]]

    def idle_gaps(self, k: int = 10, spans=()) -> list[list]:
        """The ``k`` longest gaps between device operations inside the
        slice, each named by what the host was doing at its middle: the
        innermost host operation then, inside which of ``spans`` (name,
        start_us, end_us) it fell."""
        busy = union([(s, e) for _, s, e in self.device_ops])
        edges = [self.start] + [x for ab in busy for x in ab] + [self.end]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges) - 1, 2)
                if edges[i + 1] > edges[i]]
        gaps.sort(key=lambda g: g[0] - g[1])
        starts = [op[1] for op in self.host_ops]
        out = []
        for a, b in gaps[:k]:
            mid = (a + b) / 2
            inner = None
            for name, s, e in self.host_ops[: bisect.bisect_right(starts, mid)]:
                if e >= mid and (inner is None or e - s < inner[1]):
                    inner = (name, e - s)
            where = next((n for n, s, e in spans if s <= mid <= e), "outside the spans")
            host = inner[0] if inner else "no torch op"
            out.append([f"{where}: {host}", (b - a) / 1e6])
        return out
