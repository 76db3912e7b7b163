"""A training cell's profiled period: ``trace.Trace`` with the
``gpu_user_annotation`` ranges kept in a list of their own.

``TrainTrace.load`` is ``Trace.load``: the same device operations
(kernels, copies, memsets) and host operations, so whatever reads them
reads what the serving cell's readers read. ``annotations`` takes from
the same trace the device-side extent of each host range the program
opened while the profiler ran (``gpu_user_annotation``: the span's first
kernel's start to its last kernel's end), which the per-phase readers
need. The period is bounded by the benchmark's own host range
``PERIOD`` (opened and closed after a device synchronise), and its busy
time is the mean of the ranks' where they are given (``rank_busy``).
"""

from __future__ import annotations

import json
from pathlib import Path

from benchmark.trace import Trace, union

PERIOD = "bench.train.period"
ANNOTATION_CAT = "gpu_user_annotation"


class TrainTrace(Trace):
    rank_busy: list[float] | None = None

    def bound_to_period(self) -> None:
        """The slice's bounds: the ``PERIOD`` range's, where it is."""
        period = [op for op in self.host_ops if op[0] == PERIOD]
        if period:
            self.start, self.end = period[0][1], period[0][2]

    def own_busy_s(self) -> float:
        """This trace's card's busy seconds in the slice."""
        return Trace.busy_s(self)

    def busy_s(self) -> float:
        """The mean over the ranks' cards of the busy seconds in each one's
        slice (this trace's alone without ``rank_busy``)."""
        if self.rank_busy:
            return sum(self.rank_busy) / len(self.rank_busy)
        return self.own_busy_s()

    def spans(self) -> list[tuple[str, float, float]]:
        """The program's ``otm.train.*`` host ranges in the slice, the
        shortest first (so an idle gap is named by its innermost)."""
        spans = [op for op in self.host_ops if op[0].startswith("otm.train.")
                 and op[2] > self.start and op[1] < self.end]
        return sorted(spans, key=lambda op: op[2] - op[1])


def annotations(path: Path | str) -> list[tuple[str, float, float]]:
    """The trace's ``gpu_user_annotation`` ranges as ``(name, start_us,
    end_us)``, the earliest first."""
    events = json.loads(Path(path).read_text()).get("traceEvents", [])
    ranges = [(e.get("name", "?"), float(e["ts"]), float(e["ts"]) + float(e["dur"]))
              for e in events
              if e.get("ph") == "X" and "dur" in e and e.get("cat") == ANNOTATION_CAT]
    return sorted(ranges, key=lambda a: a[1])


def load(path: Path | str) -> tuple[TrainTrace, list[tuple[str, float, float]]]:
    """-> (the trace as ``Trace.load`` keeps it, its ``annotations``)."""
    return TrainTrace.load(path), annotations(path)


def phase_device_s(run, name: str) -> float | None:
    """Milliseconds a step of rank 0's device time inside the
    ``gpu_user_annotation`` ranges ``name`` of the traced period: per range
    the union of the device operations' intervals clipped to it."""
    tr = run.trace
    if tr is None:
        return None
    ranges = [(s, e) for n, s, e in run.annotations
              if n == name and e > tr.start and s < tr.end]
    if not ranges:
        return None
    total = 0.0
    for a, b in ranges:
        ops = [(max(s, a), min(e, b)) for _, s, e in tr.device_ops if e > a and s < b]
        total += sum(y - x for x, y in union(ops))
    return total / 1e3 / run.steps
