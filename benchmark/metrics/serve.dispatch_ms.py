"""Median time the engine has no call in flight between two calls: over
the traced ``otm.engine.call`` spans (the program's own, on the
profiler's clock) sorted by start, the next call's start minus this
call's end. None where the trace holds fewer than two such spans."""

import statistics


def read(run):
    if run.trace is None:
        return None
    calls = sorted((s, e) for name, s, e in run.trace.host_ops if name == "otm.engine.call")
    gaps = [(b[0] - a[1]) / 1e3 for a, b in zip(calls, calls[1:])]
    return statistics.median(gaps) if gaps else None
