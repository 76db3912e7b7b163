"""Median host work inside an engine call with nothing of the call on the
card: over the traced ``otm.engine.call`` spans, the summed durations of
the ``otm.engine.prepare`` and ``otm.engine.gather`` spans inside each
(inputs packed and normalised; parts joined and sliced per request).
None where the trace holds no call with either."""

import statistics

PARTS = ("otm.engine.prepare", "otm.engine.gather")


def read(run):
    if run.trace is None:
        return None
    ops = run.trace.host_ops
    parts = [(s, e) for name, s, e in ops if name in PARTS]
    per_call = []
    for name, start, end in ops:
        if name != "otm.engine.call":
            continue
        inside = [(e - s) / 1e3 for s, e in parts if start <= s and e <= end]
        if inside:
            per_call.append(sum(inside))
    return statistics.median(per_call) if per_call else None
