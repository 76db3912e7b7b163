"""Median wall time of an engine call (``InferenceEngine.generate_batch``,
which ends in its copy to the host), over the calls of the window."""

import statistics


def read(run):
    calls = run.spans.get("serve.engine")
    return statistics.median(calls) if calls else None
