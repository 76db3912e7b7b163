"""Median wait of a request in the batcher: from its ``_Batcher.submit``
entry to the start of its group's ``generate_batch`` (the benchmark's
spans), over the requests that entered the engine in the window."""

import statistics


def read(run):
    waits = run.spans.get("serve.queue")
    return statistics.median(waits) if waits else None
