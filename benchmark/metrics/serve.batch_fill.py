"""Requests a device call carries, over the window: the batcher's own
counters, ``(batches + coalesced) / batches``."""


def read(run):
    batches = run.counters.get("batches", 0)
    if not batches:
        return None
    return (batches + run.counters.get("coalesced", 0)) / batches
