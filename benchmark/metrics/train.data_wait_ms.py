"""Mean of the program's ``otm.train.data_wait`` spans (a group's batches
taken from the Trainer's producer thread) that begin in the traced
period, on rank 0. None without such spans."""

import statistics


def read(run):
    tr = run.trace
    if tr is None:
        return None
    waits = [(e - s) / 1e3 for name, s, e in tr.host_ops
             if name == "otm.train.data_wait" and tr.start <= s < tr.end]
    return statistics.fmean(waits) if waits else None
