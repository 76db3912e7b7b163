"""Rank 0's NCCL kernels' device time a step in the traced period (the
gradient all-reduces, the KL term's moments, the buffer's all-gather and
the state comparison's none: it runs after the window), the wait for the
slowest rank included. None without NCCL kernels."""


def read(run):
    tr = run.trace
    if tr is None:
        return None
    ops = [(s, e) for name, s, e in tr.device_ops
           if "nccl" in name.lower() and e > tr.start and s < tr.end]
    if not ops:
        return None
    return sum(min(e, tr.end) - max(s, tr.start) for s, e in ops) / 1e3 / run.steps
