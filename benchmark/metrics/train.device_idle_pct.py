"""Share of the traced period (a whole R1 and path period of training
steps, bounded by device synchronises) in which no operation ran on rank
0's card: 100 minus the union of its device operations' intervals over
the period's wall time."""


def read(run):
    tr = run.trace
    if tr is None or tr.window_s <= 0 or not tr.device_ops:
        return None
    return 100.0 * (1.0 - tr.own_busy_s() / tr.window_s)
