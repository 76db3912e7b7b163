"""Share of the traced slice (whole engine calls, and the gaps between
them) in which no operation ran on the card: 100 minus the union of the
device operations' intervals over the slice's wall time."""


def read(run):
    if run.trace is None or run.trace.window_s <= 0 or not run.trace.device_ops:
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / run.trace.window_s)
