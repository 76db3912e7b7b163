"""Median time the server takes to send a reply once its images are in
hand (npy or zip encode, headers, the body written to the socket): the
durations of the program's ``otm.http.reply`` spans whole inside the
traced slice. None where the slice holds none."""

import statistics


def read(run):
    if run.trace is None:
        return None
    tr = run.trace
    replies = [(e - s) / 1e3 for name, s, e in tr.host_ops
               if name == "otm.http.reply" and tr.start <= s and e <= tr.end]
    return statistics.median(replies) if replies else None
