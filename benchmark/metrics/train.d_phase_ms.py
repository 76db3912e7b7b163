"""Rank 0's device time a step inside the program's ``otm.train.d_phase``
ranges: per ``gpu_user_annotation`` range of that name in the traced
period, the union of the device operations' intervals within it; their
sum over the period's steps. None without such ranges."""

from benchmark.train_trace import phase_device_s


def read(run):
    return phase_device_s(run, "otm.train.d_phase")
