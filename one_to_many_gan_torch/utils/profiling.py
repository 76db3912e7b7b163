"""Profiling helpers: a ``torch.profiler`` trace of a block, and a step
timer.

- ``trace(log_dir, device)``: records the block's CPU activity, and its
  CUDA activity when ``device`` is a card, and writes a Chrome trace
  (``chrome://tracing``, Perfetto, TensorBoard's profile plugin) under
  ``log_dir``. The device is synchronised before recording starts and
  before it stops, so the trace holds the block's device work whole.
- ``StepTimer``: wall-clock times between ``tick()`` calls, the first
  ``warmup`` intervals left out, with their mean and median. It reads the
  host's clock: on a card, synchronise before each tick.
"""

from __future__ import annotations

import contextlib
import os
import time
from pathlib import Path

import torch

from one_to_many_gan_torch.device import select_device


@contextlib.contextmanager
def trace(log_dir: Path | str, device=None):
    """Trace the block on ``device`` (None: ``cuda``, raising without a
    GPU). Yields the path of the trace file, ``<log_dir>/<time>.<pid>
    .trace.json``, written when the block ends (also when it raises)."""
    from torch.profiler import ProfilerActivity, profile

    device = select_device(device)
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    path = Path(log_dir) / f"{time.strftime('%Y%m%d-%H%M%S')}.{os.getpid()}.trace.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    prof = profile(activities=activities)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    prof.start()
    try:
        yield path
    finally:
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        prof.stop()
        prof.export_chrome_trace(str(path))


class StepTimer:
    """Rolling wall-clock step timing with warmup exclusion."""

    def __init__(self, warmup: int = 3):
        self.warmup = warmup
        self.times: list[float] = []
        self._last: float | None = None
        self._count = 0

    def tick(self) -> None:
        now = time.perf_counter()
        if self._last is not None:
            self._count += 1
            if self._count > self.warmup:
                self.times.append(now - self._last)
        self._last = now

    @property
    def mean(self) -> float:
        return sum(self.times) / len(self.times) if self.times else float("nan")

    @property
    def p50(self) -> float:
        if not self.times:
            return float("nan")
        s = sorted(self.times)
        return s[len(s) // 2]
