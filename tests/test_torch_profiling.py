"""The port's ``utils/profiling.py`` against the JAX package's.

``trace`` writes a Chrome trace of its block (``torch.profiler`` in place
of ``jax.profiler``); ``StepTimer`` gives the JAX timer's intervals, mean
and median on the same clock readings, and behaves as JAX's
``tests/test_profiling.py`` holds its own.
"""

import json

import numpy as np
import pytest
import torch

from one_to_many_gan_torch.utils import profiling as port_profiling
from one_to_many_gan_tpu.utils import profiling as jax_profiling


def test_trace_writes_a_chrome_trace(tmp_path):
    with port_profiling.trace(tmp_path / "traces", device="cpu") as path:
        float((torch.ones(64, 64) * 2).sum())
    assert path.parent == tmp_path / "traces" and path.name.endswith(".trace.json")
    events = json.loads(path.read_text())["traceEvents"]
    assert any(e.get("name") == "aten::mul" for e in events)


def test_trace_writes_its_file_when_the_block_raises(tmp_path):
    with pytest.raises(ValueError, match="inside"), \
            port_profiling.trace(tmp_path, device="cpu") as path:
        raise ValueError("inside")
    assert path.exists()


def test_trace_defaults_to_cuda_and_raises_without_it(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"), \
            port_profiling.trace(tmp_path):
        pass


def test_step_timer_excludes_warmup():
    t = port_profiling.StepTimer(warmup=2)
    for _ in range(6):
        t.tick()
    # 5 intervals, first 2 are warmup
    assert len(t.times) == 3
    assert np.isfinite(t.mean) and np.isfinite(t.p50)
    assert t.p50 == sorted(t.times)[1]


def test_step_timer_empty_is_nan():
    t = port_profiling.StepTimer()
    assert np.isnan(t.mean) and np.isnan(t.p50)


@pytest.mark.parametrize("warmup", [0, 1, 3])
def test_step_timer_equals_jax_on_the_same_clock(monkeypatch, warmup):
    readings = [0.0, 0.5, 0.75, 2.0, 2.125, 3.0, 3.0625]
    timers = []
    for module in (port_profiling, jax_profiling):
        clock = iter(readings)
        monkeypatch.setattr(module.time, "perf_counter", lambda clock=clock: next(clock))
        timer = module.StepTimer(warmup=warmup)
        for _ in readings:
            timer.tick()
        timers.append(timer)
        monkeypatch.undo()
    port, jax = timers
    assert port.times == jax.times and len(port.times) == len(readings) - 1 - warmup
    assert port.mean == jax.mean and port.p50 == jax.p50
