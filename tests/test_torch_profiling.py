"""The port's ``utils/profiling.py::trace``: a Chrome trace of its block
(``torch.profiler`` in place of the JAX package's ``jax.profiler``).
The spans and the busy time are ``tests/test_torch_tracing.py``'s."""

import json

import pytest
import torch

from one_to_many_gan_torch.utils import profiling as port_profiling


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
