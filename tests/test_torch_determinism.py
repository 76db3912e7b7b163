"""Deterministic training in the port, on the CPU.

- The deterministic pads (``ops/pad.py``): the forward is ``F.pad``
  bitwise; the backward matches ``jax.vjp`` of ``jnp.pad`` (``edge`` and
  ``reflect``, the JAX package's pads) on the same numpy inputs, float32 at
  1e-6 and bfloat16 at 1e-2 of the sum of the magnitudes of each pixel's
  terms (a border pixel sums up to 16 terms; each side rounds its partial
  sums to bfloat16, 2^-9 of the partial sum a rounding, in its own order);
  the resampling and the reflect-padded convs run through them.
- ``training.deterministic_cuda_kernels = true``: ``Models`` sets the
  process-wide switches of ``device.use_deterministic_kernels`` (a fixture
  puts them back, since one worker runs many test files), the key false
  changes nothing, the training CLI sets cuBLAS's workspace, and two runs
  of two fused steps from one seed are bitwise equal.

The card's side (the gather, cuDNN, cuBLAS) is ``chip_smoke.py``'s phase 13
and ``tests/test_torch_cuda.py``.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import chip_smoke
from one_to_many_gan_torch import train
from one_to_many_gan_torch.core.state import Models
from one_to_many_gan_torch.core.train_step import make_train_step
from one_to_many_gan_torch.device import CUBLAS_WORKSPACE_CONFIG
from one_to_many_gan_torch.ops import equalized, resample
from one_to_many_gan_torch.ops.pad import pad
from one_to_many_gan_torch.presets import tiny_config

JAX_MODES = {"replicate": "edge", "reflect": "reflect"}
PADS = [(1, 1, 1, 1), (3, 3, 3, 3), (0, 0, 1, 1), (1, 1, 0, 0), (2, 1, 3, 0)]
SHAPES = [(2, 3, 7, 5), (1, 2, 9, 11)]
TOL = {torch.float32: 1e-6, torch.bfloat16: 1e-2}


def _jax_pad_vjp(x: np.ndarray, g: np.ndarray, p: tuple, mode: str, dtype) -> np.ndarray:
    left, right, top, bottom = p
    widths = ((0, 0), (0, 0), (top, bottom), (left, right))
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    _, vjp = jax.vjp(lambda t: jnp.pad(t, widths, mode=JAX_MODES[mode]), jnp.asarray(x, jdt))
    return np.asarray(vjp(jnp.asarray(g, jdt))[0].astype(jnp.float32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("p", PADS)
@pytest.mark.parametrize("mode", list(JAX_MODES))
def test_pad_matches_f_pad_forward_and_jax_backward(mode, p, shape, dtype):
    rng = np.random.default_rng(sum(p) + shape[-1])
    x_np = rng.standard_normal(shape).astype(np.float32)
    x = torch.from_numpy(x_np).to(dtype).requires_grad_(True)
    y = pad(x, p, mode)
    assert torch.equal(y, F.pad(x, p, mode=mode))
    g_np = rng.standard_normal(tuple(y.shape)).astype(np.float32)
    (gx,) = torch.autograd.grad(y, x, torch.from_numpy(g_np).to(dtype))
    assert gx.dtype == dtype and gx.shape == x.shape
    want = _jax_pad_vjp(torch.from_numpy(x_np).to(dtype).float().numpy(),
                        torch.from_numpy(g_np).to(dtype).float().numpy(), p, mode, dtype)
    if dtype == torch.float32:
        np.testing.assert_allclose(gx.numpy(), want, rtol=0, atol=TOL[dtype])
        return
    x64 = torch.zeros(shape, dtype=torch.float64, requires_grad=True)
    g_abs = torch.from_numpy(g_np).to(dtype).double().abs()
    (mag,) = torch.autograd.grad(F.pad(x64, p, mode=mode), x64, g_abs)  # sum of |terms|
    assert (np.abs(gx.float().numpy() - want) <= TOL[dtype] * mag.numpy()).all()


def test_pad_refuses_other_modes():
    with pytest.raises(ValueError, match="replicate or reflect"):
        pad(torch.zeros((1, 1, 4, 4)), (1, 1, 1, 1), "circular")


def test_resampling_and_reflect_convs_pad_through_the_deterministic_fold():
    """The edge pads of the resampling glue and the reflection pads of the
    stems, the out conv and the ResnetBlocks are ``ops/pad.py``'s; the
    zero pads stay ``F.pad``'s (a slice in backward)."""
    x = torch.randn((1, 2, 8, 8), requires_grad=True)
    for t in (resample._edge_pad(x, 2), resample._edge_pad(x, 3),
              equalized.pad2d(x, 3, "reflect")):
        assert type(t.grad_fn).__name__ == "_PadBackward"
    assert type(equalized.pad2d(x, 1, "zero").grad_fn).__name__ != "_PadBackward"


@pytest.fixture
def process_flags(monkeypatch):
    """Put the process-wide determinism switches and the cuBLAS variable
    back after the test."""
    cudnn = torch.backends.cudnn
    saved = (torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled(),
             cudnn.deterministic, cudnn.benchmark)
    monkeypatch.delenv("CUBLAS_WORKSPACE_CONFIG", raising=False)
    yield
    torch.use_deterministic_algorithms(saved[0], warn_only=saved[1])
    cudnn.deterministic, cudnn.benchmark = saved[2], saved[3]


def _config(deterministic: bool):
    return tiny_config((32, 32), 2, min_latent=16, n_resnet_blocks=1,
                       training={"deterministic_cuda_kernels": deterministic},
                       tpu={"path_interval": 2, "ada_pallas": True})


def test_models_set_the_deterministic_switches_under_the_key(process_flags):
    import os

    torch.use_deterministic_algorithms(False)
    torch.backends.cudnn.deterministic = False
    torch.backends.cudnn.benchmark = True
    Models(_config(False), device="cpu")
    assert not torch.are_deterministic_algorithms_enabled()
    assert torch.backends.cudnn.benchmark and not torch.backends.cudnn.deterministic
    assert "CUBLAS_WORKSPACE_CONFIG" not in os.environ
    Models(_config(True), device="cpu")
    assert torch.are_deterministic_algorithms_enabled()
    assert not torch.is_deterministic_algorithms_warn_only_enabled()
    assert torch.backends.cudnn.deterministic and not torch.backends.cudnn.benchmark
    assert os.environ["CUBLAS_WORKSPACE_CONFIG"] == CUBLAS_WORKSPACE_CONFIG == ":4096:8"


def test_train_cli_sets_the_cublas_workspace_under_the_key(process_flags, tmp_path, capsys):
    import os

    text = (chip_smoke.ROOT / "configs" / "cpu_smoke.toml").read_text()
    assert "deterministic_cuda_kernels = false" in text
    text = text.replace("deterministic_cuda_kernels = false", "deterministic_cuda_kernels = true")
    text = text.replace("image_size = [64, 64]", "image_size = [32, 32]")
    text = text.replace("min_latent_resolution = 64", "min_latent_resolution = 16")
    text = text.replace("n_resnet_blocks = 7", "n_resnet_blocks = 1")
    cfg = tmp_path / "config.toml"
    cfg.write_text(text)
    train.main([str(cfg), "--device", "cpu", "--synthetic-steps", "1", "--ada-p", "0.6"])
    line = json.loads(capsys.readouterr().out.splitlines()[0])
    assert line["path_step"] and line["path_loss"] > 0
    assert os.environ["CUBLAS_WORKSPACE_CONFIG"] == CUBLAS_WORKSPACE_CONFIG
    assert torch.are_deterministic_algorithms_enabled()


def _two_steps(config) -> tuple[dict, list]:
    models, state, gen = train.setup(config, seed=0, ada_p=0.6, device="cpu")
    step = make_train_step(config, models)
    metrics = []
    for _ in range(2):
        state, m = train.run_step(config, models, state, step, gen)
        metrics.append({k: v.detach().clone() for k, v in m.items()})
    return chip_smoke._train_state_tensors(state), metrics


def test_two_fused_step_runs_under_the_key_are_bitwise_equal(process_flags):
    """Two runs of a path step and an other step from seed 0, under
    ``torch.use_deterministic_algorithms(True)``: every parameter, Adam
    moment, ADA and buffer tensor and every metric equal bitwise (and no
    op on the path raises in deterministic mode)."""
    config = _config(True)
    (state_a, metrics_a), (state_b, metrics_b) = _two_steps(config), _two_steps(config)
    assert torch.are_deterministic_algorithms_enabled()
    assert state_a.keys() == state_b.keys() and len(state_a) > 100
    assert [k for k in state_a if not torch.equal(state_a[k], state_b[k])] == []
    assert metrics_a[0]["path_loss"] > 0 and metrics_a[1]["path_loss"] == 0
    for ma, mb in zip(metrics_a, metrics_b, strict=True):
        assert ma.keys() == mb.keys()
        assert all(torch.equal(ma[k], mb[k]) for k in ma)
    assert state_a["buffer.count"].item() == 4
