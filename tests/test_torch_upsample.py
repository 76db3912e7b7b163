"""The 2x upsample's ``autograd.Function`` and its plain version, on the CPU.

``ops/resample.py::upsample2x`` of a whole map runs ``_Upsample2x``: on
the card one launch of ``csrc/upsample.cu`` (``ops/cuda/upsample.py``),
on the CPU the plain version ``upsample2x_plain`` (``_double_blur`` along
H, then W). Held here: its forward bitwise that expression, its backward
against autograd of the expression and ``gradcheck`` in float64, both
against the polyphase 3x3 formula written out in numpy float64, the CPU
path launching nothing, and the spatial axis keeping its band path. No
JAX: the JAX package's upsample is held to the port by
``tests/test_torch_ops.py::test_resample_ops_match_jax``. The kernel is
held to the plain version on the card by ``tests/test_torch_cuda.py`` and
``chip_smoke.py``.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from one_to_many_gan_torch.ops import resample
from one_to_many_gan_torch.ops.cuda import build
from one_to_many_gan_torch.ops.cuda import upsample as upsample_kernel
from one_to_many_gan_torch.parallel import halo

SHAPES = [(8, 8), (7, 9), (1, 5)]
# Output parity p of input row i reads rows i - 1, i, i + 1 with these taps.
TAPS = {0: (5 / 16, 10 / 16, 1 / 16), 1: (1 / 16, 10 / 16, 5 / 16)}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this file's tiny convs (as
    tests/test_torch_production.py): ``gradcheck`` runs hundreds of them,
    which many threads only slow down on a busy host; restored afterwards."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _expression(x: torch.Tensor) -> torch.Tensor:
    """What ``upsample2x`` computed before it became one Function."""
    return resample._double_blur(resample._double_blur(x, 2), 3)


def _polyphase(x: np.ndarray) -> np.ndarray:
    """``y[2i + p, 2j + q] = sum_{a, b} tH_p[a] tW_q[b] x[clamp(i + a), clamp(j + b)]``
    of every plane of an [..., H, W] array, in float64, term by term."""
    h, w = x.shape[-2:]
    y = np.zeros((*x.shape[:-2], 2 * h, 2 * w))
    for i in range(h):
        for j in range(w):
            for p in (0, 1):
                for q in (0, 1):
                    for a in (-1, 0, 1):
                        for b in (-1, 0, 1):
                            r, c = min(max(i + a, 0), h - 1), min(max(j + b, 0), w - 1)
                            y[..., 2 * i + p, 2 * j + q] += (
                                TAPS[p][a + 1] * TAPS[q][b + 1] * x[..., r, c])
    return y


def _input(hw, dtype=torch.float64, seed=0, planes=(2, 3)) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal((*planes, *hw))).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float64])
@pytest.mark.parametrize("hw", SHAPES)
def test_upsample_forward_is_the_expression_bitwise(hw, dtype):
    x = _input(hw, dtype)
    got = resample._Upsample2x.apply(x)
    assert got.dtype == dtype and got.shape == (2, 3, 2 * hw[0], 2 * hw[1])
    assert torch.equal(got, _expression(x))
    assert torch.equal(resample.upsample2x(x), got)
    assert torch.equal(resample.upsample2x_plain(x), got)


@pytest.mark.parametrize("hw", SHAPES)
def test_upsample_backward_is_the_adjoint(hw):
    x = _input(hw, planes=(1, 2)).requires_grad_(True)  # gradcheck's cost grows as its square
    assert torch.autograd.gradcheck(resample._Upsample2x.apply, (x,))
    assert torch.autograd.gradgradcheck(resample._Upsample2x.apply, (x,))
    g = _input((2 * hw[0], 2 * hw[1]), seed=1, planes=(1, 2))
    (got,) = torch.autograd.grad(resample.upsample2x(x), x, g)
    (want,) = torch.autograd.grad(_expression(x), x, g)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-14)


@pytest.mark.parametrize("hw", SHAPES)
def test_upsample_is_the_polyphase_formula(hw):
    x = _input(hw)
    np.testing.assert_allclose(resample.upsample2x(x).numpy(), _polyphase(x.numpy()),
                               rtol=0, atol=1e-14)
    # the backward is the formula's transpose: <up(x), g> = <x, up^T(g)>
    xr = x.clone().requires_grad_(True)
    g = _input((2 * hw[0], 2 * hw[1]), seed=2)
    (gx,) = torch.autograd.grad(resample.upsample2x(xr), xr, g)
    np.testing.assert_allclose((gx * x).sum().item(),
                               (_polyphase(x.numpy()) * g.numpy()).sum(), rtol=1e-12)


def test_upsample_on_the_cpu_takes_the_plain_version_and_launches_nothing():
    x = _input((8, 8), torch.float32)
    before = upsample_kernel.upsample2x.launches
    assert torch.equal(resample.upsample2x(x), resample.upsample2x_plain(x))
    assert upsample_kernel.upsample2x.launches == before


def test_upsample_kernel_wrapper_refuses_a_cpu_tensor():
    with pytest.raises(ValueError, match="CUDA tensor"):
        upsample_kernel.upsample2x(_input((8, 8), torch.float32))


def test_upsample_under_a_spatial_group_keeps_its_band_path(monkeypatch):
    """A spatial group of one rank holds the whole map: the band path gives
    the plain version's values, and ``_Upsample2x`` is not called."""
    calls = {"band": 0}
    band = resample._double_blur_band

    def counted(*args):
        calls["band"] += 1
        return band(*args)

    def refuse(*args):
        raise AssertionError("_Upsample2x ran under a spatial group")

    monkeypatch.setattr(resample, "_double_blur_band", counted)
    monkeypatch.setattr(resample._Upsample2x, "apply", refuse)
    x = _input((7, 9), torch.float32)
    with halo.banded(halo.Spatial(1, 0, [0])):
        got = resample.upsample2x(x, 7)
    assert calls["band"] == 1
    assert torch.equal(got, _expression(x))


def test_upsample_kernel_is_built_and_noted():
    assert "upsample" in build.KERNELS
    source = Path(build.CSRC / "upsample.cu").read_text()
    note = source.split("#include")[0]
    for words in ("Replaces", "_double_blur", "conv_transpose2d", "_edge_pad",
                  "_double_blur_axis", "What bounds it: bytes", "Design"):
        assert words in note, words
    assert build.library_path("upsample").name.startswith("libupsample-")


def test_upsample_bound_bytes_at_the_serving_sites():
    """One read of the input and one write of the 4x output: 62.9 MB an
    image over the decoder's two sites in bfloat16."""
    site1 = upsample_kernel.bound_bytes((1, 256, 128, 64), 2)
    site2 = upsample_kernel.bound_bytes((1, 128, 256, 128), 2)
    assert (site1, site2) == (20_971_520, 41_943_040)
    assert site1 + site2 == 62_914_560
