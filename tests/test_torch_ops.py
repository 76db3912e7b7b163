"""The PyTorch port's ops against the JAX package's, forward, on the CPU.

Inputs are numpy draws fed to both sides; JAX parameters are initialised
with flax and copied into the port's layers (HWIO -> OIHW, [in,out] ->
[out,in]). Tolerances are the JAX package's own: ops 1e-5
(tests/test_ops.py), instance norm 2e-5 in float32 and 0.05 in bfloat16
(tests/test_pallas_kernels.py).

The instance-norm kernel is CUDA C++ and cannot run here; its wrapper
takes the plain version for CPU tensors, which is what these tests hold
to ``ops/norm.py::instance_norm`` and to the Pallas kernel in interpret
mode. The kernel itself is held to the plain version on the card by
``chip_smoke.py`` and by ``tests/test_torch_cuda.py``.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from one_to_many_gan_torch.ops import cuda as port_cuda
from one_to_many_gan_torch.ops import equalized as port_eq
from one_to_many_gan_torch.ops import modulated as port_mod
from one_to_many_gan_torch.ops import norm as port_norm
from one_to_many_gan_torch.ops import resample as port_rs
from one_to_many_gan_torch.ops.cuda import build as port_build
from one_to_many_gan_torch.ops.cuda import instance_norm as port_in
from one_to_many_gan_tpu.ops import equalized as jax_eq
from one_to_many_gan_tpu.ops import modulated as jax_mod
from one_to_many_gan_tpu.ops import norm as jax_norm
from one_to_many_gan_tpu.ops import resample as jax_rs
from one_to_many_gan_tpu.ops.pallas import (
    instance_norm_pallas,
    instance_norm_relu_pallas,
)

OPS_TOL = 1e-5
IN_TOL_F32 = 2e-5
IN_TOL_BF16 = 0.05


def _nchw(x_nhwc: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.transpose(x_nhwc, (0, 3, 1, 2))))


def _nhwc(x_nchw: torch.Tensor) -> np.ndarray:
    return np.transpose(x_nchw.float().numpy(), (0, 2, 3, 1))


def _f32(a) -> np.ndarray:
    return np.asarray(a, dtype=np.float32)


def _set(param: torch.nn.Parameter, value) -> None:
    with torch.no_grad():
        param.copy_(torch.from_numpy(np.array(value, dtype=np.float32)))


def _copy_linear(layer, p) -> None:
    _set(layer.weight, _f32(p["weight"]).T)
    _set(layer.bias, p["bias"])


def _copy_conv(layer, p) -> None:
    _set(layer.weight, _f32(p["weight"]).transpose(3, 2, 0, 1))
    if "bias" in p:
        _set(layer.bias, p["bias"])


@pytest.fixture
def rng():
    return np.random.default_rng(0)


# ------------------------------------------------------------ instance norm


@pytest.mark.parametrize("shape", [(2, 8, 8, 4), (1, 16, 8, 8), (3, 8, 8, 6)])
def test_instance_norm_matches_jax_f32(shape, rng):
    x = (rng.standard_normal(shape) * 2 + 0.5).astype(np.float32)
    got = port_norm.instance_norm(_nchw(x))
    want = jax_norm.instance_norm(jnp.asarray(x))
    np.testing.assert_allclose(_nhwc(got), _f32(want), atol=IN_TOL_F32)


def test_instance_norm_matches_jax_bf16(rng):
    x = (rng.standard_normal((2, 8, 8, 4)) * 2 + 0.5).astype(np.float32)
    xb = jnp.asarray(x, dtype=jnp.bfloat16)
    got = port_norm.instance_norm(_nchw(_f32(xb)).to(torch.bfloat16))
    want = jax_norm.instance_norm(xb)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_nhwc(got), _f32(want), atol=IN_TOL_BF16)


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("shape", [(2, 8, 8, 4), (1, 16, 8, 8)])
def test_fused_instance_norm_cpu_matches_pallas_f32(shape, relu, rng):
    x = (rng.standard_normal(shape) * 2 + 0.5).astype(np.float32)
    pallas = instance_norm_relu_pallas if relu else instance_norm_pallas
    want = pallas(jnp.asarray(x), interpret=True)
    got = port_cuda.fused_instance_norm(_nchw(x), relu=relu)
    np.testing.assert_allclose(_nhwc(got), _f32(want), atol=IN_TOL_F32)


@pytest.mark.parametrize("relu", [False, True])
def test_fused_instance_norm_cpu_matches_pallas_bf16(relu, rng):
    x = jnp.asarray(rng.standard_normal((2, 8, 8, 4)).astype(np.float32), jnp.bfloat16)
    pallas = instance_norm_relu_pallas if relu else instance_norm_pallas
    want = pallas(x, interpret=True)
    got = port_cuda.fused_instance_norm(_nchw(_f32(x)).to(torch.bfloat16), relu=relu)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_nhwc(got), _f32(want), atol=IN_TOL_BF16)


def test_wrapper_takes_plain_version_on_cpu_without_building(monkeypatch, rng):
    """A CPU tensor goes to the plain version: no build, no launch count."""

    def no_build(name):
        raise AssertionError(f"build.load({name!r}) called for a CPU tensor")

    monkeypatch.setattr(port_build, "load", no_build)
    before = port_in.fused_instance_norm.launches
    x = _nchw(rng.standard_normal((2, 8, 8, 4)).astype(np.float32))
    got = port_in.fused_instance_norm(x, relu=True)
    torch.testing.assert_close(got, port_in.instance_norm_plain(x, relu=True))
    assert port_in.fused_instance_norm.launches == before == 0


def test_wrapper_never_falls_back_off_cpu():
    """A tensor that is not on the CPU never reaches the plain version."""
    x = torch.empty((1, 2, 4, 4), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        port_in.fused_instance_norm(x)


def test_importing_the_kernel_module_builds_nothing():
    assert port_build._loaded == {}
    assert "fused_instance_norm" in port_cuda.__all__


def test_library_path_tracks_source_and_flags():
    path = port_build.library_path("instance_norm")
    assert path.parent == port_build.BUILD_DIR
    assert path.name.startswith("libinstance_norm-") and path.suffix == ".so"
    assert "arch=compute_90a,code=sm_90a" in port_build.NVCC_FLAGS


def _fake_nvcc(tmp_path, monkeypatch, body: str) -> None:
    """Point the build at a stand-in ``nvcc`` (a Python script) and at a
    build directory under ``tmp_path``."""
    script = tmp_path / "nvcc"
    script.write_text(f"#!{sys.executable}\nimport sys\nargs = sys.argv[1:]\n{body}")
    script.chmod(0o755)
    monkeypatch.setattr(port_build, "_nvcc", lambda: str(script))
    monkeypatch.setattr(port_build, "BUILD_DIR", tmp_path / "kernels")


def test_build_compiles_once_and_reports_the_log(tmp_path, monkeypatch):
    _fake_nvcc(tmp_path, monkeypatch, (
        "open(args[args.index('-o') + 1], 'wb').write(b'lib')\n"
        "print('ptxas info    : Used 32 registers')\n"
    ))
    first = port_build.build("instance_norm")
    assert port_build.library_path("instance_norm").read_bytes() == b"lib"
    assert "Used 32 registers" in first["log"] and first["seconds"] > 0
    assert port_build.build("instance_norm") == {"seconds": 0.0, "log": ""}


def test_build_failure_raises_with_nvcc_output(tmp_path, monkeypatch):
    _fake_nvcc(tmp_path, monkeypatch, "print('error: bad source', file=sys.stderr)\nsys.exit(2)\n")
    with pytest.raises(RuntimeError, match="nvcc failed for instance_norm.cu:\nerror: bad source"):
        port_build.build("instance_norm")
    assert list((tmp_path / "kernels").iterdir()) == []


# ------------------------------------------------------------- equalized


@pytest.mark.parametrize("bias_init", [0.0, 1.0])
def test_equalized_linear_matches_jax(bias_init, rng):
    x = rng.standard_normal((3, 6)).astype(np.float32)
    mod = jax_eq.EqualizedLinear(5, bias_init=bias_init)
    params = mod.init(jax.random.key(1), jnp.asarray(x))["params"]
    params = {"weight": params["weight"], "bias": params["bias"] + 0.3}
    want = mod.apply({"params": params}, jnp.asarray(x))
    layer = port_eq.EqualizedLinear(6, 5, bias_init=bias_init)
    _copy_linear(layer, params)
    got = layer(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), _f32(want), rtol=OPS_TOL, atol=OPS_TOL)


@pytest.mark.parametrize(
    ("ksize", "pad", "pad_mode", "use_bias", "cout"),
    [
        (3, 1, "zero", True, 5),
        (3, 1, "zero", False, 5),
        (3, 1, "reflect", True, 5),
        (3, 1, "reflect", False, 5),
        (7, 3, "reflect", True, 1),  # the output conv (JAX: space-to-depth form)
    ],
)
def test_equalized_conv_matches_jax(ksize, pad, pad_mode, use_bias, cout, rng):
    x = rng.standard_normal((2, 16, 16, 4)).astype(np.float32)
    mod = jax_eq.EqualizedConv(
        cout, ksize, padding=pad, pad_mode=pad_mode, use_bias=use_bias
    )
    params = mod.init(jax.random.key(2), jnp.asarray(x))["params"]
    if use_bias:
        params = {**params, "bias": params["bias"] + 0.25}
    want = mod.apply({"params": params}, jnp.asarray(x))
    layer = port_eq.EqualizedConv(
        4, cout, ksize, padding=pad, pad_mode=pad_mode, use_bias=use_bias
    )
    _copy_conv(layer, params)
    got = layer(_nchw(x))
    np.testing.assert_allclose(_nhwc(got.detach()), _f32(want), rtol=OPS_TOL, atol=OPS_TOL)


# -------------------------------------------------------------- resample


@pytest.mark.parametrize("hw", [(8, 8), (16, 6), (7, 9), (9, 7)])
@pytest.mark.parametrize("op", ["blur3", "upsample2x", "downsample2x"])
def test_resample_ops_match_jax(op, hw, rng):
    x = rng.standard_normal((2, *hw, 3)).astype(np.float32)
    want = getattr(jax_rs, op)(jnp.asarray(x))
    got = getattr(port_rs, op)(_nchw(x))
    assert tuple(_nhwc(got).shape) == want.shape
    np.testing.assert_allclose(_nhwc(got), _f32(want), rtol=OPS_TOL, atol=OPS_TOL)


@pytest.mark.parametrize("out_hw", [(16, 12), (3, 4), (7, 13)])
def test_bilinear_resize_matches_jax(out_hw, rng):
    x = rng.standard_normal((2, 8, 6, 3)).astype(np.float32)
    want = jax_rs.bilinear_resize(jnp.asarray(x), *out_hw)
    got = port_rs.bilinear_resize(_nchw(x), *out_hw)
    np.testing.assert_allclose(_nhwc(got), _f32(want), rtol=OPS_TOL, atol=OPS_TOL)


def test_l2_normalize_matches_jax(rng):
    x = rng.standard_normal((4, 6)).astype(np.float32)
    x[1] = 0.0  # the clamped norm
    want = jax_norm.l2_normalize(jnp.asarray(x), axis=1)
    got = port_norm.l2_normalize(torch.from_numpy(x), dim=1)
    np.testing.assert_allclose(got.numpy(), _f32(want), rtol=OPS_TOL, atol=OPS_TOL)


# -------------------------------------------------------------- modulated


@pytest.mark.parametrize("pad_mode", ["zero", "reflect"])
def test_modulated_conv_matches_jax(pad_mode, rng):
    x = rng.standard_normal((3, 8, 8, 4)).astype(np.float32)
    w_style = rng.standard_normal((3, 6)).astype(np.float32)
    mod = jax_mod.ModulatedConv(5, 3, padding=1, pad_mode=pad_mode)
    params = mod.init(jax.random.key(3), jnp.asarray(x), jnp.asarray(w_style))["params"]
    want = mod.apply({"params": params}, jnp.asarray(x), jnp.asarray(w_style))
    layer = port_mod.ModulatedConv(4, 5, 6, 3, padding=1, pad_mode=pad_mode)
    _copy_conv(layer, {"weight": params["weight"]})
    _copy_linear(layer.to_style, params["to_style"])
    got = layer(_nchw(x), torch.from_numpy(w_style))
    np.testing.assert_allclose(_nhwc(got.detach()), _f32(want), rtol=OPS_TOL, atol=OPS_TOL)


def test_modulated_conv_bf16_matches_jax(rng):
    """bf16 activations, f32 demodulation: the same rounding points as the
    JAX op (He constant rounded to bf16 before the weight scale), so the
    two agree to bf16 resolution of the output's scale."""
    x = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    w_style = rng.standard_normal((2, 6)).astype(np.float32)
    mod = jax_mod.ModulatedConv(5, 3, padding=1, pad_mode="reflect", dtype=jnp.bfloat16)
    params = mod.init(jax.random.key(4), jnp.asarray(x), jnp.asarray(w_style))["params"]
    want = _f32(mod.apply({"params": params}, jnp.asarray(x), jnp.asarray(w_style)))
    layer = port_mod.ModulatedConv(4, 5, 6, 3, padding=1, pad_mode="reflect",
                                   dtype=torch.bfloat16)
    _copy_conv(layer, {"weight": params["weight"]})
    _copy_linear(layer.to_style, params["to_style"])
    got = layer(_nchw(x), torch.from_numpy(w_style))
    assert got.dtype == torch.bfloat16
    # 2^-7: bf16's relative resolution, on outputs of unit scale
    np.testing.assert_allclose(_nhwc(got.detach()), want, atol=2**-7 * np.abs(want).max())
