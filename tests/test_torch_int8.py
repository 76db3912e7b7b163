"""The port's int8 serving path on the CPU, against the JAX package's.

At the tiny test config (``tests/helpers.write_tiny_config``: 32x32,
min_latent 16, 3 resnet blocks: a decoder of 2 modulated resnet blocks at
128 channels and one upsample conv 128 -> 64, 5 int8 convs), the JAX
parameters of the f32 tree are carried into the port, and both packages
run the same inputs. On the CPU the port's ``int8_conv`` and each int8
site of the decoder (``ops/cuda/int8_conv.py::modulated_int8_conv``) take
the kernels' plain versions; the kernels themselves (an amax pre-pass
and the fused modulated conv) are held to those plain versions bitwise
on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase 18).
Here the fused plain version is held bitwise to the steps it fuses.

Tolerances. Codes, scales and the int8 conv of the same float inputs are
bitwise JAX's: the same divisions, roundings and exact integer sums. The
modulated conv and the int8 decode start from floats that the two
packages round alike only up to their float32 matmuls' summation order,
so a value within an ulp of a rounding tie can take the neighbouring code:
the tests count such flipped codes at every int8 site and hold the
outputs to 1e-4 (the f32 model tests' tolerance) where no code flipped,
and to one code's step of the site's output scale otherwise.
"""

import contextlib
import io
import json
import threading
import urllib.request
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from one_to_many_gan_torch import generate as port_generate
from one_to_many_gan_torch import serve as port_serve
from one_to_many_gan_torch.config import load_config as port_load_config
from one_to_many_gan_torch.convert import _load as port_load_layers
from one_to_many_gan_torch.convert import from_jax_params
from one_to_many_gan_torch.core import Models as PortModels
from one_to_many_gan_torch.core import train_step as port_ts
from one_to_many_gan_torch.ops import int8_conv as port_int8_conv
from one_to_many_gan_torch.ops import modulated as port_modulated
from one_to_many_gan_torch.ops import quantize_activations as port_qa
from one_to_many_gan_torch.ops import quantize_weight as port_qw
from one_to_many_gan_torch.ops.cuda import int8_conv as port_fused
from one_to_many_gan_torch.ops.equalized import pad2d as port_pad2d
from one_to_many_gan_torch.ops.modulated import ModulatedConv as PortModulatedConv
from one_to_many_gan_tpu.config import load_config as jax_load_config
from one_to_many_gan_tpu.core.state import Models as JaxModels
from one_to_many_gan_tpu.ops import int8_conv as jax_int8_conv
from one_to_many_gan_tpu.ops import modulated as jax_modulated
from one_to_many_gan_tpu.ops import quantize_activations as jax_qa
from one_to_many_gan_tpu.ops import quantize_weight as jax_qw
from one_to_many_gan_tpu.ops.equalized import _pad2d as jax_pad2d
from one_to_many_gan_tpu.ops.modulated import ModulatedConv as JaxModulatedConv
from tests.helpers import write_tiny_config

SIZE = 32
TOL_F32 = 1e-4
N_INT8_SITES = 5  # 2 modulated resnet blocks x 2 convs + 1 upsample conv


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread (the suite runs several test workers on one
    host); restored afterwards."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return np.ascontiguousarray(t.float().numpy().transpose(0, 2, 3, 1))


def _nchw(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def _oihw(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(3, 2, 0, 1)))


def _jax_f32(a) -> np.ndarray:
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """The tiny config, the JAX int8 Models and the JAX f32 tree, and the
    port's f32 and int8 Models on the CPU with those weights."""
    path = write_tiny_config(tmp_path_factory.mktemp("int8"))
    jcfg = jax_load_config(path)
    jm = JaxModels(jcfg, int8_decode=True)
    params_g = jax.jit(jm.generator.init)(
        jax.random.key(0), jnp.zeros((1, SIZE, SIZE, 1)),
        jnp.zeros((jm.n_style_blocks, 1, jm.w_dim)),
    )
    params_m = jm.mapping.init(jax.random.key(1), jnp.zeros((1, jm.w_dim)))
    numpy_g, numpy_m = jax.tree.map(np.asarray, params_g), jax.tree.map(np.asarray, params_m)
    pcfg = port_load_config(path)
    ports = {}
    for int8 in (False, True):
        ports[int8] = PortModels(pcfg, device="cpu", seed=3, int8_decode=int8)
        from_jax_params(ports[int8], numpy_g, numpy_m)
    return {"path": path, "config": pcfg, "jm": jm, "params_g": params_g,
            "f32": ports[False], "int8": ports[True]}


# ------------------------------------------------------------ (a) codes


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_activation_codes_and_scales_are_jax_bitwise(dtype):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 9, 11, 64)).astype(np.float32) * np.float32([[[[1.0]]], [[[40.0]]],
                                                                          [[[1e-3]]]])
    x[2] = 0.0  # an all-zero sample: amax floors at 1e-12
    jx = jnp.asarray(x).astype(dtype)
    px = _nchw(_jax_f32(jx)).to(getattr(torch, dtype))
    jq, js = jax_qa(jx)
    pq, ps = port_qa(px)
    assert pq.dtype == torch.int8 and ps.dtype == torch.float32
    np.testing.assert_array_equal(_nhwc(pq).astype(np.int8), np.asarray(jq))
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
    assert np.abs(np.asarray(jq)).max() == 127


def test_weight_codes_and_scales_are_jax_bitwise():
    rng = np.random.default_rng(1)
    w = rng.normal(size=(3, 3, 64, 40)).astype(np.float32) * 0.05
    w[..., 7] = 0.0  # an all-zero output channel
    jq, js = jax_qw(jnp.asarray(w))
    pq, ps = port_qw(_oihw(w))
    np.testing.assert_array_equal(pq.numpy().transpose(2, 3, 1, 0), np.asarray(jq))
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js))


# ------------------------------------------------------ (b) the int8 conv


def test_int8_conv_exact_on_integer_grids():
    """JAX's construction (tests/test_int8.py): integer values with amax 127
    quantise with zero error, so the int8 conv equals the float conv."""
    rng = np.random.default_rng(0)
    x = rng.integers(-127, 128, size=(3, 10, 10, 32)).astype(np.float32)
    x[:, 0, 0, 0] = 127.0
    w = rng.integers(-127, 128, size=(3, 3, 32, 16)).astype(np.float32)
    w[0, 0, 0, :] = 127.0
    got = port_int8_conv(_nchw(x), _oihw(w))
    want = torch.nn.functional.conv2d(_nchw(x).double(), _oihw(w).double()).float()
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    np.testing.assert_array_equal(_nhwc(got), np.asarray(jax_int8_conv(x, w)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pad_mode", ["zero", "reflect"])
def test_int8_conv_is_jax_bitwise_on_padded_inputs(pad_mode, dtype):
    rng = np.random.default_rng(2)
    x = jnp.asarray(rng.normal(size=(2, 12, 9, 64)).astype(np.float32)).astype(dtype)
    w = rng.normal(size=(3, 3, 64, 24)).astype(np.float32) * 0.1
    jxp = jax_pad2d(x, 1, pad_mode)
    pxp = port_pad2d(_nchw(_jax_f32(x)).to(getattr(torch, dtype)), 1, pad_mode)
    np.testing.assert_array_equal(_nhwc(pxp), _jax_f32(jxp))
    got = port_int8_conv(pxp, _oihw(w))
    np.testing.assert_array_equal(_nhwc(got), np.asarray(jax_int8_conv(jxp, jnp.asarray(w))))


def test_int8_conv_error_bound_and_rms():
    """JAX's bound: each of the K = kh*kw*I products errs by at most
    dx*|w| + dw*|x| + dx*dw (dx, dw half the scales); relative RMS < 2 %."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 32, 12, 12)).astype(np.float32)
    w = rng.normal(size=(32, 32, 3, 3)).astype(np.float32) * 0.1
    got = port_int8_conv(torch.from_numpy(x), torch.from_numpy(w)).double()
    ref = torch.nn.functional.conv2d(torch.from_numpy(x).double(), torch.from_numpy(w).double())
    xs = port_qa(torch.from_numpy(x))[1].max().item()
    ws = port_qw(torch.from_numpy(w))[1].max().item()
    k = 3 * 3 * 32
    bound = k * (xs / 2 * np.abs(w).max() + ws / 2 * np.abs(x).max() + xs * ws / 4)
    assert (got - ref).abs().max().item() <= bound
    rms = ((got - ref).square().mean().sqrt() / ref.square().mean().sqrt()).item()
    assert rms < 0.02


# -------------------------------------- (c) the fused conv's plain version


def _composed(x, s, w_q, w_scale, d, padding, pad_mode, dtype):
    """The steps the fused conv fuses, one torch op each: modulate, pad,
    quantise, the int8 conv, rescale, cast, demodulate."""
    v = x.to(dtype) if s is None else x.to(dtype) * s[:, :, None, None].to(dtype)
    codes, x_scale = port_qa(port_pad2d(v, padding, pad_mode))
    y = port_fused.int8_conv_plain(codes.permute(0, 2, 3, 1), w_q.permute(0, 2, 3, 1), x_scale,
                                   w_scale).to(dtype)
    return y if d is None else y * d[:, :, None, None].to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pad_mode", ["zero", "reflect"])
@pytest.mark.parametrize(("b", "c", "h", "w", "o"), [(2, 32, 5, 7, 8), (1, 64, 9, 4, 70),
                                                     (3, 32, 3, 11, 3)])
def test_fused_plain_is_the_composed_steps_bitwise(b, c, h, w, o, pad_mode, dtype):
    rng = np.random.default_rng(b * 100 + h)
    x = torch.from_numpy(rng.normal(size=(b, c, h, w)).astype(np.float32) * 3).to(dtype)
    s = torch.from_numpy(rng.normal(size=(b, c)).astype(np.float32))
    d = torch.from_numpy(rng.uniform(0.5, 2.0, size=(b, o)).astype(np.float32))
    w_q, w_scale = port_qw(torch.from_numpy(rng.normal(size=(o, c, 3, 3)).astype(np.float32)))
    want = _composed(x, s, w_q, w_scale, d, 1, pad_mode, dtype)
    got = port_fused.modulated_int8_conv(x, s, w_q, w_scale, d, padding=1, pad_mode=pad_mode,
                                         dtype=dtype)
    assert got.dtype == dtype and got.shape == (b, o, h, w)
    assert torch.equal(got, want)
    assert torch.equal(got, port_fused.modulated_int8_conv_plain(
        x, s, w_q, w_scale, d, padding=1, pad_mode=pad_mode, dtype=dtype))
    # no modulation, no padding, no demodulation, float32 out: int8_conv
    flat = port_fused.modulated_int8_conv(x, None, w_q, w_scale, None, padding=0,
                                          pad_mode="zero", dtype=torch.float32)
    assert torch.equal(flat, _composed(x, None, w_q, w_scale, None, 0, "zero", torch.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pad_mode", ["zero", "reflect"])
def test_prepass_scale_is_jax_scale_of_the_padded_tensor(pad_mode, dtype):
    """The pre-pass reads the unpadded modulated input: its scale is JAX's
    of the padded one, bitwise (neither pad changes the largest |v|). The
    shapes are test_int8_conv_is_jax_bitwise_on_padded_inputs', so JAX
    compiles nothing new."""
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.normal(size=(2, 64, 12, 9)).astype(np.float32))
    s = torch.from_numpy(rng.normal(size=(2, 64)).astype(np.float32) * 4)
    pdt = getattr(torch, dtype)
    v = port_fused.modulate_plain(x, s, pdt)
    jxp = jax_pad2d(jnp.asarray(_nhwc(v)).astype(dtype), 1, pad_mode)
    got = port_fused.int8_prepass(x, s, pdt)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_qa(jxp)[1]))
    assert torch.equal(got, port_fused.int8_prepass_plain(x, s, pdt))


# ------------------------------------ (d) the modulated conv and the decode


@contextlib.contextmanager
def _taps(monkeypatch):
    """Record the padded float input of every int8 conv, in call order, on
    both sides: ``{"jax": [...], "port": [...]}`` as NHWC float32 arrays.
    The port's int8 sites take the unpadded input and the style
    (``modulated_int8_conv``): the tap forms the modulated, padded tensor
    that the fused conv quantises."""
    seen = {"jax": [], "port": []}

    def jax_tap(x, w, stride=1):
        seen["jax"].append(_jax_f32(x))
        return jax_int8_conv(x, w, stride)

    def port_tap(x, s, w_q, w_scale, d, *, padding, pad_mode, dtype):
        vp = port_pad2d(port_fused.modulate_plain(x, s, dtype), padding, pad_mode)
        seen["port"].append(_nhwc(vp))
        return port_fused.modulated_int8_conv(x, s, w_q, w_scale, d, padding=padding,
                                              pad_mode=pad_mode, dtype=dtype)

    monkeypatch.setattr(jax_modulated, "int8_conv", jax_tap)
    monkeypatch.setattr(port_modulated, "modulated_int8_conv", port_tap)
    yield seen


def _flipped_codes(seen) -> list[int]:
    """Per int8 site, the codes in which the port's input and JAX's differ."""
    assert len(seen["jax"]) == len(seen["port"])
    return [int((np.asarray(jax_qa(jnp.asarray(j))[0]) != _nhwc(port_qa(_nchw(p))[0])).sum())
            for j, p in zip(seen["jax"], seen["port"], strict=True)]


def _assert_close_given_flips(got, want, flips, step):
    """Within 1e-4 where no code flipped; else within ``step`` (one code's
    step of the output scale) at the few values a flip moves."""
    err = np.abs(got - want)
    if sum(flips) == 0:
        assert err.max() <= TOL_F32, err.max()
    else:
        assert (err > TOL_F32).mean() < 1e-2 and err.max() <= step, (flips, err.max())


@pytest.mark.parametrize("pad_mode", ["zero", "reflect"])
def test_modulated_conv_int8_matches_jax(monkeypatch, pad_mode):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 10, 12, 64)).astype(np.float32)
    w_style = rng.normal(size=(2, 6)).astype(np.float32)
    jconv = JaxModulatedConv(32, pad_mode=pad_mode, int8=True)
    variables = jconv.init(jax.random.key(4), jnp.asarray(x), jnp.asarray(w_style))
    pconv = PortModulatedConv(64, 32, 6, pad_mode=pad_mode, int8=True)
    port_load_layers([("conv", pconv)], {"params": {"conv": variables["params"]}}, "conv")
    with _taps(monkeypatch) as seen:
        want = np.asarray(jconv.apply(variables, jnp.asarray(x), jnp.asarray(w_style)))
        with torch.no_grad():
            got = _nhwc(pconv(_nchw(x), torch.from_numpy(w_style)))
    flips = _flipped_codes(seen)
    assert len(flips) == 1 and got.shape == want.shape == (2, 10, 12, 32)
    _assert_close_given_flips(got, want, flips, step=np.abs(want).max() / 64)


def test_int8_decode_matches_jax(tiny, monkeypatch):
    jm, params_g, pm = tiny["jm"], tiny["params_g"], tiny["int8"]
    rng = np.random.default_rng(5)
    latent = rng.standard_normal((2, 16, 16, 128)).astype(np.float32)
    w = rng.standard_normal((jm.n_style_blocks, 2, jm.w_dim)).astype(np.float32) * 0.5
    with _taps(monkeypatch) as seen:
        want = np.asarray(jm.generator.apply(params_g, jnp.asarray(latent), jnp.asarray(w),
                                             method="decode"))
        with torch.no_grad():
            got = _nhwc(pm.generator.decode(_nchw(latent), torch.from_numpy(w)))
    flips = _flipped_codes(seen)
    assert len(flips) == N_INT8_SITES, flips
    # the decode ends in tanh: one flipped code moves an output by well under 2/64
    _assert_close_given_flips(got, want, flips, step=2 / 64)


# ------------------------------------------- (e) one parameter tree, fidelity


def test_int8_generator_shares_the_f32_state_dict_and_decodes_close(tiny):
    f32, q = tiny["f32"].generator, tiny["int8"].generator
    shapes = {k: tuple(v.shape) for k, v in f32.state_dict().items()}
    assert {k: tuple(v.shape) for k, v in q.state_dict().items()} == shapes
    q.load_state_dict(f32.state_dict())  # the same weights load unchanged
    n_int8 = sum(m.int8 for m in q.modules() if isinstance(m, PortModulatedConv))
    assert n_int8 == N_INT8_SITES
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.normal(size=(4, 1, SIZE, SIZE)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(f32.n_style_blocks, 4, 6)).astype(np.float32))
    with torch.no_grad():
        y_f32, y_q = f32(x, w).double(), q(x, w).double()
    assert torch.isfinite(y_q).all()
    psnr = 10 * np.log10(4.0 / max((y_q - y_f32).square().mean().item(), 1e-12))
    assert psnr > 30.0, psnr


# ---------------------------------------------------- (f) training refuses


@pytest.mark.parametrize("factory", ["make_train_step", "make_d_phase", "make_g_phase"])
def test_training_refuses_int8_models(tiny, factory):
    with pytest.raises(ValueError, match="int8"):
        getattr(port_ts, factory)(tiny["config"], tiny["int8"])


# ------------------------------------------------------------- (g) serving


def _engine(config, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # no checkpoint: fresh weights
        return port_serve.InferenceEngine(config, buckets=(4, 8), device="cpu", **kw)


def test_int8_engine_serves_near_f32_and_says_so(tiny):
    config = tiny["config"]
    f32, q = _engine(config), _engine(config, int8=True)
    assert q.int8 and not f32.int8 and q.models.int8_decode
    src = np.zeros((SIZE, SIZE, 1), np.uint8)
    src[8:24, 8:24] = 255
    out_f32, out_q = f32.generate(src, 4, seed=3), q.generate(src, 4, seed=3)
    assert out_q.shape == out_f32.shape == (4, SIZE, SIZE, 1) and out_q.dtype == np.uint8
    # JAX's bound (tests/test_int8.py): a few uint8 levels at most on average
    assert np.abs(out_q.astype(int) - out_f32.astype(int)).mean() < 4.0
    httpd = port_serve.make_server(q, host="127.0.0.1", port=0, max_batch=1)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        url = f"http://127.0.0.1:{httpd.server_address[1]}/healthz"
        with urllib.request.urlopen(url, timeout=30) as resp:
            health = json.loads(resp.read())
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)
    assert health["int8"] is True and health["data_parallel"] == 1


def test_two_replica_int8_engine_matches_one(tiny):
    """Each replica quantises its own rows; the scales are per sample, so
    its codes are one engine's: the images within the f32 data-parallel
    engine test's 1e-6 (tests/test_torch_parallel.py)."""
    config = tiny["config"]
    one, two = _engine(config, int8=True), _engine(config, int8=True, data_parallel=2)
    rng = np.random.default_rng(0)
    images = torch.from_numpy(rng.uniform(-1, 1, (2, SIZE, SIZE, 1)).astype(np.float32))
    z = torch.from_numpy(rng.standard_normal((2, 8, 6)).astype(np.float32))
    thetas = torch.tensor([1.0, 0.4])
    want = one._fns[0](images, z, thetas)
    got = torch.cat([fn(images, z, thetas, rows=slice(8 * i, 8 * i + 8))
                     for i, fn in enumerate(two._fns)])
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-6)


def test_serve_and_generate_clis_take_int8(tiny, tmp_path, monkeypatch):
    served = {}

    class _Server:
        def serve_forever(self):
            served["forever"] = True

    def fake_make_server(engine, *args, **kwargs):
        served["engine"] = engine
        return _Server()

    monkeypatch.setattr(port_serve, "make_server", fake_make_server)
    with warnings.catch_warnings(), contextlib.redirect_stdout(io.StringIO()) as out:
        warnings.simplefilter("ignore")
        port_serve.main([str(tiny["path"]), "--device", "cpu", "--buckets", "2", "--int8",
                         "--max-batch", "1"])
    assert served["forever"] and served["engine"].int8
    assert "int8 decode" in out.getvalue()

    src = tmp_path / "print.png"
    Image.fromarray(np.random.default_rng(0).integers(0, 256, (SIZE, SIZE), np.uint8)).save(src)
    with contextlib.redirect_stdout(io.StringIO()):
        port_generate.main([str(tiny["path"]), "--source", str(src), "--n", "3", "--out",
                            str(tmp_path / "gen"), "--device", "cpu", "--int8"])
    files = sorted((tmp_path / "gen").glob("shoemark_*.png"))
    assert [f.name for f in files] == [f"shoemark_{i:04d}.png" for i in range(3)]
