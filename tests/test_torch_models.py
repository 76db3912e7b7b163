"""The PyTorch port's models and its 1->N slice against the JAX package.

A tiny config (32x32, min_latent 8, 3 resnet blocks: 2 resampling
levels, 64 -> 128 -> 256 channels, 1 encoder and 2 decoder blocks, 4
style blocks) is initialised with flax, carried into the port through
``convert.from_jax_params`` and run on the CPU with the same inputs and
the same style draws on both sides.

Tolerances, float32: 1e-4 abs. The ops agree to 1e-5 (test_torch_ops);
through the 13 convolutions of a generator pass, XLA's and oneDNN's
different summation orders grow that to about 1e-5 on features of unit
scale (measured on the CPU: max 1.2e-5 on the latent, whose values reach
4.9; 4.8e-6 on the tanh output), and 1e-4 keeps a factor of 8 over it.
"""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from one_to_many_gan_torch import convert as port_convert
from one_to_many_gan_torch import device as port_device
from one_to_many_gan_torch import export as port_export
from one_to_many_gan_torch.core import Models as PortModels
from one_to_many_gan_torch.core import make_inference_fns as port_inference_fns
from one_to_many_gan_torch.core.inference import decode_batch_limit, decode_in_chunks
from one_to_many_gan_torch.config import load_config as port_load_config
from one_to_many_gan_torch.models import StyleRngs as PortStyleRngs
from one_to_many_gan_torch.models import generator_arithmetic as port_arithmetic
from one_to_many_gan_torch.presets import tiny_config as port_tiny_config
from one_to_many_gan_tpu.core.state import Models as JaxModels
from one_to_many_gan_tpu.core.train_step import make_inference_fns as jax_inference_fns
from one_to_many_gan_tpu.export import _flatten as jax_flatten
from one_to_many_gan_tpu.models import StyleRngs as JaxStyleRngs
from one_to_many_gan_tpu.models import generator_arithmetic as jax_arithmetic
from one_to_many_gan_tpu.models import sample_style_rngs
from one_to_many_gan_tpu.presets import tiny_config as jax_tiny_config

SIZE = 32
TOL_F32 = 1e-4
REPO = Path(__file__).resolve().parents[1]


def _configs(precision="float32"):
    kw = {"min_latent": 8, "n_resnet_blocks": 3, "tpu": {"precision": precision}}
    return jax_tiny_config((SIZE, SIZE), 2, **kw), port_tiny_config((SIZE, SIZE), 2, **kw)


def _numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _build(precision, params=None):
    """(jax config, jax Models, params_g, params_m, port Models); ``params``
    reuses (params_g, params_m) of another build (same f32 trees)."""
    jcfg, pcfg = _configs(precision)
    jm = JaxModels(jcfg)
    if params is None:
        params = (
            jm.generator.init(
                jax.random.key(0),
                jnp.zeros((1, SIZE, SIZE, 1)),
                jnp.zeros((jm.n_style_blocks, 1, jm.w_dim)),
            ),
            jm.mapping.init(jax.random.key(1), jnp.zeros((1, jm.w_dim))),
        )
    params_g, params_m = params
    pm = PortModels(pcfg, device="cpu", seed=3)
    port_convert.from_jax_params(pm, _numpy_tree(params_g), _numpy_tree(params_m))
    return jcfg, jm, params_g, params_m, pm


@pytest.fixture(scope="module")
def f32():
    return _build("float32")


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(np.asarray(x), (0, 3, 1, 2))))


def _nhwc(t):
    return np.transpose(t.float().numpy(), (0, 2, 3, 1))


def _images(b, seed=0):
    rng = np.random.default_rng(seed)
    return rng.uniform(-1, 1, (b, SIZE, SIZE, 1)).astype(np.float32)


def _styles(jm, b, seed=1):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((jm.n_style_blocks, b, jm.w_dim)).astype(np.float32) * 0.5


# ------------------------------------------------------------------ models


@pytest.mark.parametrize(
    ("image_size", "min_latent", "n_blocks"),
    [((512, 256), 64, 7), ((256, 256), 64, 7), ((32, 32), 8, 3), ((100, 60), 16, 5)],
)
def test_generator_arithmetic_matches_jax(image_size, min_latent, n_blocks):
    assert port_arithmetic(image_size, min_latent, n_blocks) == jax_arithmetic(
        image_size, min_latent, n_blocks
    )


def test_encode_matches_jax(f32):
    _, jm, params_g, _, pm = f32
    x = _images(2)
    want = jm.generator.apply(params_g, jnp.asarray(x), method="encode")
    with torch.no_grad():
        got = pm.generator.encode(_nchw(x))
    assert got.shape == (2, 256, 8, 8)
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), atol=TOL_F32)


def test_decode_matches_jax(f32):
    _, jm, params_g, _, pm = f32
    latent = np.random.default_rng(2).standard_normal((2, 8, 8, 256)).astype(np.float32)
    w = _styles(jm, 2)
    want = jm.generator.apply(params_g, jnp.asarray(latent), jnp.asarray(w), method="decode")
    with torch.no_grad():
        got = pm.generator.decode(_nchw(latent), torch.from_numpy(w))
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), atol=TOL_F32)


def test_extract_taps_match_jax(f32):
    """All four taps, including the post-/pre-ReLU placement of the
    upsample-stage taps."""
    _, jm, params_g, _, pm = f32
    latent = np.random.default_rng(4).standard_normal((2, 8, 8, 256)).astype(np.float32)
    w = _styles(jm, 2, seed=5)
    want = jm.generator.apply(params_g, jnp.asarray(latent), jnp.asarray(w), method="extract")
    with torch.no_grad():
        got = pm.generator.extract(_nchw(latent), torch.from_numpy(w))
    assert len(got) == len(want) == jm.n_style_blocks
    for g, wt in zip(got, want):
        np.testing.assert_allclose(_nhwc(g), np.asarray(wt), atol=TOL_F32)
    assert (np.asarray(want[-2]) >= 0).all() and (np.asarray(want[-1]) < 0).any()


@pytest.mark.parametrize(("mix", "crossover"), [(False, 0), (True, 0), (True, 2), (True, 4)])
def test_style_vector_matches_jax(f32, mix, crossover):
    _, jm, _, params_m, pm = f32
    rng = np.random.default_rng(6)
    z1, z2 = (rng.standard_normal((3, jm.w_dim)).astype(np.float32) for _ in range(2))
    n = jm.n_style_blocks
    jr = JaxStyleRngs(jnp.asarray(z1), jnp.asarray(z2), jnp.asarray(mix), jnp.asarray(crossover))
    pr = PortStyleRngs(
        torch.from_numpy(z1), torch.from_numpy(z2), torch.tensor(mix), torch.tensor(crossover)
    )
    for mix_styles in (False, True):
        want = jm.mapping.apply(params_m, jr, n, mix_styles=mix_styles, method="style_vector")
        with torch.no_grad():
            got = pm.mapping.style_vector(pr, n, mix_styles=mix_styles)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("limit", [1, 2, 3, 5])
def test_decode_in_chunks_equals_one_decode(f32, limit):
    """Chunking the decode over the batch computes the same function
    (to float32 ulps: oneDNN may block each batch size differently)."""
    *_, pm = f32
    latent = torch.from_numpy(
        np.random.default_rng(12).standard_normal((5, 256, 8, 8)).astype(np.float32)
    )
    w = torch.from_numpy(_styles(pm, 5, seed=13))
    with torch.no_grad():
        want = pm.generator.decode(latent, w)
        got = decode_in_chunks(pm.generator, latent, w, limit)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)


def test_decode_batch_limit_keeps_the_shipped_config_in_32_bit_indexing():
    """At 512x256 the last upsample holds 128 x 512 x 256 values per image:
    123 images stay below 2**31, as the output conv's padded input does."""
    pm = PortModels(port_load_config(REPO / "configs" / "default.toml"), device="cpu")
    limit = decode_batch_limit(pm)
    assert limit == 123
    assert limit * 128 * 518 * 262 < 2**31 <= (limit + 1) * 128 * 518 * 262


# ----------------------------------------------------------- the 1->N slice


def _jax_draws(jcfg, jm, seeds, n):
    keys = jax.vmap(jax.random.key)(jnp.asarray(seeds, jnp.uint32))
    p = jcfg["training"]["style_mixing_prob"]
    z = jax.vmap(lambda k: sample_style_rngs(k, n, jm.w_dim, jm.n_style_blocks, p))(keys).z1
    return keys, np.array(z)


def _many_to_many_pair(built, n=3):
    jcfg, jm, params_g, params_m, pm = built
    images, thetas = _images(2, seed=7), np.asarray([1.0, 0.5], np.float32)
    keys, z = _jax_draws(jcfg, jm, [11, 12], n)
    _, _, jax_m2m = jax_inference_fns(jcfg, jm)
    want = jax_m2m(params_g, params_m, jnp.asarray(images), keys, n, jnp.asarray(thetas))
    _, _, port_m2m = port_inference_fns(pm)
    got = port_m2m(torch.from_numpy(images), torch.from_numpy(z), torch.from_numpy(thetas))
    assert got.shape == want.shape == (2, n, SIZE, SIZE, 1)
    return got.float().numpy(), np.asarray(want, np.float32)


def test_many_to_many_matches_jax_f32(f32):
    got, want = _many_to_many_pair(f32)
    np.testing.assert_allclose(got, want, atol=TOL_F32)
    assert not np.allclose(want[0, 0], want[0, 1])  # styles differ


def test_many_to_many_matches_jax_bf16(f32):
    """bf16 activations on both sides, same weights. The packages round at
    the same points, but each conv's bf16 output rounds a differently
    ordered f32 sum, so one-ulp flips (2^-8 relative) start at the first
    conv and travel through the generator; measured on the CPU: max 0.0142,
    mean 0.0021 on the tanh output. 0.05 is the JAX package's own bf16
    tolerance (tests/test_pallas_kernels.py) and keeps a factor of 3."""
    got, want = _many_to_many_pair(_build("bfloat16", params=f32[2:4]))
    np.testing.assert_allclose(got, want, atol=0.05)


def test_one_to_many_and_translate_match_jax(f32):
    jcfg, jm, params_g, params_m, pm = f32
    port_translate, port_o2m, _ = port_inference_fns(pm)
    jax_translate, jax_o2m, _ = jax_inference_fns(jcfg, jm)
    image = _images(1, seed=8)[0]
    key = jax.random.key(5)
    p = jcfg["training"]["style_mixing_prob"]
    z = np.asarray(sample_style_rngs(key, 4, jm.w_dim, jm.n_style_blocks, p).z1)
    want = jax_o2m(params_g, params_m, jnp.asarray(image), key, 4, 0.7)
    got = port_o2m(torch.from_numpy(image), torch.from_numpy(z), 0.7)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL_F32)

    images = _images(2, seed=9)
    rngs = sample_style_rngs(key, 2, jm.w_dim, jm.n_style_blocks, p)
    want = jax_translate(params_g, params_m, jnp.asarray(images), key, domain=0.5, mix=True)
    port_rngs = PortStyleRngs(*(torch.from_numpy(np.asarray(t)) for t in rngs))
    got = port_translate(torch.from_numpy(images), port_rngs, domain=0.5, mix=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL_F32)


# ----------------------------------------------------------------- weights


def test_jax_artifact_loads_and_serves_the_same(f32, tmp_path):
    """An .npz in the layout ``one_to_many_gan_tpu.export`` writes loads in
    the port and gives the same output as the directly converted models."""
    jcfg, jm, params_g, params_m, pm = f32
    flat = {}
    jax_flatten(_numpy_tree(params_g), "g", flat)
    jax_flatten(_numpy_tree(params_m), "m", flat)
    flat["__step__"] = np.int64(7)
    flat["__ema__"] = np.bool_(True)
    path = tmp_path / "model.npz"
    np.savez_compressed(path, **flat)

    g, m, step, ema = port_export.load_inference_artifact(path)
    assert (step, ema) == (7, True)
    fresh = PortModels(_configs()[1], device="cpu", seed=99)
    port_convert.from_jax_params(fresh, g, m)
    x, z = _images(1, seed=10), np.random.default_rng(11).standard_normal((1, 2, jm.w_dim))
    args = (torch.from_numpy(x), torch.from_numpy(z.astype(np.float32)), torch.ones(1))
    got = port_inference_fns(fresh)[2](*args)
    torch.testing.assert_close(got, port_inference_fns(pm)[2](*args), rtol=0, atol=0)


def _tree(params):
    return jax.tree.map(lambda a: np.array(a), _numpy_tree(params))


@pytest.mark.parametrize("fault", ["wrong_shape", "missing_leaf", "extra_leaf"])
def test_from_jax_params_rejects_a_mismatched_tree(f32, fault):
    _, _, params_g, params_m, _ = f32
    g = _tree(params_g)
    if fault == "wrong_shape":
        g["params"]["enc_stem"]["weight"] = np.zeros((5, 5, 1, 64), np.float32)
        match = "enc_stem/weight"
    elif fault == "missing_leaf":
        del g["params"]["dec_up_1"]["to_style"]["bias"]
        match = "missing .*dec_up_1/to_style/bias"
    else:
        g["params"]["enc_blocks_0"]["EqualizedConv_0"]["bias"] = np.zeros(256, np.float32)
        match = "unexpected .*enc_blocks_0/EqualizedConv_0/bias"
    fresh = PortModels(_configs()[1], device="cpu")
    with pytest.raises(ValueError, match=match):
        port_convert.from_jax_params(fresh, g, _tree(params_m))


def test_models_default_to_cuda_and_raise_without_it():
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PortModels(_configs()[1])


def _tf32_flags():
    return torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32


@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
def test_models_on_the_cpu_leave_tf32_alone(precision, monkeypatch):
    """Only a float32 config on CUDA turns TF32 off; the CPU never does."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    PortModels(_configs(precision)[1], device="cpu")
    assert _tf32_flags() == (True, True)


def test_disable_tf32_turns_both_flags_off(monkeypatch):
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    port_device.disable_tf32()
    assert _tf32_flags() == (False, False)


# --------------------------------------------------------------- isolation


def _port_modules():
    root = REPO / "one_to_many_gan_torch"
    for path in sorted(root.rglob("*.py")):
        parts = path.relative_to(REPO).with_suffix("").parts
        yield ".".join(parts[:-1] if parts[-1] == "__init__" else parts)


def test_port_imports_no_jax():
    """Every module of the port imports in a fresh interpreter without
    pulling in JAX, flax or the JAX package."""
    mods = list(_port_modules())
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k in ('jax', 'flax', 'jaxlib') "
        "or k.startswith(('jax.', 'flax.', 'jaxlib.', 'one_to_many_gan_tpu')))\n"
        "assert not bad, bad\n"
        "print(len(sys.modules))\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stderr
    assert len(mods) >= 20


def test_port_sources_never_name_the_jax_package():
    """Source guard: no later change may re-couple the port to the
    reference. Scans the port's Python and CUDA sources, chip_smoke.py and
    the port's training-dynamics script."""
    needles = ("import jax", "from jax", "flax", "one_to_many_gan_tpu")
    files = [
        *sorted((REPO / "one_to_many_gan_torch").rglob("*.py")),
        *sorted((REPO / "one_to_many_gan_torch").rglob("*.cu")),
        REPO / "chip_smoke.py",
        REPO / "scripts" / "train_dynamics_torch.py",
    ]
    hits = [
        f"{path.relative_to(REPO)}:{i}: {line.strip()}"
        for path in files
        for i, line in enumerate(path.read_text().splitlines(), 1)
        if any(needle in line for needle in needles)
    ]
    assert not hits, "\n".join(hits)
