"""The PyTorch port's serving layer on the CPU, against the JAX package.

A tiny model (32x32, min_latent 8, 3 resnet blocks) is initialised with
flax, written as the JAX package's deployment artifact (the
``one_to_many_gan_tpu.export`` layout) and served by the port with
``device="cpu"`` through the real HTTP stack on an ephemeral port. What
the server returns is held to the JAX generator run on the same weights
and the same style draws (the torch draws of the request's seed).
"""

import io
import json
import threading
import urllib.error
import urllib.request
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from one_to_many_gan_torch import generate as port_generate
from one_to_many_gan_torch import serve as port_serve
from one_to_many_gan_torch.presets import tiny_config as port_tiny_config
from one_to_many_gan_tpu.core.state import Models as JaxModels
from one_to_many_gan_tpu.export import _flatten as jax_flatten
from one_to_many_gan_tpu.models import StyleRngs, apply_domain
from one_to_many_gan_tpu.presets import tiny_config as jax_tiny_config

SIZE = 32
BUCKETS = (4, 8)
KW = {"min_latent": 8, "n_resnet_blocks": 3}


def _write_artifact(path, params_g, params_m, step=5):
    flat = {}
    jax_flatten(jax.tree.map(np.asarray, params_g), "g", flat)
    jax_flatten(jax.tree.map(np.asarray, params_m), "m", flat)
    flat["__step__"] = np.int64(step)
    flat["__ema__"] = np.bool_(False)
    np.savez_compressed(path, **flat)
    return path


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_serve")
    jcfg = jax_tiny_config((SIZE, SIZE), 2, root=str(root), **KW)
    jm = JaxModels(jcfg)
    params_g = jm.generator.init(
        jax.random.key(0),
        jnp.zeros((1, SIZE, SIZE, 1)),
        jnp.zeros((jm.n_style_blocks, 1, jm.w_dim)),
    )
    params_m = jm.mapping.init(jax.random.key(1), jnp.zeros((1, jm.w_dim)))
    artifact = _write_artifact(root / "model.npz", params_g, params_m)
    config = port_tiny_config((SIZE, SIZE), 2, root=str(root), **KW)
    engine = port_serve.InferenceEngine(
        config, buckets=BUCKETS, artifact=artifact, device="cpu"
    )
    httpd = port_serve.make_server(engine, host="127.0.0.1", port=0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    yield {
        "engine": engine, "base": base, "config": config, "artifact": artifact,
        "jm": jm, "params_g": params_g, "params_m": params_m, "root": root,
    }
    httpd.shutdown()
    httpd.server_close()
    httpd.batcher.close()
    thread.join(timeout=30)


def _source(seed=0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (SIZE, SIZE, 1), dtype=np.uint8)


def _png(image_u8: np.ndarray) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(image_u8[..., 0]).save(buf, format="PNG")
    return buf.getvalue()


def _post(base, query, body):
    req = urllib.request.Request(f"{base}/generate?{query}", data=body)
    with urllib.request.urlopen(req, timeout=60) as resp:
        return resp.read(), resp.headers.get("Content-Type")


def _get(base, path):
    with urllib.request.urlopen(f"{base}{path}", timeout=30) as resp:
        return json.loads(resp.read())


def _assert_within_one_level(got, want):
    """uint8 images at most one level apart: a float difference of a few
    ulps next to a level boundary truncates to neighbouring levels."""
    assert got.shape == want.shape
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def _jax_served(setup, src_u8, n_bucket, seed, theta):
    """The JAX generator on the draws the port's engine makes for ``seed``:
    [n_bucket, H, W, 1] uint8, converted as the servers convert."""
    jm, params_g, params_m = setup["jm"], setup["params_g"], setup["params_m"]
    z = torch.randn(
        (n_bucket, jm.w_dim), generator=torch.Generator("cpu").manual_seed(seed)
    ).numpy()
    image = jnp.asarray(src_u8[None].astype(np.float32) / 127.5 - 1.0)
    latent = jm.generator.apply(params_g, image, method="encode")
    latent_n = jnp.broadcast_to(latent, (n_bucket, *latent.shape[1:]))
    rngs = StyleRngs(jnp.asarray(z), jnp.asarray(z), jnp.asarray(False), jnp.asarray(0))
    s = jm.mapping.apply(params_m, rngs, jm.n_style_blocks, mix_styles=False,
                         method="style_vector")
    out = jm.generator.apply(params_g, latent_n, apply_domain(s, theta), method="decode")
    return np.clip((np.asarray(out) + 1.0) * 127.5, 0, 255).astype(np.uint8)


def test_healthz_reports_engine_facts(setup):
    payload = _get(setup["base"], "/healthz")
    assert payload["status"] == "ok"
    assert payload["step"] == 5 and payload["ema"] is False
    assert payload["buckets"] == list(BUCKETS)
    assert payload["image_size"] == [SIZE, SIZE]
    assert payload["device"] == "cpu" and payload["precision"] == "float32"


def test_generate_zip_roundtrip(setup):
    body, ctype = _post(setup["base"], "n=3&seed=1", _png(_source()))
    assert ctype == "application/zip"
    with zipfile.ZipFile(io.BytesIO(body)) as zf:
        names = zf.namelist()
        assert names == [f"shoemark_{i:04d}.png" for i in range(3)]
        pngs = [np.asarray(Image.open(io.BytesIO(zf.read(name)))) for name in names]
    assert all(p.shape == (SIZE, SIZE) and p.dtype == np.uint8 for p in pngs)
    # the zip carries the same pixels as the npy route
    body, _ = _post(setup["base"], "n=3&seed=1&format=npy", _png(_source()))
    np.testing.assert_array_equal(np.stack(pngs)[..., None], np.load(io.BytesIO(body)))
    stats = _get(setup["base"], "/stats")
    assert stats["requests"] >= 2 and "latency_ms" in stats


@pytest.mark.parametrize(("n", "seed", "theta"), [(3, 1, 1.0), (8, 2, 0.5), (5, 0, 1.0)])
def test_served_output_matches_jax(setup, n, seed, theta):
    """/generate at n, sliced from its bucket, against the JAX generator on
    the same weights and draws: at most one uint8 level apart (float
    rounding next to a level boundary; 1e-4 on the tanh output is 1/80 of
    a level)."""
    body, ctype = _post(setup["base"], f"n={n}&seed={seed}&theta={theta}&format=npy",
                        _png(_source()))
    assert ctype == "application/octet-stream"
    got = np.load(io.BytesIO(body))
    assert got.shape == (n, SIZE, SIZE, 1) and got.dtype == np.uint8
    want = _jax_served(setup, _source(), setup["engine"].bucket_for(n), seed, theta)[:n]
    _assert_within_one_level(got, want)
    assert not np.array_equal(got[0], got[1])  # styles differ within a request


def test_same_seed_same_output_and_theta_matters(setup):
    base, src = setup["base"], _png(_source())
    a, _ = _post(base, "n=4&seed=7&format=npy", src)
    b, _ = _post(base, "n=4&seed=7&format=npy", src)
    c, _ = _post(base, "n=4&seed=8&format=npy", src)
    theta0, _ = _post(base, "n=4&seed=7&theta=0&format=npy", src)
    assert a == b
    assert a != c
    assert not np.array_equal(np.load(io.BytesIO(a)), np.load(io.BytesIO(theta0)))


def test_generate_batch_matches_solo_requests(setup):
    """One coalesced device call gives every request what it gets alone, to
    one uint8 level: oneDNN may block a batched convolution differently
    from a single image's, so the sums round differently."""
    engine = setup["engine"]
    srcs = [_source(i) for i in range(3)]
    ns, seeds, thetas = [4, 2, 3], [1, 2, 3], [1.0, 0.5, 1.0]
    calls = engine.device_calls
    outs = engine.generate_batch(srcs, ns, seeds, thetas)  # pads 3 -> bucket 4
    assert engine.device_calls == calls + 1
    assert [o.shape[0] for o in outs] == ns
    for src, n, seed, theta, got in zip(srcs, ns, seeds, thetas, outs):
        _assert_within_one_level(got, engine.generate(src, n, seed=seed, theta=theta))


def test_batcher_coalesces_a_burst_over_http(setup):
    """A synchronized burst of 4 requests through a batcher with a wide
    window runs as one device call, and each answer equals the solo one."""
    engine = setup["engine"]
    httpd = port_serve.make_server(engine, host="127.0.0.1", port=0, window_ms=500.0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        barrier = threading.Barrier(4)
        results: dict[int, np.ndarray] = {}

        def client(i):
            barrier.wait(timeout=30)
            body, _ = _post(base, f"n=4&seed={i}&format=npy", _png(_source()))
            results[i] = np.load(io.BytesIO(body))

        threads = [threading.Thread(target=client, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert sorted(results) == [0, 1, 2, 3]
        snap = _get(base, "/stats")["batching"]
        assert snap["device_calls"] == 1 and snap["coalesced_requests"] == 3
        for i in range(4):
            _assert_within_one_level(results[i], engine.generate(_source(), 4, seed=i))
    finally:
        httpd.shutdown()
        httpd.server_close()
        httpd.batcher.close()
        thread.join(timeout=30)


def test_error_paths_and_reload(setup):
    base = setup["base"]
    for query, body in (("n=9", _png(_source())), ("n=0", _png(_source())),
                        ("n=4", b""), ("n=4", b"not an image")):
        with pytest.raises(urllib.error.HTTPError) as exc_info:
            _post(base, query, body)
        assert exc_info.value.code == 400
    req = urllib.request.Request(f"{base}/reload", data=b"", method="POST")
    with pytest.raises(urllib.error.HTTPError) as exc_info:
        urllib.request.urlopen(req, timeout=30)
    assert exc_info.value.code == 400  # an artifact-backed engine does not reload
    assert "immutable artifact" in json.loads(exc_info.value.read())["error"]
    assert _get(base, "/stats")["errors"] >= 5


def test_engine_without_device_raises_on_a_host_without_cuda(setup):
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_serve.InferenceEngine(setup["config"], buckets=BUCKETS)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_serve.InferenceEngine(setup["config"], buckets=BUCKETS, device="cuda")


def test_fresh_weights_warn_and_warmup_runs_every_shape(setup):
    with pytest.warns(UserWarning, match="fresh weights from seed 0"):
        engine = port_serve.InferenceEngine(setup["config"], buckets=BUCKETS, device="cpu")
    # no checkpoint of the run yet: /reload keeps the fresh weights at step 0
    assert engine.step == 0 and engine.reload() == 0
    assert engine.warmup(max_batch=2) >= 0.0
    # 2 n buckets at batch bucket 1, and again at batch bucket 2
    assert engine.device_calls == 4


def test_generate_cli_writes_n_distinct_shoemarks(setup, tmp_path):
    cfg = setup["root"] / "config.toml"
    cfg.write_text(
        "[training]\nbatch_size = 2\nrandom_seed = 0\ntraining_steps = 1\n"
        "image_buffer_size = 4\nstyle_mixing_prob = 0.9\n"
        "deterministic_cuda_kernels = false\ngpu_number = 0\n"
        f'checkpoint_directory = "{setup["root"]}"\ntraining_run = "t"\n'
        "[optimisation]\nstyle_cycle_loss_lambda = 5.0\nidentity_loss_lambda = 5.0\n"
        "reconstruction_loss_lambda = 5.0\nkl_loss_lambda = 0.01\npath_loss_lambda = 0.1\n"
        "path_loss_jacobian_granularity = [0.1, 0.2]\nlearning_rate = 2e-3\n"
        "mapping_network_learning_rate = 2e-5\nadam_betas = [0.5, 0.99]\n"
        "[ada]\ndiscriminator_real_acc_target = 0.6\n"
        "ada_overfitting_measurement_n_images = 8\nada_adjustment_size = 5.12e-4\n"
        "[evaluation]\nlog_interval = 1\ncheckpoint_interval = 1\n"
        "n_evaluation_images = 4\ninference_batch_size = 2\n"
        "[architecture]\nw_dim = 6\nadd_latent_noise = false\nmin_latent_resolution = 8\n"
        "n_resnet_blocks = 3\nmapping_network_layers = 2\n"
        f'[data]\nimage_size = [{SIZE}, {SIZE}]\nimage_channels = 1\n'
        'shoeprint_data_dir = "p"\nshoemark_data_dir = "m"\n'
    )
    src = tmp_path / "print.png"
    src.write_bytes(_png(_source()))
    out = tmp_path / "out"
    port_generate.main([str(cfg), "--source", str(src), "--n", "3", "--out", str(out),
                        "--seed", "4", "--artifact", str(setup["artifact"]),
                        "--device", "cpu"])
    files = sorted(out.glob("shoemark_*.png"))
    assert [f.name for f in files] == [f"shoemark_{i:04d}.png" for i in range(3)]
    imgs = [np.asarray(Image.open(f)) for f in files]
    assert not np.array_equal(imgs[0], imgs[1])
    # the CLI draws z [3, w_dim] from its seed: the JAX generator on those
    _assert_within_one_level(np.stack(imgs)[..., None],
                             _jax_served(setup, _source(), 3, seed=4, theta=1.0))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            port_generate.main([str(cfg), "--source", str(src), "--out", str(out)])
