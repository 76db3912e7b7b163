"""The port's checkpoints and artifact, read by the JAX package.

A port training state after one fused step on the CPU (tiny config:
32x32, batch 2, buffer 4, so Adam's moments, ADA's window and the
buffer, half full, are all non-trivial) is saved as
``<run>/models/1.tar``. Through the JAX
package's ``migrate.import_torch_checkpoint`` (the reference's importer)
it must give a JAX ``TrainState`` with every parameter, Adam moment and
count, the ADA probability and every buffer image equal to the port's
(exactly: the values are copies). The port's ``.npz`` artifact must have
the JAX export's keys and shapes and load through the JAX package's
``export.load_inference_artifact``; an engine serving it must equal one
serving the checkpoint; ``/reload`` must pick up a newer checkpoint.
"""

import functools
import json
import threading
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from one_to_many_gan_torch import convert as port_convert
from one_to_many_gan_torch import export as port_export
from one_to_many_gan_torch import generate as port_generate
from one_to_many_gan_torch import serve as port_serve
from one_to_many_gan_torch import train as port_train
from one_to_many_gan_torch.config import load_config
from one_to_many_gan_torch.core.state import Models, init_train_state
from one_to_many_gan_torch.core.train_step import make_train_step
from one_to_many_gan_torch.core.trainer import save_checkpoint
from one_to_many_gan_torch.migrate import (
    MigrationError,
    checkpoint_manager,
    from_reference_checkpoint,
)
from one_to_many_gan_tpu.config import load_config as jax_load_config
from one_to_many_gan_tpu.export import _flatten as jax_flatten
from one_to_many_gan_tpu.export import load_inference_artifact as jax_load_artifact
from one_to_many_gan_tpu import migrate as jax_migrate
from one_to_many_gan_tpu.core.state import init_train_state as jax_init_train_state
from tests.helpers import write_tiny_config


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this file's small CPU steps: with several
    test workers on one host, torch's default of a thread per core
    oversubscribes the cores, and ops this small then wait on each other
    (~40x slower in a 6-worker run); restored afterwards."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


STEPS = 1
NETWORKS = {  # JAX TrainState field -> (port attribute, convert's layer walk)
    "g": ("generator", port_convert._generator_layers),
    "d": ("discriminator", port_convert._discriminator_layers),
    "m": ("mapping", port_convert._mapping_layers),
    "s": ("extractor", port_convert._extractor_layers),
}


def _get(tree, path: str):
    for part in path.split("/"):
        tree = tree[part]
    return np.asarray(tree)


def _port_leaves(state, net: str, value_of):
    """(JAX leaf path, ``value_of(parameter)`` in the JAX layout)."""
    attr, layers = NETWORKS[net]
    for path, param, layout in port_convert.jax_leaves(layers(getattr(state, attr))):
        value = value_of(param).detach().float().numpy()
        yield path, port_convert._to_jax_layout(value, layout)


def _jit_init_train_state(config, models, rng):
    """``init_train_state`` as one program, compiled without XLA's backend
    optimisations (the state is a template: the import replaces its values)."""
    lowered = jax.jit(functools.partial(jax_init_train_state, config, models)).lower(rng)
    options = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}
    return lowered.compile(options)(rng)


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ckpt")
    cfg_path = write_tiny_config(tmp)
    config = load_config(cfg_path)
    models, state, gen = port_train.setup(config, seed=3, ada_p=0.25, device="cpu")
    train_step = make_train_step(config, models)
    for _ in range(STEPS):
        state, _ = port_train.run_step(config, models, state, train_step, gen)
    mgr = checkpoint_manager(config)
    save_checkpoint(mgr, STEPS, state)
    # The JAX importer builds its template state with ``init_train_state``:
    # op by op, that compiles one program per operation (~25 s on one core);
    # as one unoptimised program, ~5 s.
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_migrate, "init_train_state", _jit_init_train_state)
        jstate, step = jax_migrate.import_torch_checkpoint(jax_load_config(cfg_path),
                                                           mgr.path(STEPS))
    assert step == STEPS
    return {"config": config, "state": state, "mgr": mgr, "jstate": jstate, "tmp": tmp}


@pytest.mark.parametrize("net", list(NETWORKS))
def test_jax_import_gives_the_port_parameters(saved, net):
    jparams = getattr(saved["jstate"], f"params_{net}")
    leaves = list(_port_leaves(saved["state"], net, lambda p: p))
    assert len(leaves) == len(jax.tree.leaves(jparams))
    for path, want in leaves:
        np.testing.assert_array_equal(_get(jparams, path), want, err_msg=path)


@pytest.mark.parametrize("net", list(NETWORKS))
def test_jax_import_gives_the_port_adam_moments(saved, net):
    state = saved["state"]
    opt = getattr(state, f"opt_{net}")
    adam = getattr(saved["jstate"], f"opt_{net}")[0]
    assert int(adam.count) == STEPS
    assert all(int(s["step"]) == STEPS for s in opt.state.values())
    for field, moment in (("exp_avg", adam.mu), ("exp_avg_sq", adam.nu)):
        for path, want in _port_leaves(state, net, lambda p, f=field: opt.state[p][f]):
            np.testing.assert_array_equal(_get(moment, path), want, err_msg=f"{field} {path}")


def test_jax_import_gives_the_port_ada_buffer_and_step(saved):
    state, jstate = saved["state"], saved["jstate"]
    assert int(jstate.step) == STEPS == state.step
    assert float(jstate.ada.p) == float(state.ada.p) == 0.25
    count = int(state.buffer.count)
    assert count == 2 and int(jstate.buffer.count) == count
    np.testing.assert_array_equal(np.asarray(jstate.buffer.images),
                                  state.buffer.images.numpy())
    # the reference drops the ADA window: the JAX import starts a fresh one
    assert int(state.ada.count) == STEPS and int(jstate.ada.count) == 0


def test_reference_file_without_the_extra_keys(saved):
    """A reference ``<step>.tar`` has no ``step`` and no ADA window: the
    reader takes the step from the caller (the file name) and starts a
    fresh window; a missing step is refused."""
    config, state = saved["config"], saved["state"]
    ckpt = saved["mgr"].load(STEPS)
    ckpt.pop("step")
    ckpt.pop("ada_window")
    models = Models(config, device="cpu", seed=9)
    with pytest.raises(MigrationError, match="carries no step"):
        from_reference_checkpoint(ckpt, init_train_state(config, models, seed=9))
    fresh = from_reference_checkpoint(ckpt, init_train_state(config, models, seed=9), step=7)
    assert fresh.step == 7 and int(fresh.ada.count) == 0 and float(fresh.ada.accum) == 0
    assert torch.equal(fresh.ada.p, state.ada.p)
    for p, q in zip(fresh.generator.parameters(), state.generator.parameters(), strict=True):
        assert torch.equal(p, q)


def test_architecture_mismatch_is_refused(saved, tmp_path):
    config = load_config(write_tiny_config(tmp_path, n_resnet_blocks=5))
    models = Models(config, device="cpu")
    with pytest.raises(MigrationError, match="missing"):
        from_reference_checkpoint(saved["mgr"].load(STEPS), init_train_state(config, models))


@pytest.fixture(scope="module")
def artifact(saved):
    return port_export.export_inference_artifact(saved["config"], saved["tmp"] / "model.npz",
                                                 device="cpu")


def test_artifact_has_the_jax_export_layout(saved, artifact):
    """The JAX export's keys and shapes (its flatten of the imported
    state's trees); the JAX reader loads it, leaf for leaf the port's
    weights in the JAX layout."""
    jstate = saved["jstate"]
    want: dict = {}
    jax_flatten(jax.tree.map(np.asarray, jstate.params_g), "g", want)
    jax_flatten(jax.tree.map(np.asarray, jstate.params_m), "m", want)
    with np.load(artifact) as z:
        assert set(z.files) == {*want, "__step__", "__ema__"}
        assert all(z[k].shape == want[k].shape and z[k].dtype == np.float32 for k in want)
    params_g, params_m, step, ema = jax_load_artifact(artifact)
    assert step == STEPS and ema is False
    for got, tree in ((params_g, jstate.params_g), (params_m, jstate.params_m)):
        for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(got)[0],
                                jax.tree.leaves(tree), strict=True):
            np.testing.assert_array_equal(a, np.asarray(b), err_msg=str(path))
    assert port_export.load_inference_artifact(artifact)[2] == STEPS


def _png(image_u8: np.ndarray) -> bytes:
    import io

    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(image_u8[..., 0]).save(buf, format="PNG")
    return buf.getvalue()


SOURCE = np.random.default_rng(0).integers(0, 256, (32, 32, 1), dtype=np.uint8)


def test_engine_from_checkpoint_equals_engine_from_artifact(saved, artifact):
    from_ckpt = port_serve.InferenceEngine(saved["config"], buckets=(4,), device="cpu")
    from_art = port_serve.InferenceEngine(saved["config"], buckets=(4,), artifact=artifact,
                                          device="cpu")
    assert from_ckpt.step == from_art.step == STEPS
    for seed in (0, 5):
        np.testing.assert_array_equal(from_ckpt.generate(SOURCE, 4, seed=seed),
                                      from_art.generate(SOURCE, 4, seed=seed))
    with pytest.raises(ValueError, match="immutable artifact"):
        from_art.reload()


def test_reload_picks_up_a_newer_checkpoint(saved):
    """A server on the run's checkpoint at step 1; a newer file, 2.tar,
    with the generator's weights changed; ``POST /reload`` answers step 2
    and serves those weights."""
    config, mgr = saved["config"], saved["mgr"]
    engine = port_serve.InferenceEngine(config, buckets=(4,), device="cpu")
    before = engine.generate(SOURCE, 4, seed=1)
    httpd = port_serve.make_server(engine, host="127.0.0.1", port=0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"

    def reload() -> dict:
        req = urllib.request.Request(f"{base}/reload", data=b"", method="POST")
        with urllib.request.urlopen(req, timeout=60) as resp:
            return json.loads(resp.read())

    try:
        assert reload() == {"status": "ok", "step": STEPS}
        newer = mgr.load(STEPS)
        newer["generator_state_dict"] = {
            k: v * 0.5 if v.is_floating_point() else v
            for k, v in newer["generator_state_dict"].items()
        }
        newer["step"] = STEPS + 1
        mgr.save(STEPS + 1, newer)
        assert reload() == {"status": "ok", "step": STEPS + 1}
        with urllib.request.urlopen(f"{base}/healthz", timeout=30) as resp:
            assert json.loads(resp.read())["step"] == STEPS + 1
        after = engine.generate(SOURCE, 4, seed=1)
        assert not np.array_equal(after, before)
        fresh = port_serve.InferenceEngine(config, buckets=(4,), device="cpu")
        np.testing.assert_array_equal(after, fresh.generate(SOURCE, 4, seed=1))
    finally:
        httpd.shutdown()
        httpd.server_close()
        httpd.batcher.close()
        thread.join(timeout=30)
    assert not thread.is_alive()


def test_generate_cli_reads_the_run_checkpoint(saved, tmp_path, capsys):
    src = tmp_path / "print.png"
    src.write_bytes(_png(SOURCE))
    cfg = saved["tmp"] / "config.toml"
    port_generate.main([str(cfg), "--source", str(src), "--n", "2", "--out",
                        str(tmp_path / "out"), "--device", "cpu"])
    out = capsys.readouterr().out
    assert "loaded checkpoint at step" in out and "fresh weights" not in out
    assert len(list((tmp_path / "out").glob("shoemark_*.png"))) == 2


def test_export_cli_and_missing_checkpoint(saved, tmp_path, capsys):
    out = tmp_path / "cli.npz"
    port_export.main([str(saved["tmp"] / "config.toml"), "--out", str(out), "--device", "cpu"])
    assert "wrote" in capsys.readouterr().out and out.stat().st_size > 0
    empty = load_config(write_tiny_config(tmp_path))
    with pytest.raises(FileNotFoundError, match="no checkpoint of run"):
        port_export.export_inference_artifact(empty, tmp_path / "none.npz", device="cpu")
