"""The production training options of the port on the CPU, without JAX.

At ``tests/helpers.write_tiny_config``'s size (32x32, batch 2):

- second derivatives, which lazy R1 takes through the discriminator:
  ``gradgradcheck`` of the instance norm's ``autograd.Function`` (ReLU on
  and off) and of the pads (replicate and reflect), in float64;
- the launches of each phase (instance norms and warps, counted at their
  ``autograd.Function``), on an R1 step and on a path step under
  ``g_loss_split``, against the site lists ``chip_smoke.py`` reckons with;
- generator EMA: after two steps the EMA generator is the JAX package's
  formula ``e * decay + p * (1 - decay)`` (each product and the sum
  rounded to float32) applied in numpy to the port's own iterates, bit
  for bit; grids, ``val_checkpoint``, the artifact and ``/healthz`` read
  the EMA weights (as ``tests/test_ema_eval.py`` holds the JAX package);
  checkpoints carry them, and a file without them starts EMA as the
  generator;
- ``g_loss_split``: its gradients equal the joint backward's on a path
  step and on another step, within float reassociation;
- ``split_phases``: a Trainer run equals the fused run in groups of 2,
  bit for bit; and a run paused and resumed with EMA and R1 on equals
  the uninterrupted one, bit for bit;
- ``tpu.s2d_pack`` (a TPU repacking the port ignores): one step with it
  equals one step without it;
- the one-card copy of ``configs/tpu_v5e8_512.toml``.
"""

import copy
import importlib
import json
import threading
import urllib.request

import numpy as np
import pytest
import torch

import chip_smoke
from one_to_many_gan_torch import convert as port_convert
from one_to_many_gan_torch import export as port_export
from one_to_many_gan_torch import serve as port_serve
from one_to_many_gan_torch import train as port_train
from one_to_many_gan_torch.config import (
    check_training_options,
    load_config,
    resolve_data_parallel,
)
from one_to_many_gan_torch.core import evaluation as port_evaluation
from one_to_many_gan_torch.core import train_step as port_ts
from one_to_many_gan_torch.core.state import Models, eval_generator, init_train_state
from one_to_many_gan_torch.core.trainer import Trainer, save_checkpoint
from one_to_many_gan_torch.data import BatchIterator, synthetic_images
from one_to_many_gan_torch.migrate import (
    EMA_KEY,
    checkpoint_manager,
    from_reference_checkpoint,
    to_reference_checkpoint,
)
from one_to_many_gan_torch.ops.pad import pad
from one_to_many_gan_torch.ops.cuda import fused_instance_norm
from one_to_many_gan_torch.ops.cuda import instance_norm as in_module
from one_to_many_gan_torch.presets import card_overrides, write_card_config
from tests.helpers import write_tiny_config


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this file's small CPU steps (as
    tests/test_torch_trainer.py); restored afterwards."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


warp_module = importlib.import_module("one_to_many_gan_torch.ops.cuda.warp")
PRINTS = synthetic_images(8, (32, 32), seed=0)
MARKS = synthetic_images(8, (32, 32), seed=1)
DECAY = 0.9
PRODUCTION = "\n[tpu]\nema_decay = 0.9\nr1_gamma = 10.0\nr1_interval = 2\npath_interval = 2\n"


def _config(tmp_path, tpu: str = PRODUCTION, **overrides):
    tmp_path.mkdir(parents=True, exist_ok=True)
    return load_config(write_tiny_config(tmp_path, tpu_section=tpu, **overrides))


def _trainer(config, **kw) -> Trainer:
    return Trainer(config, shoeprint_images=PRINTS, shoemark_images=MARKS, verbose=False,
                   device="cpu", **kw)


def _equal(a, b, where="ckpt") -> int:
    """Recursive bitwise equality of two checkpoint dicts; -> tensors seen."""
    if torch.is_tensor(a):
        assert torch.is_tensor(b) and a.dtype == b.dtype and torch.equal(a, b), where
        return 1
    if isinstance(a, dict):
        assert list(a) == list(b), where
        return sum(_equal(a[k], b[k], f"{where}.{k}") for k in a)
    if isinstance(a, list):
        assert len(a) == len(b), where
        return sum(_equal(x, y, f"{where}[{i}]") for i, (x, y) in enumerate(zip(a, b)))
    assert a == b, where
    return 0


# ------------------------------------------------------- second derivatives


@pytest.mark.parametrize("relu", [False, True])
def test_instance_norm_backward_is_twice_differentiable(relu):
    """R1 differentiates the IN's closed-form backward once more. With
    ReLU the saved output's mask is a constant there (ReLU's second
    derivative is 0), so the check holds away from the kink."""
    x = torch.randn((2, 3, 5, 4), dtype=torch.float64, generator=torch.Generator().manual_seed(0))
    x.requires_grad_(True)
    assert torch.autograd.gradgradcheck(lambda t: fused_instance_norm(t, relu=relu), (x,))


@pytest.mark.parametrize("mode", ["replicate", "reflect"])
def test_pad_backward_is_twice_differentiable(mode):
    x = torch.randn((2, 3, 5, 6), dtype=torch.float64, generator=torch.Generator().manual_seed(1))
    x.requires_grad_(True)
    assert torch.autograd.gradgradcheck(lambda t: pad(t, (2, 1, 1, 3), mode), (x,))


@pytest.mark.parametrize("size", [(8, 10), (9, 7)])
def test_resampling_is_twice_differentiable(size):
    """The FIRs before D's downsampling (even sizes: the stride-2 FIR; odd:
    the blur, then the bilinear matrices)."""
    from one_to_many_gan_torch.ops.resample import downsample2x

    x = torch.randn((2, 3, *size), dtype=torch.float64, generator=torch.Generator().manual_seed(2))
    x.requires_grad_(True)
    assert torch.autograd.gradgradcheck(downsample2x, (x,))


def test_r1_runs_one_conv_per_depthwise_fir():
    """PyTorch's double backward of a grouped conv runs one conv per
    channel; the FIRs' own Functions run one conv per derivative. R1
    through a 32x32 discriminator: 4 trunk convs, a head and 6 FIRs, each
    at most 4 convs over the forward, backward and double backward."""
    from torch.profiler import ProfilerActivity, profile

    from one_to_many_gan_torch.losses import r1_penalty
    from one_to_many_gan_torch.models import Discriminator

    disc = Discriminator(1)
    x = torch.rand((2, 1, 32, 32), generator=torch.Generator().manual_seed(3)) * 2 - 1
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        torch.autograd.grad(r1_penalty(disc, x), list(disc.parameters()), allow_unused=True)
    convs = sum(e.count for e in prof.key_averages() if e.key == "aten::convolution")
    assert convs <= 4 * (5 + 6)


# ----------------------------------------------------------------- launches


class _Counts:
    """Calls of the IN and warp ``autograd.Function``s (the kernels' call
    sites: on a card each call is one launch)."""

    def __init__(self, monkeypatch):
        self.n = {"in": 0, "warp": 0}
        for key, fn in (("in", in_module._InstanceNorm), ("warp", warp_module._Warp)):
            apply = fn.apply

            def counted(*args, key=key, apply=apply):
                self.n[key] += 1
                return apply(*args)

            monkeypatch.setattr(fn, "apply", counted)

    def take(self) -> dict:
        out, self.n = self.n, {"in": 0, "warp": 0}
        return out


def test_launches_per_phase_follow_the_site_lists(tmp_path, monkeypatch):
    """On an R1 step the D phase adds the trunk's 3 instance norms on the
    reals; under ``g_loss_split`` a path step adds one encode's. The tiny
    encoder has its own site count; the trunk's 3 are the 512^2 config's."""
    counts = _Counts(monkeypatch)
    config = _config(tmp_path, PRODUCTION + "g_loss_split = true\n")
    models, state, gen = port_train.setup(config, seed=0, ada_p=0.6, device="cpu")
    gen_net = models.generator
    encode = 1 + len(gen_net.enc_down) + 2 * len(gen_net.enc_blocks)
    trunk = len(chip_smoke._TRUNK_512)
    d_phase, g_phase = port_ts.make_d_phase(config, models), port_ts.make_g_phase(config, models)
    seen = []
    for step in range(3):  # R1 and path at 0 and 2
        batches = port_ts.Batches(*(port_ts.synthetic_batch(gen, 2, (32, 32), 1)
                                    for _ in range(4)))
        draws = port_ts.draw_step(gen, config, models)
        p = state.ada.p
        state, _ = d_phase(state, batches.d_shoeprints, batches.d_shoemarks, draws.d)
        d = counts.take()
        state, _ = g_phase(state, batches, draws.g, p)
        seen.append((d, counts.take()))
    for step, (d, g) in enumerate(seen):
        lazy = step % 2 == 0
        assert d == {"in": encode + trunk + (trunk if lazy else 0), "warp": 2}, step
        assert g == {"in": encode + 3 * trunk + (encode if lazy else 0), "warp": 1}, step
    assert len(chip_smoke._ENCODE_512) == 10
    assert len(chip_smoke.P_R1_IN_SITES) == trunk


# ---------------------------------------------------------------------- EMA


def test_ema_after_two_steps_is_the_jax_formula(tmp_path):
    config = _config(tmp_path)
    models, state, gen = port_train.setup(config, seed=0, ada_p=0.6, device="cpu")
    assert state.ema_generator is not None and eval_generator(state) is state.ema_generator
    assert not any(p.requires_grad for p in state.ema_generator.parameters())
    e = [p.detach().numpy().copy() for p in state.generator.parameters()]
    train_step = port_ts.make_train_step(config, models)
    d = np.float32(DECAY)
    c = np.float32(1.0 - DECAY)  # JAX's weak-typed (1.0 - decay), in float32
    for _ in range(2):
        state, _ = port_train.run_step(config, models, state, train_step, gen)
        p = [q.detach().numpy() for q in state.generator.parameters()]
        e = [ei * d + pi * c for ei, pi in zip(e, p, strict=True)]
    got = [q.detach().numpy() for q in state.ema_generator.parameters()]
    moved = 0.0
    for g, want, p in zip(got, e, state.generator.parameters(), strict=True):
        # the same roundings: bit for bit
        np.testing.assert_array_equal(g, want)
        moved = max(moved, float(np.abs(g - p.detach().numpy()).max()))
    assert moved > 0
    off = init_train_state(_config(tmp_path / "off", ""), Models(config, device="cpu"))
    assert off.ema_generator is None and eval_generator(off) is off.generator


@pytest.fixture(scope="module")
def ema_states(tmp_path_factory):
    """A state whose EMA generator is visibly off its generator (+0.25),
    and the same weights installed as the trained generator, EMA off."""
    tmp = tmp_path_factory.mktemp("ema")
    config = _config(tmp)
    state = init_train_state(config, Models(config, device="cpu"))
    with torch.no_grad():
        for p in state.ema_generator.parameters():
            p.add_(0.25)
    live = copy.copy(state)
    live.generator, live.ema_generator = copy.deepcopy(state.ema_generator), None
    return tmp, config, state, live


def _iter(seed):
    images = (np.random.default_rng(seed).random((8, 32, 32, 1)) * 255).astype(np.uint8)
    return BatchIterator(images, 4, shuffle=False, flip_prob=0.0, seed=0, as_float=True)


def test_grids_and_val_checkpoint_read_the_ema_generator(ema_states):
    tmp, config, state, live = ema_states
    models = Models(config, device="cpu")
    grids, fids = {}, {}
    base = copy.copy(state)
    base.ema_generator = None
    reals = (np.random.default_rng(9).random((8, 32, 32, 1)) * 255).astype(np.uint8)
    for name, st in (("ema", state), ("live", live), ("base", base)):
        cfg = copy.deepcopy(config)
        cfg["training"]["training_run"] = name
        port_evaluation.image_checkpoint(1, cfg, models, st, _iter(3), _iter(4),
                                         torch.Generator().manual_seed(1))
        grids[name] = (tmp / "checkpoints" / name / "images" / "translation_1.png").read_bytes()
        fids[name], _ = port_evaluation.val_checkpoint(
            1, cfg, models, st, _iter(5), torch.Generator().manual_seed(2), real_images=reals)
    assert grids["ema"] == grids["live"] != grids["base"]
    assert fids["ema"] == fids["live"] != fids["base"]


def test_artifact_and_server_read_the_ema_generator(ema_states):
    tmp, config, state, live = ema_states
    state.step = 3
    mgr = checkpoint_manager(config)
    save_checkpoint(mgr, 3, state)
    art = port_export.export_inference_artifact(config, tmp / "ema.npz", device="cpu")
    params_g, params_m, step, ema = port_export.load_inference_artifact(art)
    assert step == 3 and ema is True
    want_g, _ = port_convert.to_jax_params(live)
    flat_got, flat_want = {}, {}
    port_convert._flatten(params_g, "", flat_got)
    port_convert._flatten(want_g, "", flat_want)
    assert flat_got.keys() == flat_want.keys()
    for key, value in flat_want.items():
        np.testing.assert_array_equal(flat_got[key], value, err_msg=key)
    engine = port_serve.InferenceEngine(config, buckets=(4,), device="cpu")
    assert engine.step == 3 and engine.ema is True
    httpd = port_serve.make_server(engine, host="127.0.0.1", port=0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        newer = mgr.load(3)
        newer["step"] = 4
        mgr.save(4, newer)
        req = urllib.request.Request(f"{base}/reload", data=b"", method="POST")
        with urllib.request.urlopen(req, timeout=60) as resp:
            assert json.loads(resp.read()) == {"status": "ok", "step": 4}
        with urllib.request.urlopen(f"{base}/healthz", timeout=30) as resp:
            health = json.loads(resp.read())
        assert health["ema"] is True and health["step"] == 4
    finally:
        httpd.shutdown()
        httpd.server_close()
        httpd.batcher.close()
        thread.join(timeout=30)
    assert not thread.is_alive()


def test_checkpoints_carry_the_ema_generator(ema_states):
    """Round trip; a file without the EMA key (the reference's) starts EMA
    as the generator; a state without EMA ignores the key."""
    _, config, state, _ = ema_states
    ckpt = to_reference_checkpoint(state)
    assert list(ckpt[EMA_KEY]) == list(ckpt["generator_state_dict"])
    fresh = init_train_state(config, Models(config, device="cpu", seed=5), seed=5)
    from_reference_checkpoint(ckpt, fresh, step=3)
    for p, q in zip(fresh.ema_generator.parameters(), state.ema_generator.parameters(),
                    strict=True):
        assert torch.equal(p, q)
    del ckpt[EMA_KEY]
    from_reference_checkpoint(ckpt, fresh, step=3)
    for p, q in zip(fresh.ema_generator.parameters(), state.generator.parameters(),
                    strict=True):
        assert torch.equal(p, q)
    assert EMA_KEY not in to_reference_checkpoint(init_train_state(
        _config(ema_states[0] / "off", ""), Models(config, device="cpu")))


def test_convert_carries_the_jax_ema_params(ema_states):
    _, config, state, live = ema_states
    params_g, params_m = port_convert.to_jax_params(live)
    fresh = init_train_state(config, Models(config, device="cpu", seed=6), seed=6)
    port_convert.from_jax_params(fresh, *port_convert.to_jax_params(state), ema_params_g=params_g)
    for p, q in zip(fresh.ema_generator.parameters(), live.generator.parameters(), strict=True):
        assert torch.equal(p, q)
    with pytest.raises(ValueError, match="no EMA generator"):
        port_convert.from_jax_params(live, params_g, params_m, ema_params_g=params_g)


# ------------------------------------------------------------ g_loss_split


@pytest.mark.parametrize("path_step", [True, False])
def test_g_loss_split_equals_the_joint_backward(tmp_path, path_step):
    """The two sub-backwards (the main terms, then the path term on a
    fresh encode) against the joint backward, from one state and one set
    of draws: the metrics equal, each gradient within float32
    reassociation of its leaf's largest entry."""
    joint_cfg = _config(tmp_path)
    split_cfg = _config(tmp_path / "split", PRODUCTION + "g_loss_split = true\n")
    models, state, gen = port_train.setup(joint_cfg, seed=0, ada_p=0.6, device="cpu")
    train_step = port_ts.make_train_step(joint_cfg, models)
    state, _ = port_train.run_step(joint_cfg, models, state, train_step, gen)
    batches = port_ts.Batches(*(port_ts.synthetic_batch(gen, 2, (32, 32), 1) for _ in range(4)))
    draws = port_ts.draw_g_phase(gen, joint_cfg, models)
    params = [p for m in (state.generator, state.mapping, state.extractor) for p in m.parameters()]
    out = {}
    for name, cfg in (("joint", joint_cfg), ("split", split_cfg)):
        metrics = port_ts.make_g_loss(cfg, models)(state, batches, draws, state.ada.p, path_step)
        out[name] = (metrics, [p.grad.clone() for p in params])
    (jm, jg), (sm, sg) = out["joint"], out["split"]
    assert (jm["path_loss"].item() > 0) == path_step
    for key in jm:
        torch.testing.assert_close(sm[key], jm[key], rtol=1e-6, atol=0, msg=key)
    # leaves whose gradient is 0 in exact arithmetic (the biases of the
    # convs an instance norm follows) are rounding noise on both sides,
    # held to 1e-6 of the whole gradient's largest entry
    whole = max(b.abs().max() for b in jg)
    for a, b in zip(sg, jg, strict=True):
        scale = b.abs().max()
        bound = 1e-6 * whole if scale < 1e-5 * whole else 1e-5 * scale
        assert (a - b).abs().max() <= bound


# ------------------------------------------------- split_phases and resume


def _run(config, steps=None) -> dict:
    trainer = _trainer(config)
    trainer.run(max_steps=steps)
    return trainer.ckpt_mgr.load(trainer.ckpt_mgr.latest_step())


FOUR = {"training_steps": 4, "checkpoint_interval": 4, "log_interval": 2}


def test_split_phases_equals_the_fused_run(tmp_path):
    split = _config(tmp_path / "split", PRODUCTION + "split_phases = true\nsteps_per_call = 2\n",
                    **FOUR)
    fused = _config(tmp_path / "fused", PRODUCTION + "steps_per_call = 2\n", **FOUR)
    assert _trainer(split).steps_per_call == 1 and _trainer(fused).steps_per_call == 2
    assert _equal(_run(split), _run(fused)) > 0


def test_resume_with_ema_and_r1_is_exact(tmp_path):
    whole = _run(_config(tmp_path / "whole", **FOUR))
    paused = _config(tmp_path / "paused", **FOUR)
    _run(paused, steps=1)
    resumed = _run(paused)
    assert resumed["step"] == whole["step"] == 4 and EMA_KEY in whole
    assert _equal(resumed, whole) > 0


def test_s2d_pack_loads_and_trains_as_without_it(tmp_path):
    """``tpu.s2d_pack`` is the TPU's space-to-depth repacking of the same
    3x3 convs; the port reads the key and ignores it: one step from seed 0
    gives the same metrics, bit for bit."""
    metrics = {}
    for flag in ("false", "true"):
        config = _config(tmp_path / flag, f"\n[tpu]\ns2d_pack = {flag}\n")
        assert config["tpu"]["s2d_pack"] is (flag == "true")
        models, state, gen = port_train.setup(config, seed=0, ada_p=0.6, device="cpu")
        train_step = port_ts.make_train_step(config, models)
        _, step_metrics = port_train.run_step(config, models, state, train_step, gen)
        metrics[flag] = {k: v.item() for k, v in step_metrics.items()}
    assert metrics["true"] == metrics["false"]
    assert all(np.isfinite(v) for v in metrics["true"].values())


# --------------------------------------------------------- one-card config


def test_one_card_copy_of_the_production_config(tmp_path):
    src = chip_smoke.PROD_CONFIG
    source = load_config(src)
    check_training_options(source)  # data 4 x spatial 2: 8 ranks
    assert resolve_data_parallel(source, 8) * source["tpu"]["spatial_parallel"] == 8
    assert card_overrides(source) == {"data_parallel": 1, "batch_size": 8,
                                          "spatial_parallel": 1}
    changes = write_card_config(src, tmp_path / "one.toml",
                                    shoeprint_data_dir=str(tmp_path / "prints"))
    config = load_config(tmp_path / "one.toml")
    check_training_options(config)
    assert list(changes) == ["data_parallel", "batch_size", "spatial_parallel",
                             "shoeprint_data_dir"]
    assert config["tpu"]["native_loader"] is True
    tpu = config["tpu"]
    assert (tpu["ema_decay"], tpu["r1_gamma"], tpu["r1_interval"], tpu["split_phases"],
            tpu["path_interval"]) == (0.999, 10.0, 16, True, 8)
    assert config["training"]["batch_size"] == 8 and config["data"]["image_size"] == [512, 512]
    before = src.read_text().splitlines()
    after = (tmp_path / "one.toml").read_text().splitlines()
    assert len(before) == len(after) and sum(a != b for a, b in zip(before, after)) == 4
    with pytest.raises(ValueError, match="expected one line for 'remat_x'"):
        write_card_config(src, tmp_path / "bad.toml", remat_x=1)
