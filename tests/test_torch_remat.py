"""Rematerialisation (``tpu.remat``, ``tpu.remat_d``) on the CPU, without JAX.

As the JAX package holds ``jax.checkpoint`` against no checkpointing
(``tests/test_train_step.py``), the port holds itself: at
``tests/helpers.write_tiny_config``'s size, two fused steps (R1 and the
path term at step 0, neither at step 1) under "conv" and "full" give every
metric and every gradient leaf of both phases bitwise equal to "none",
with ``remat_d`` "same" and "none", under ``g_loss_split`` and with the
activations' kink pattern recorded or pinned (a recompute replays the
pattern instead of running past it). "conv" saves exactly the outputs of
the convolutions ``EqualizedConv`` and ``ModulatedConv`` run, and no FIR
convolution's; a recomputed pass launches its instance norms again.
"""

import importlib

import pytest
import torch

import chip_smoke
from one_to_many_gan_torch import train as port_train
from one_to_many_gan_torch.config import load_config
from one_to_many_gan_torch.core import train_step as port_ts
from one_to_many_gan_torch.ops import EqualizedConv, ModulatedConv, activations, remat
from tests.helpers import write_tiny_config


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this file's small CPU steps (as
    tests/test_torch_trainer.py); restored afterwards."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


in_module = importlib.import_module("one_to_many_gan_torch.ops.cuda.instance_norm")
resample = importlib.import_module("one_to_many_gan_torch.ops.resample")
PRODUCTION = "\n[tpu]\nema_decay = 0.9\nr1_gamma = 10.0\nr1_interval = 2\npath_interval = 2\n"


def _config(tmp_path, remat_mode="none", remat_d="same", extra=""):
    tmp_path.mkdir(parents=True, exist_ok=True)
    tpu = PRODUCTION + f'remat = "{remat_mode}"\nremat_d = "{remat_d}"\n' + extra
    return load_config(write_tiny_config(tmp_path, tpu_section=tpu))


def _two_steps(config) -> list[torch.Tensor]:
    """Two fused steps from seed 0 at ADA p 0.6: each phase's metrics and
    gradient leaves, then the parameters after them."""
    models, state, gen = port_train.setup(config, seed=0, ada_p=0.6, device="cpu")
    d_phase, g_phase = port_ts.make_d_phase(config, models), port_ts.make_g_phase(config, models)
    g_modules = (state.generator, state.mapping, state.extractor)
    out = []
    for step in range(2):
        batches = port_ts.Batches(*(port_ts.synthetic_batch(gen, 2, (32, 32), 1)
                                    for _ in range(4)))
        draws = port_ts.draw_step(gen, config, models)
        p = state.ada.p
        state, dm = d_phase(state, batches.d_shoeprints, batches.d_shoemarks, draws.d)
        out += [*dm.values(), *(q.grad.clone() for q in state.discriminator.parameters())]
        state, gm = g_phase(state, batches, draws.g, p)
        assert (gm["path_loss"].item() > 0) == (step == 0)
        out += [*gm.values(), *(q.grad.clone() for m in g_modules for q in m.parameters())]
    return out + [q.detach().clone() for m in (state.discriminator, *g_modules)
                  for q in m.parameters()]


def _assert_bitwise(got: list, want: list) -> None:
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want, strict=True)):
        assert a.dtype == b.dtype and torch.equal(a, b), i


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return _two_steps(_config(tmp_path_factory.mktemp("none")))


@pytest.mark.parametrize(("mode", "mode_d"), [
    ("conv", "same"), ("full", "same"), ("conv", "none"), ("full", "none"), ("none", "full"),
])
def test_remat_is_bitwise_no_remat(tmp_path, reference, mode, mode_d):
    _assert_bitwise(_two_steps(_config(tmp_path, mode, mode_d)), reference)


@pytest.mark.parametrize("mode", ["conv", "full"])
def test_remat_under_g_loss_split_is_bitwise_no_remat(tmp_path, mode):
    split = "g_loss_split = true\n"
    want = _two_steps(_config(tmp_path / "none", extra=split))
    _assert_bitwise(_two_steps(_config(tmp_path / mode, mode, extra=split)), want)


@pytest.mark.parametrize("mode", ["conv", "full"])
def test_remat_replays_the_kink_pattern(tmp_path, reference, mode):
    """Recorded under remat, the pattern is the one recorded without it
    (each recompute records aside); pinned under remat, every mask is
    taken once, none flips, and the bits are those without remat."""
    with activations.record() as plain:
        _assert_bitwise(_two_steps(_config(tmp_path / "none")), reference)
    with activations.record() as recorded:
        _assert_bitwise(_two_steps(_config(tmp_path / "rec", mode)), reference)
    assert len(recorded.masks) == len(plain.masks) > 0
    assert all(torch.equal(a, b) for a, b in zip(recorded.masks, plain.masks, strict=True))
    with activations.pin(plain.masks) as pinned:
        _assert_bitwise(_two_steps(_config(tmp_path / "pin", mode)), reference)
    assert len(pinned.flips) == len(plain.masks) and pinned.n_flips() == 0


def _g_loss(config, monkeypatch):
    """One G loss and backward on a path step; -> (the conv modules'
    forward calls, the FIR convolutions' calls)."""
    models, state, gen = port_train.setup(config, seed=0, ada_p=0.6, device="cpu")
    calls = {"conv_modules": 0, "fir": 0}

    def hook(*_):
        calls["conv_modules"] += 1

    hooks = [m.register_forward_hook(hook) for net in (state.generator, state.extractor,
                                                       state.discriminator)
             for m in net.modules() if isinstance(m, (EqualizedConv, ModulatedConv))]
    fir = resample._DepthwiseConv.apply

    def counted(*args):
        calls["fir"] += 1
        return fir(*args)

    monkeypatch.setattr(resample._DepthwiseConv, "apply", counted)
    batches = port_ts.Batches(*(port_ts.synthetic_batch(gen, 2, (32, 32), 1) for _ in range(4)))
    draws = port_ts.draw_g_phase(gen, config, models)
    port_ts.make_g_loss(config, models)(state, batches, draws, state.ada.p, True)
    for h in hooks:
        h.remove()
    monkeypatch.undo()
    return calls


def test_conv_policy_saves_only_the_model_convs(tmp_path, monkeypatch):
    """Every ``EqualizedConv`` and ``ModulatedConv`` of a G pass runs inside
    a checkpointed pass: "conv" saves one ``aten.convolution`` output for
    each of their forward calls without remat, and nothing else, while the
    FIR resamples' depthwise convolutions run (and are recomputed)."""
    plain = _g_loss(_config(tmp_path / "none"), monkeypatch)
    remat.saves.clear()
    conv = _g_loss(_config(tmp_path / "conv", "conv"), monkeypatch)
    assert plain["fir"] > 0 and plain["conv_modules"] > 0
    assert dict(remat.saves) == {"aten.convolution.default": plain["conv_modules"]}
    # the recompute calls the modules and the FIRs again
    assert conv["conv_modules"] > plain["conv_modules"] and conv["fir"] > plain["fir"]
    remat.saves.clear()
    _g_loss(_config(tmp_path / "full", "full"), monkeypatch)
    assert not remat.saves


@pytest.mark.parametrize("mode", ["conv", "full"])
def test_recomputed_passes_launch_their_instance_norms_again(tmp_path, monkeypatch, mode):
    """Without remat, the calls chip_smoke.py's site lists count (see
    tests/test_torch_production.py); under it every instance norm of the
    G phase runs twice, and the D phase's discriminator pass's again
    (R1's pass is not wrapped)."""
    calls = {"in": 0}
    apply = in_module._InstanceNorm.apply

    def counted(*args):
        calls["in"] += 1
        return apply(*args)

    monkeypatch.setattr(in_module._InstanceNorm, "apply", counted)
    seen = {}
    for name, config in (("none", _config(tmp_path / "none")),
                         (mode, _config(tmp_path / mode, mode))):
        models, state, gen = port_train.setup(config, seed=0, ada_p=0.6, device="cpu")
        d_phase, g_phase = (port_ts.make_d_phase(config, models),
                            port_ts.make_g_phase(config, models))
        batches = port_ts.Batches(*(port_ts.synthetic_batch(gen, 2, (32, 32), 1)
                                    for _ in range(4)))
        draws = port_ts.draw_step(gen, config, models)
        calls["in"] = 0
        p = state.ada.p
        d_phase(state, batches.d_shoeprints, batches.d_shoemarks, draws.d)  # an R1 step
        d_calls, calls["in"] = calls["in"], 0
        g_phase(state, batches, draws.g, p)
        seen[name] = (d_calls, calls["in"])
    trunk = len(chip_smoke._TRUNK_512)  # the discriminator's instance norms
    assert seen[mode] == (seen["none"][0] + trunk, 2 * seen["none"][1])


def test_make_ckpt_refuses_an_unknown_mode():
    with pytest.raises(ValueError, match="remat mode"):
        remat.make_ckpt("some")
    assert remat.make_ckpt("none")(lambda a, b: a + b, 1, 2) == 3
