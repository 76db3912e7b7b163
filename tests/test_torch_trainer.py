"""The port's ``Trainer`` on the CPU, against the JAX package's loop.

At ``tests/helpers.write_tiny_config``'s size (32x32, batch 2): the
``Logger`` line byte for byte against the JAX ``Logger`` on the same
metric values; the Trainer's data streams against JAX ``BatchIterator``s
built with the JAX Trainer's seed offsets; then a 4-step run (its log,
``metrics.jsonl``, grids, validation images and checkpoints), and the
same run paused twice and resumed (in groups of 2 steps, without the
prefetch thread, keeping one checkpoint), whose final checkpoint must
equal the uninterrupted run's bit for bit; SIGTERM, the halt on a
non-finite metric, the refused ``[tpu]`` keys and the CLI's exit code.
"""

import re
import signal
import warnings

import numpy as np
import pytest
import torch

from one_to_many_gan_torch import train as port_train
from one_to_many_gan_torch.config import load_config
from one_to_many_gan_torch.core import evaluation as port_evaluation
from one_to_many_gan_torch.core.state import Models, init_train_state
from one_to_many_gan_torch.core.trainer import (
    Trainer,
    TrainingDiverged,
    restore_checkpoint,
    save_checkpoint,
)
from one_to_many_gan_torch.data import synthetic_images, write_synthetic_dataset_dirs
from one_to_many_gan_torch.migrate import CheckpointManager
from one_to_many_gan_tpu.core.evaluation import Logger as JaxLogger
from one_to_many_gan_tpu.data import BatchIterator as JaxBatchIterator
from one_to_many_gan_tpu.data import normalize_u8
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


PRINTS = synthetic_images(8, (32, 32), seed=0)
MARKS = synthetic_images(8, (32, 32), seed=1)
SEED = 42  # write_tiny_config's random_seed
LOG_LINE = re.compile(
    r"Step: \d+/\d+, D loss: [-\d.e+na]+, D real/fake acc: [-\d.e+na]+/[-\d.e+na]+, "
    r"Total G loss: [-\d.e+na]+, Gan loss [-\d.e+na]+, Idt loss [-\d.e+na]+, "
    r"Rec loss [-\d.e+na]+, KL loss [-\d.e+na]+, Path loss [-\d.e+na]+, "
    r"Style loss: [-\d.e+na]+, ADA: [-\d.e+na]+, "
)
FID_LINE = re.compile(r"Step \d+ \| fid: \S+, kid: \S+ \[random_projection_v1\]")
FOUR_STEPS = {"training_steps": 4, "checkpoint_interval": 2}  # logs and checkpoints at 2, 4


def _config(tmp_path, tpu: str = "", **overrides):
    section = f"\n[tpu]\n{tpu}\n" if tpu else ""
    return load_config(write_tiny_config(tmp_path, tpu_section=section, **overrides))


def _trainer(config, **kw) -> Trainer:
    return Trainer(config, shoeprint_images=PRINTS, shoemark_images=MARKS, verbose=False,
                   device="cpu", **kw)


def _run_dir(config):
    return config["training"]["checkpoint_directory"] / config["training"]["training_run"]


def _assert_same(a, b, where="ckpt") -> int:
    """Recursive bitwise equality of two checkpoint dicts; -> tensors seen."""
    if torch.is_tensor(a):
        assert torch.is_tensor(b) and a.dtype == b.dtype and torch.equal(a, b), where
        return 1
    if isinstance(a, dict):
        assert a.keys() == b.keys(), where
        return sum(_assert_same(a[k], b[k], f"{where}.{k}") for k in a)
    if isinstance(a, list):
        assert len(a) == len(b), where
        return sum(_assert_same(x, y, f"{where}[{i}]") for i, (x, y) in enumerate(zip(a, b)))
    assert a == b, where
    return 0


# ------------------------------------------------------------------ Logger


def test_logger_lines_equal_jax():
    """Three intervals of float32 values (a NaN in the last): the same
    line and means as the JAX Logger's, byte for byte."""
    rng = np.random.default_rng(0)
    port, jax_logger = port_evaluation.Logger(100), JaxLogger(100)
    for step, n in ((3, 3), (7, 4), (9, 2)):
        for i in range(n):
            values = (rng.normal(size=11) * 10.0 ** rng.integers(-4, 3, 11)).astype(np.float32)
            if step == 9 and i == 1:
                values[5] = np.nan
            metrics = dict(zip(port_evaluation.Logger.METRICS, values, strict=True))
            port.append_metrics({k: torch.tensor(v) for k, v in metrics.items()})
            jax_logger.append_metrics(metrics)
        line, means = port.summary(step)
        want_line, want_means = jax_logger.summary(step)
        assert line == want_line
        assert list(means) == list(want_means) == sorted(port_evaluation.Logger.SERIES)
        np.testing.assert_array_equal(list(means.values()), list(want_means.values()))
    assert LOG_LINE.fullmatch(line)


# ------------------------------------------------------------------- data


def test_streams_equal_jax_batch_iterators(tmp_path):
    """The D and G batches of the first groups (uint8, prints and marks
    from streams at seed + 1 and seed + 2, alternating D and G), the grid
    streams (seed + 3, + 4, float) and the val stream (seed, sequential):
    equal to the JAX package's iterators at those offsets; the device-side
    normalisation equals ``normalize_u8``."""
    trainer = _trainer(_config(tmp_path))
    jax_iter = {
        name: JaxBatchIterator(images, 2, shuffle=True, flip_prob=0.5, seed=SEED + off,
                               as_float=off > 2)
        for name, images, off in (("p", PRINTS, 1), ("m", MARKS, 2), ("gp", PRINTS, 3),
                                  ("gm", MARKS, 4))
    }
    for _ in range(5):  # past an epoch of 8 images
        group = trainer._make_group(1)
        u8 = group[0].numpy()
        want = [next(jax_iter["p"]), next(jax_iter["m"]), next(jax_iter["p"]),
                next(jax_iter["m"])]
        np.testing.assert_array_equal(u8, np.stack(want))
        (batches,) = trainer._unpack_group(group)
        for got, w in zip(batches, want, strict=True):
            np.testing.assert_array_equal(got.numpy(), normalize_u8(w))
    for _ in range(3):
        np.testing.assert_array_equal(next(trainer.grid_print_iter), next(jax_iter["gp"]))
        np.testing.assert_array_equal(next(trainer.grid_mark_iter), next(jax_iter["gm"]))
    jax_val = JaxBatchIterator(PRINTS, 4, shuffle=False, flip_prob=0.5, seed=SEED)
    for _ in range(3):
        np.testing.assert_array_equal(next(trainer.val_iter), next(jax_val))


# ------------------------------------------------------- a run of 4 steps


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """4 steps: logs and checkpoints at 2 and 4, the group of step 3
    profiled."""
    tmp = tmp_path_factory.mktemp("run")
    config = _config(tmp, "profile_step = 3", **FOUR_STEPS)
    trainer = _trainer(config)
    state = trainer.run()
    return config, trainer, state


def test_run_trains_every_step_and_checkpoints(run):
    config, trainer, state = run
    assert state.step == 4 and trainer.start_step == 0
    assert trainer.ckpt_mgr.all_steps() == [2, 4]
    assert set(trainer.timings) == {"image", "val", "save"}


def test_log_and_metrics_jsonl_follow_the_reference_format(run):
    import json

    config, _, _ = run
    lines = (_run_dir(config) / "log").read_text().splitlines()
    steps = [ln for ln in lines if ln.startswith("Step:")]
    fids = [ln for ln in lines if ln.startswith("Step ")]
    assert [ln.split("/")[0] for ln in steps] == ["Step: 2", "Step: 4"]
    assert all(LOG_LINE.fullmatch(ln) for ln in steps), steps
    assert [ln.split(" |")[0] for ln in fids] == ["Step 2", "Step 4"]
    assert all(FID_LINE.fullmatch(ln) for ln in fids), fids
    records = [json.loads(ln) for ln in (_run_dir(config) / "metrics.jsonl").read_text()
               .splitlines()]
    intervals = [r for r in records if "fid" not in r]
    assert [r["step"] for r in intervals] == [2, 4]
    assert set(intervals[0]) == {"step", *port_evaluation.Logger.SERIES}
    evals = [r for r in records if "fid" in r]
    assert [(r["step"], r["fid_extractor"]) for r in evals] == [
        (2, "random_projection_v1"), (4, "random_projection_v1")]
    assert all(np.isfinite(r["fid"]) and np.isfinite(r["kid"]) for r in evals)


def test_grids_and_validation_images(run):
    from PIL import Image

    config, _, _ = run
    images = _run_dir(config) / "images"
    assert sorted(p.name for p in images.iterdir()) == [
        "decoding_2.png", "decoding_4.png", "translation_2.png", "translation_4.png"]
    gap = 32 // 10
    assert Image.open(images / "translation_4.png").size == (8 * 32 + 7 * gap,
                                                            9 * 32 + 8 * gap)
    assert Image.open(images / "decoding_4.png").size == (8 * 32 + 7 * gap, 5 * 32 + 4 * gap)
    val = sorted(int(p.stem) for p in (_run_dir(config) / "val").glob("*.png"))
    assert val == list(range(8))  # n_evaluation_images
    assert np.asarray(Image.open(_run_dir(config) / "val" / "0.png")).shape == (32, 32)


def test_profile_step_traces_its_group(run):
    config, trainer, _ = run
    assert trainer.profile["steps"] == 1 and trainer.profile["wall_ms"] > 0
    assert trainer.profile["device_busy_ms"] is None  # no device on the CPU
    assert (_run_dir(config) / "trace" / "trace.json").stat().st_size > 0


def test_checkpoint_round_trip_is_bitwise(run, tmp_path):
    config, trainer, state = run
    mgr = CheckpointManager(tmp_path, keep=2)
    save_checkpoint(mgr, 4, state)
    models = Models(config, device="cpu", seed=7)
    fresh = init_train_state(config, models, seed=7)
    restored, step = restore_checkpoint(mgr, fresh)
    assert step == 4 and restored.step == 4
    saved = mgr.load(4)
    assert _assert_same(saved, torch.load(trainer.ckpt_mgr.path(4), weights_only=True)) > 100
    again = CheckpointManager(tmp_path / "again", keep=1)
    save_checkpoint(again, 4, restored)
    _assert_same(again.load(4), saved)
    with pytest.raises(ValueError, match="saving step 3 of a state at step 4"):
        save_checkpoint(mgr, 3, state)


def test_checkpoint_manager_keeps_the_newest(tmp_path):
    mgr = CheckpointManager(tmp_path / "models", keep=2)
    assert mgr.latest_step() is None and mgr.all_steps() == []
    for step in (10, 2, 30):
        mgr.save(step, {"step": step})
    assert mgr.all_steps() == [10, 30] and mgr.latest_step() == 30
    (tmp_path / "models" / ".40.tar.tmp").write_bytes(b"torn")  # a save cut short
    assert mgr.latest_step() == 30 and mgr.load(30) == {"step": 30}


# ------------------------------- the same run, resumed from 2 and paused at 3


@pytest.fixture(scope="module")
def resumed(run, tmp_path_factory):
    """The run stopped at its checkpoint at 2 (grids, FID, model): that
    file in a new run directory, with the run's config in groups of 2, no
    prefetch thread and one checkpoint kept. A resume runs 1 step and
    pauses off the cadence at 3 (model only); a second resume runs to the
    end."""
    import shutil

    _, trainer_a, _ = run
    tmp = tmp_path_factory.mktemp("resumed")
    config = _config(tmp, "steps_per_call = 2\nprefetch = 0\nkeep_checkpoints = 1",
                     **FOUR_STEPS)
    models = _run_dir(config) / "models"
    models.mkdir(parents=True)
    shutil.copy(trainer_a.ckpt_mgr.path(2), models / "2.tar")
    seen = {}
    second = _trainer(config)
    seen["second_start"] = second.start_step
    second.run(max_steps=1)
    seen["after_pause"] = second.ckpt_mgr.all_steps()
    seen["images_after_pause"] = sorted(p.name for p in (_run_dir(config)).rglob("*.png"))
    third = _trainer(config)
    seen["third_start"] = third.start_step
    third.run()
    seen["final"] = third.ckpt_mgr.all_steps()
    seen["k"] = third.steps_per_call
    return config, third, seen


def test_paused_and_resumed_run_equals_the_uninterrupted_run_bitwise(run, resumed):
    """Every tensor of the final checkpoint (4 networks, 4 Adams, ADA p
    and window, the buffer) equal, and the log line of the interval both
    runs cover whole (a pause also logs at the step it stops at)."""
    config_a, trainer_a, _ = run
    config_b, trainer_b, seen = resumed
    assert seen["k"] == 2
    a, b = trainer_a.ckpt_mgr.load(4), trainer_b.ckpt_mgr.load(4)
    assert _assert_same(a, b) > 100
    assert b["step"] == 4 and len(b["image_buffer_images"]) == 4

    def train_lines(config):
        return [ln for ln in (_run_dir(config) / "log").read_text().splitlines()
                if ln.startswith("Step:")]

    lines_a, lines_b = train_lines(config_a), train_lines(config_b)
    assert [ln.split(",")[0] for ln in lines_b] == ["Step: 3/4", "Step: 4/4"]
    assert [ln.split(",")[0] for ln in lines_a] == ["Step: 2/4", "Step: 4/4"]


def test_pause_off_the_cadence_saves_the_model_only(resumed):
    config, _, seen = resumed
    assert seen["after_pause"] == [3]
    assert seen["images_after_pause"] == []  # the pause wrote no grids, no val images
    images = sorted(p.name for p in (_run_dir(config) / "images").iterdir())
    assert images == ["decoding_4.png", "translation_4.png"]
    assert seen["second_start"] == 2 and seen["third_start"] == 3


def test_retention_keeps_one_checkpoint(resumed):
    _, _, seen = resumed
    assert seen["after_pause"] == [3]  # 2 deleted once 3 had landed
    assert seen["final"] == [4]


# ------------------------------------------------------------- stopping


def test_sigterm_saves_and_stops_at_the_next_group(tmp_path):
    config = _config(tmp_path)
    trainer = _trainer(config)
    calls = {"n": 0}
    tap = trainer.logger.append_metrics

    def append(metrics):
        calls["n"] += 1
        if calls["n"] == 1:  # SIGTERM during the first step
            signal.raise_signal(signal.SIGTERM)
        return tap(metrics)

    trainer.logger.append_metrics = append
    state = trainer.run()
    assert state.step == 1 and trainer.ckpt_mgr.latest_step() == 1
    assert _trainer(config).start_step == 1
    assert signal.getsignal(signal.SIGTERM) in (signal.SIG_DFL, signal.Handlers.SIG_DFL)


def _poison(trainer):
    summary = trainer.logger.summary

    def poisoned(step):
        line, means = summary(step)
        return line, {**means, "total_gen_losses": float("nan")}

    trainer.logger.summary = poisoned


def test_halt_on_nonfinite_raises_before_any_checkpoint(tmp_path):
    trainer = _trainer(_config(tmp_path, log_interval=1, checkpoint_interval=1))
    _poison(trainer)
    with pytest.raises(TrainingDiverged, match=r"non-finite metrics \['total_gen_losses'\]"):
        trainer.run()  # the log at step 1 comes before the checkpoint at 1
    assert trainer.ckpt_mgr.latest_step() is None
    assert not (_run_dir(trainer.config) / "images").exists()


def test_halt_on_nonfinite_off_trains_through(tmp_path):
    trainer = _trainer(_config(tmp_path, "halt_on_nonfinite = false", log_interval=1))
    _poison(trainer)
    assert trainer.run(max_steps=1).step == 1


@pytest.mark.parametrize(("key", "value"), [
    ("split_phases", "true"), ("remat", '"conv"'), ("native_loader", "true"),
    ("tensorboard", "true"), ("data_parallel", "2"), ("spatial_parallel", "2"),
    ("r1_gamma", "10.0"), ("ema_decay", "0.999"), ("ada_supersample", "true"),
    ("g_loss_split", "true"),
])
def test_refused_tpu_keys_raise_by_name(tmp_path, key, value):
    with pytest.raises(NotImplementedError, match=rf"tpu\.{key} = .*not ported"):
        _trainer(_config(tmp_path, f"{key} = {value}"))


def test_steps_per_call_is_clamped_with_a_warning(tmp_path):
    with pytest.warns(UserWarning, match="steps_per_call=4 does not divide"):
        trainer = _trainer(_config(tmp_path, "steps_per_call = 4\ndata_parallel = 1"))
    assert trainer.steps_per_call == 1  # gcd with log 2 and checkpoint 3
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert _trainer(_config(tmp_path, "steps_per_call = 2", training_steps=4,
                                checkpoint_interval=4)).steps_per_call == 2


# ------------------------------------------------------------------- CLI


def test_cli_trains_from_folders_and_exits_42_on_divergence(tmp_path, monkeypatch, capsys):
    """``python -m one_to_many_gan_torch.train config.toml --device cpu``
    on image folders: a 1-step run to its end, then the same run made 2
    steps long resumes at 1 and exits with code 42 when an interval mean
    is not finite."""
    write_synthetic_dataset_dirs(tmp_path / "shoeprints", n_train=4, n_test=1,
                                 image_size=(32, 32), seed=0)
    write_synthetic_dataset_dirs(tmp_path / "shoemarks", n_train=4, n_test=1,
                                 image_size=(32, 32), seed=9)
    cfg = write_tiny_config(tmp_path, training_steps=1)
    port_train.main([str(cfg), "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert LOG_LINE.fullmatch(out[0].split(" [")[0]) and FID_LINE.fullmatch(out[1])
    summary = port_evaluation.Logger.summary

    def poisoned(self, step):
        line, means = summary(self, step)
        return line, {**means, "kl_losses": float("inf")}

    monkeypatch.setattr(port_evaluation.Logger, "summary", poisoned)
    cfg = write_tiny_config(tmp_path, training_steps=2)
    with pytest.raises(SystemExit) as exc_info:
        port_train.main([str(cfg), "--device", "cpu"])
    assert exc_info.value.code == port_train.DIVERGED_EXIT_CODE == 42
    assert "Resumed from checkpoint at step 1" in capsys.readouterr().out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            port_train.main([str(cfg)])
