"""The port's TensorBoard sink (``tpu.tensorboard``), on the CPU.

The JAX package's ``tests/test_tensorboard.py`` on the port: the offline
``export_jsonl`` writes event files whose scalars read back; a Trainer
with ``tpu.tensorboard = true`` writes its logged means under
``<run>/tensorboard`` (read back against ``metrics.jsonl``); by default
there is no event directory. Without the ``tensorboard`` package the
Trainer raises an ``ImportError`` naming it.
"""

import builtins
import json

import pytest
import torch
from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

from one_to_many_gan_torch.config import load_config
from one_to_many_gan_torch.core.trainer import Trainer
from one_to_many_gan_torch.data import synthetic_images
from one_to_many_gan_torch.utils.tensorboard import export_jsonl
from tests.helpers import write_tiny_config


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this file's small CPU steps (as
    tests/test_torch_trainer.py); restored afterwards."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _event_files(d):
    return list(d.rglob("events.out.tfevents.*"))


def _scalars(logdir) -> dict[str, list[tuple[int, float]]]:
    acc = EventAccumulator(str(logdir))
    acc.Reload()
    return {tag: [(e.step, e.value) for e in acc.Scalars(tag)] for tag in acc.Tags()["scalars"]}


def _trainer(tmp_path, tpu_section=""):
    config = load_config(write_tiny_config(tmp_path, tpu_section=tpu_section,
                                           training_steps=2, checkpoint_interval=2))
    return config, Trainer(config, shoeprint_images=synthetic_images(8, (32, 32), seed=0),
                           shoemark_images=synthetic_images(8, (32, 32), seed=1),
                           verbose=False, device="cpu")


def test_export_jsonl_writes_event_files(tmp_path):
    jsonl = tmp_path / "metrics.jsonl"
    records = [
        {"step": 2, "disc_loss": 0.5, "total_gen_loss": 1.25},
        {"step": 4, "disc_loss": 0.4, "total_gen_loss": 1.1},
        {"step": 5, "fid": 0.9, "kid": 0.01, "fid_extractor": "random_projection_v1"},
    ]
    jsonl.write_text("".join(json.dumps(r) + "\n" for r in records))
    assert export_jsonl(jsonl, tmp_path / "tb") == 3
    events = _event_files(tmp_path / "tb")
    assert events and events[0].stat().st_size > 0
    scalars = _scalars(tmp_path / "tb")
    assert set(scalars) == {"train/disc_loss", "train/total_gen_loss", "val/fid", "val/kid"}
    assert scalars["train/disc_loss"] == [(2, 0.5), (4, pytest.approx(0.4))]
    assert scalars["val/fid"][0][0] == 5 and abs(scalars["val/fid"][0][1] - 0.9) < 1e-6


def test_trainer_writes_events_when_enabled(tmp_path):
    config, trainer = _trainer(tmp_path, "\n[tpu]\ntensorboard = true\n")
    trainer.run()
    run_dir = config["training"]["checkpoint_directory"] / "test_run"
    assert _event_files(run_dir / "tensorboard")
    logged = [json.loads(line) for line in (run_dir / "metrics.jsonl").open()]
    means = next(r for r in logged if "total_disc_losses" in r)
    scalars = _scalars(run_dir / "tensorboard")
    assert scalars["train/total_disc_losses"] == [(2, pytest.approx(means["total_disc_losses"]))]
    assert {f"train/{k}" for k in means if k != "step"} <= set(scalars)


def test_trainer_default_off(tmp_path):
    config, trainer = _trainer(tmp_path)
    assert config["tpu"]["tensorboard"] is False
    trainer.run()
    run_dir = config["training"]["checkpoint_directory"] / "test_run"
    assert (run_dir / "metrics.jsonl").is_file() and not (run_dir / "tensorboard").exists()


def test_a_missing_tensorboard_package_is_named(tmp_path, monkeypatch):
    real_import = builtins.__import__

    def no_tensorboard(name, *args, **kwargs):
        if name.startswith("torch.utils.tensorboard") or name.startswith("tensorboard"):
            raise ImportError(f"No module named {name!r}")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_tensorboard)
    with pytest.raises(ImportError, match="tpu.tensorboard = true needs the tensorboard package"):
        _trainer(tmp_path, "\n[tpu]\ntensorboard = true\n")
