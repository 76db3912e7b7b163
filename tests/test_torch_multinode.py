"""A training group that spans nodes, on the CPU.

- ``data_parallel`` resolves against torchrun's ``WORLD_SIZE`` (the ranks
  of every node), not against this host's cards; a node that starts more
  ranks than it has cards raises.
- The spatial subgroups that cross nodes when ``spatial_parallel`` does
  not divide a node's ranks, and the one warning that names them.
- Two torchrun nodes of two gloo ranks each, through the real
  ``torch.distributed.run --nnodes 2`` on 127.0.0.1, train the tiny
  config at data 2 x spatial 2: their checkpoint is bitwise the one the
  training CLI's own launcher writes for the same config in one command.
  (The JAX package's mesh spans hosts the same way: its slow
  ``tests/test_multihost.py``.)
- A resume on which one node's checkpoint directory lacks the file raises
  on every rank, and both launches end, within a timeout.
"""

import os
import socket
import subprocess
import sys
import warnings

import chip_smoke
import pytest
import torch

from one_to_many_gan_torch.config import load_config
from one_to_many_gan_torch.data import write_synthetic_dataset_dirs
from one_to_many_gan_torch.parallel import distributed, mesh
from tests.helpers import write_tiny_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH = 8
SIZE = 32
GRID = "\n[tpu]\ndata_parallel = 2\nspatial_parallel = 2\n"
STEPS = 2
LAUNCH_TIMEOUT_S = 300


# ------------------------------------------------------- resolution


@pytest.mark.parametrize(("dp", "sp", "ranks"), [(8, 1, 8), (-1, 1, 8), (-1, 2, 8), (4, 2, 8),
                                                 (2, 2, 4)])
def test_data_parallel_resolves_against_torchruns_world(tmp_path, monkeypatch, dp, sp, ranks):
    """Two nodes of four ranks: ``WORLD_SIZE`` 8, ``LOCAL_WORLD_SIZE`` 4,
    four cards a node; -1 is 8 / S on either device type."""
    config = load_config(write_tiny_config(tmp_path, batch_size=BATCH))
    config["tpu"].update(data_parallel=dp, spatial_parallel=sp)
    env = {"RANK": "5", "WORLD_SIZE": "8", "LOCAL_RANK": "1", "LOCAL_WORLD_SIZE": "4",
           "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": "29500"}
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert distributed.data_parallel_ranks(config, "cuda") == ranks
    assert distributed.data_parallel_ranks(config, "cpu") == ranks


def test_torchrun_resolution_raises_past_the_world_or_the_cards(tmp_path, monkeypatch):
    config = load_config(write_tiny_config(tmp_path, batch_size=BATCH))
    for k, v in {"RANK": "0", "WORLD_SIZE": "8", "LOCAL_RANK": "0", "LOCAL_WORLD_SIZE": "4",
                 "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": "29500"}.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    config["tpu"].update(data_parallel=8, spatial_parallel=2)
    with pytest.raises(ValueError, match="needs 16 devices, have 8"):
        distributed.data_parallel_ranks(config, "cuda")
    # four ranks on a node that shows two cards
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    config["tpu"].update(data_parallel=-1, spatial_parallel=1)
    with pytest.raises(RuntimeError, match="started 4 ranks on this node, which has 2 visible"):
        distributed.data_parallel_ranks(config, "cuda")
    assert distributed.data_parallel_ranks(config, "cpu") == 8
    # without torchrun the host's cards count, as before
    monkeypatch.delenv("WORLD_SIZE")
    assert distributed.data_parallel_ranks(config, "cuda") == 2


@pytest.mark.parametrize(("world", "spatial", "local", "crossing"), [
    (8, 2, 4, []),
    (8, 4, 4, []),
    (8, 4, 2, [[0, 1, 2, 3], [4, 5, 6, 7]]),
    (6, 2, 3, [[2, 3]]),
    (4, 2, 2, []),
])
def test_spatial_subgroups_that_cross_nodes(monkeypatch, world, spatial, local, crossing):
    assert mesh.crossing_subgroups(world, spatial, local) == crossing
    monkeypatch.setenv("LOCAL_WORLD_SIZE", str(local))
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        mesh._warn_crossing_nodes(world, spatial)
    assert len(seen) == (1 if crossing else 0)
    if crossing:
        assert str(crossing) in str(seen[0].message)


# ------------------------------------------------------- two nodes


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env() -> dict:
    env = {k: v for k, v in os.environ.items() if k not in distributed.TORCHRUN_ENV}
    env["OMP_NUM_THREADS"] = "1"
    return env


def _nodes(configs, port: int) -> list[subprocess.Popen]:
    """One torchrun per node (``configs[k]`` on node k), two ranks each,
    all started at once."""
    return [subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--nnodes", str(len(configs)),
         "--node_rank", str(k), "--nproc_per_node", "2", "--master_addr", "127.0.0.1",
         "--master_port", str(port), "-m", "one_to_many_gan_torch.train", str(config),
         "--device", "cpu"],
        cwd=REPO, env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for k, config in enumerate(configs)]


def _wait(procs) -> list[tuple[int, str]]:
    """(exit code, output) of each process, killing all of them past the
    timeout."""
    out = []
    try:
        for p in procs:
            stdout, stderr = p.communicate(timeout=LAUNCH_TIMEOUT_S)
            out.append((p.returncode, stdout + stderr))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The tiny config at data 2 x spatial 2 for 2 steps, as two torchrun
    nodes and as one command of the CLI (its own launcher), all at once."""
    root = tmp_path_factory.mktemp("nodes")
    for domain, seed in (("shoeprints", 0), ("shoemarks", 9)):
        write_synthetic_dataset_dirs(root / domain, n_train=16, n_test=2,
                                     image_size=(SIZE, SIZE), seed=seed)

    def config(run: str, steps: int = STEPS, name: str = "config", ckpt=None):
        path = write_tiny_config(root, batch_size=BATCH, tpu_section=GRID, training_steps=steps,
                                 training_run=f'"{run}"', log_interval=STEPS,
                                 checkpoint_interval=STEPS, n_evaluation_images=4)
        text = path.read_text()
        if ckpt is not None:
            text = text.replace(str(root / "checkpoints"), str(ckpt))
        target = root / f"{name}.toml"
        target.write_text(text)
        return target

    one = subprocess.Popen([sys.executable, "-m", "one_to_many_gan_torch.train",
                            str(config("one", name="one")), "--device", "cpu"], cwd=REPO,
                           env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    two = config("two", name="two")
    results = _wait([*_nodes([two, two], _free_port()), one])
    return {"root": root, "results": results, "config": config}


def test_two_torchrun_nodes_train_as_one_launch_bitwise(runs):
    for code, output in runs["results"]:
        assert code == 0, output[-6000:]
    models = runs["root"] / "checkpoints"
    two = torch.load(models / "two" / "models" / f"{STEPS}.tar", weights_only=True)
    one = torch.load(models / "one" / "models" / f"{STEPS}.tar", weights_only=True)
    diffs, n_tensors, _ = chip_smoke._ckpt_differences(torch, two, one)
    assert n_tensors > 0
    assert not diffs, diffs[:10]
    # rank 0 alone logs: one log line and one FID line
    log = (models / "two" / "log").read_text().splitlines()
    assert [ln.split(",")[0] for ln in log if ln.startswith("Step: ")] == [f"Step: {STEPS}/{STEPS}"]
    assert len([ln for ln in log if " | fid: " in ln]) == 1


def test_resume_on_a_node_without_the_checkpoint_raises_on_every_rank(runs):
    """Node 0 sees the two-node run's checkpoint, node 1 an empty
    directory: every rank raises before the first step, and both
    launches end."""
    empty = runs["root"] / "elsewhere"
    empty.mkdir()
    seen = runs["config"]("two", steps=2 * STEPS, name="node0")
    unseen = runs["config"]("two", steps=2 * STEPS, name="node1", ckpt=empty)
    results = _wait(_nodes([seen, unseen], _free_port()))
    for code, output in results:
        assert code != 0
        assert "ranks [2, 3] resumed from steps [0]" in output, output[-6000:]
        assert "every node must see the same" in output
    assert not (empty / "two" / "models").exists()
