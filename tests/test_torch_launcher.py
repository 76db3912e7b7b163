"""The port's local launcher (``parallel/distributed.spawn``) on gloo
ranks: every rank runs the function in a group of the asked size, and a
rank's failure reaches the caller as ``RankFailed`` with its exit code.
No JAX: the spawned ranks import this module."""

import json
from pathlib import Path

import pytest
import torch
import torch.distributed as dist

from one_to_many_gan_torch.parallel import distributed
from one_to_many_gan_torch.parallel.mesh import DataParallel

WORLD = 2


def _write_rank(group, out: str) -> None:
    Path(out, f"{group.rank}.json").write_text(json.dumps(
        {"world": group.world, "rank": group.rank, "device": str(group.device),
         "threads": torch.get_num_threads(),
         "dist_world": dist.get_world_size()}))


def _fail_rank(group, how: str) -> None:
    if group.rank != 1:
        return
    if how == "exit":
        raise SystemExit(42)
    msg = "rank one's own error"
    raise ValueError(msg)


def test_spawn_runs_every_rank(tmp_path, monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    distributed.spawn(_write_rank, WORLD, "cpu", (str(tmp_path),))
    got = [json.loads((tmp_path / f"{r}.json").read_text()) for r in range(WORLD)]
    assert got == [{"world": WORLD, "rank": r, "device": "cpu", "threads": 1,
                    "dist_world": WORLD} for r in range(WORLD)]


@pytest.mark.parametrize(("how", "code", "text"), [
    ("exit", 42, "exited with code 42"),
    ("raise", 1, "ValueError: rank one's own error"),
])
def test_spawn_raises_a_failed_ranks_code(monkeypatch, how, code, text):
    """A ``SystemExit`` keeps its code (the CLI's 42 for a diverged run);
    an exception exits 1 and its traceback is in the message."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    with pytest.raises(distributed.RankFailed, match=text) as info:
        distributed.spawn(_fail_rank, WORLD, "cpu", (how,))
    assert (info.value.rank, info.value.exitcode) == (1, code)


def test_local_batch_slice_is_the_groups_rows():
    group = DataParallel(4, 2, torch.device("cpu"))
    assert group.rows(8) == slice(4, 6)
    assert distributed.local_batch_slice(8, group) == (2, 4)
    assert distributed.local_batch_slice(8) == (8, 0)
    with pytest.raises(ValueError, match="7 rows do not split over 4 ranks"):
        distributed.local_batch_slice(7, group)
