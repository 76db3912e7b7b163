"""Process-group start-up for data parallelism, and the local launcher.

The JAX package's ``parallel/distributed.py`` joins ``jax.distributed``
across hosts; here each data-parallel rank is a process with one card
(NCCL), or, on the CPU, a process of its own (gloo, for the tests).

- ``ensure_initialized`` joins the process group: from torchrun's
  ``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK`` / ``MASTER_ADDR`` /
  ``MASTER_PORT`` when they are set, else from the arguments the local
  launcher passes. On a card it calls ``torch.cuda.set_device`` before
  anything is allocated and before the group starts. A group that fails
  to start raises.
- ``spawn`` is the local launcher: ``torch.multiprocessing.spawn`` with
  one process per rank, a free port on ``127.0.0.1``, each rank running
  ``fn(group, *args)``; when a rank fails the others are ended and it
  raises ``RankFailed`` with that rank's exit code. A SIGTERM to the
  launcher is passed on to every rank.
- ``data_parallel_ranks`` is the number of ranks a config runs on a
  device type, ``data_parallel x spatial_parallel``: on ``cuda``
  ``config.resolve_data_parallel`` over the visible cards; on the CPU
  ``data_parallel`` gloo ranks to a spatial column, -1 meaning one.
"""

from __future__ import annotations

import contextlib
import datetime
import os
import signal
import socket
from collections.abc import Callable

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from one_to_many_gan_torch.config import Config, resolve_data_parallel
from one_to_many_gan_torch.parallel.mesh import DataParallel, make_group

TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")
# The default timeout of every collective and barrier (torch's own default
# for a process group); ``barrier_timeout_s`` gives the Trainer's.
DEFAULT_TIMEOUT_S = 1800.0


class RankFailed(RuntimeError):
    """A rank of ``spawn`` exited with a non-zero code (``exitcode``)."""

    def __init__(self, rank: int, exitcode: int, detail: str = ""):
        msg = f"data-parallel rank {rank} exited with code {exitcode}"
        super().__init__(f"{msg}: {detail}" if detail else msg)
        self.rank = rank
        self.exitcode = exitcode


def torchrun_present() -> bool:
    """True when torchrun's variables are all set in the environment."""
    return all(v in os.environ for v in TORCHRUN_ENV)


def data_parallel_ranks(config: Config, device_type: str) -> int:
    """The ranks ``config`` trains on, ``data_parallel x spatial_parallel``:
    on ``cuda`` ``resolve_data_parallel`` over ``torch.cuda.device_count()``
    cards (more than there are raise); on ``cpu`` ``data_parallel`` gloo
    processes to each of ``spatial_parallel`` columns, -1 meaning one."""
    sp = config["tpu"]["spatial_parallel"]
    if device_type == "cuda":
        return resolve_data_parallel(config, torch.cuda.device_count()) * sp
    dp = config["tpu"]["data_parallel"]
    return resolve_data_parallel(config, (1 if dp == -1 else dp) * sp) * sp


def ensure_initialized(
    device_type: str,
    *,
    rank: int | None = None,
    world_size: int | None = None,
    local_rank: int | None = None,
    init_method: str | None = None,
    timeout_s: float = DEFAULT_TIMEOUT_S,
    spatial: int = 1,
) -> DataParallel:
    """Join (or, when this process has joined, return) the group on
    ``device_type`` (``cuda``: NCCL, ``cpu``: gloo), ``spatial`` ranks to a
    data row. Without ``rank`` the torchrun variables give it; without
    either it raises."""
    if rank is None:
        if not torchrun_present():
            msg = (
                "no process group to join: pass rank, world_size and init_method, "
                f"or run under torchrun (it sets {', '.join(TORCHRUN_ENV)})"
            )
            raise RuntimeError(msg)
        rank = int(os.environ["RANK"])
        world_size = int(os.environ["WORLD_SIZE"])
        local_rank = int(os.environ["LOCAL_RANK"])
        init_method = "env://"
    local_rank = rank if local_rank is None else local_rank
    if device_type == "cuda":
        if local_rank >= torch.cuda.device_count():
            msg = (f"rank {rank} needs cuda:{local_rank}, but "
                   f"{torch.cuda.device_count()} cards are visible")
            raise RuntimeError(msg)
        device = torch.device("cuda", local_rank)
        torch.cuda.set_device(device)  # before any allocation and the group
        backend = "nccl"
    elif device_type == "cpu":
        device, backend = torch.device("cpu"), "gloo"
    else:
        msg = f"unsupported device type {device_type!r}; use 'cuda' or 'cpu'"
        raise ValueError(msg)
    timeout = datetime.timedelta(seconds=timeout_s)
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method=init_method, rank=rank,
                                world_size=world_size, timeout=timeout)
    return make_group(device, timeout, spatial)


def local_batch_slice(global_batch: int, group: DataParallel | None = None) -> tuple[int, int]:
    """(local_batch, offset) of this rank's rows of a global batch (the
    whole batch without a group)."""
    if group is None:
        return global_batch, 0
    rows = group.rows(global_batch)
    return rows.stop - rows.start, rows.start


def barrier_timeout_s(config: Config) -> float:
    """The Trainer's barrier timeout: the default plus one second per
    evaluation image (rank 0 evaluates while the others wait)."""
    return DEFAULT_TIMEOUT_S + float(config["evaluation"]["n_evaluation_images"])


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, world: int, device_type: str, port: int, timeout_s: float,
               threads: int, fn: Callable, args: tuple, spatial: int = 1) -> None:
    """One rank of ``spawn``: join the group, run ``fn(group, *args)``,
    leave the group."""
    torch.set_num_threads(threads)
    group = ensure_initialized(device_type, rank=rank, world_size=world,
                               init_method=f"tcp://127.0.0.1:{port}", timeout_s=timeout_s,
                               spatial=spatial)
    fn(group, *args)
    group.close()
    dist.destroy_process_group()


def spawn(fn: Callable, world: int, device_type: str, args: tuple = (), *,
          timeout_s: float = DEFAULT_TIMEOUT_S, spatial: int = 1) -> None:
    """Run ``fn(group, *args)`` on ``world`` ranks, one process each
    (``torch.multiprocessing.spawn``), ``spatial`` ranks to a data row, and
    wait for them all. ``fn`` and
    ``args`` must pickle (a module-level function). Each rank runs
    ``OMP_NUM_THREADS`` torch threads when it is set, else the host's
    cores shared out, so that the ranks' thread pools do not oversubscribe
    the host; it inherits this process's environment. A SIGTERM to this
    process is passed on to every rank. When a rank fails, the others are
    ended and ``RankFailed`` is raised with its exit code (1 for an
    exception, whose traceback the message carries)."""
    threads = (int(os.environ.get("OMP_NUM_THREADS", 0))
               or max(1, (os.cpu_count() or 1) // world))
    ctx = mp.spawn(_rank_main, nprocs=world, join=False,
                   args=(world, device_type, _free_port(), timeout_s, threads, fn, args,
                         spatial))

    def forward_term(signum, frame):  # noqa: ARG001
        for pid in ctx.pids():
            with contextlib.suppress(ProcessLookupError):
                os.kill(pid, signal.SIGTERM)

    try:
        prev = signal.signal(signal.SIGTERM, forward_term)
    except ValueError:  # not the main thread
        prev = None
    try:
        while not ctx.join():
            pass
    except mp.ProcessRaisedException as exc:
        raise RankFailed(exc.error_index, 1, str(exc)) from None
    except mp.ProcessExitedException as exc:
        code = exc.exit_code
        raise RankFailed(exc.error_index, code if code > 0 else 128 - code) from None
    finally:
        if prev is not None:
            signal.signal(signal.SIGTERM, prev)
