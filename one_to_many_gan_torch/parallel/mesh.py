"""The data-parallel group: what one rank knows of the others.

The JAX package writes its step on global arrays over a ("data",
"spatial") mesh, and XLA inserts the collectives (its
``parallel/mesh.py``). Here the same program runs in every rank, each
rank holds its own rows of the global batch, and the step calls the
collectives itself, through ``DataParallel``:

- ``rows`` / ``shard``: this rank's contiguous rows of a global batch
  (``shard_batch``'s counterpart; the interleaved packing of
  ``core/train_step.batch_pack`` keeps a rank's packed rows contiguous);
- ``reduce_gradients``: the mean over ranks of each optimiser's
  gradients, in one flat buffer per optimiser, with a few scalar metrics
  riding in the last buffer (one all-reduce per optimiser);
- ``all_reduce_sum``: a global sum (the KL loss's moments);
- ``all_gather_rows``: every rank's rows, in rank order (the replay
  buffer's fakes);
- ``replicate``: rank 0's state broadcast to every rank once at start
  (``replicate``'s counterpart; JAX assumes the copies equal, the
  broadcast makes them so);
- ``any`` / ``barrier``: host-side agreement on a flag (SIGTERM) and a
  meeting point (rank 0 evaluating), on a gloo group of their own, so
  that neither waits for the card.

Spatial parallelism (the JAX "spatial" axis) is not ported.
"""

from __future__ import annotations

import datetime

import torch
import torch.distributed as dist


class DataParallel:
    """One rank of a data-parallel process group (``world`` ranks, this
    one ``rank``, its tensors on ``device``). ``control`` is a gloo group
    of the same ranks for host-side flags and barriers."""

    def __init__(self, world: int, rank: int, device: torch.device, control=None):
        self.world = world
        self.rank = rank
        self.device = device
        self.control = control

    def __repr__(self) -> str:
        return f"DataParallel(world={self.world}, rank={self.rank}, device={self.device})"

    @property
    def is_main(self) -> bool:
        """Rank 0: the one that writes logs, grids, evaluation and checkpoints."""
        return self.rank == 0

    def rows(self, n: int) -> slice:
        """This rank's rows of a global leading dimension ``n``."""
        if n % self.world:
            msg = f"{n} rows do not split over {self.world} ranks"
            raise ValueError(msg)
        local = n // self.world
        return slice(self.rank * local, (self.rank + 1) * local)

    def shard(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows of ``x`` (a view)."""
        return x[self.rows(x.shape[0])]

    def reduce_gradients(self, param_groups, metrics: list[torch.Tensor] = ()) -> list[torch.Tensor]:
        """Replace the ``.grad`` of every parameter of ``param_groups`` (one
        list per optimiser) by its mean over the ranks: one flat float32
        buffer and one all-reduce per group. ``metrics`` (0-d tensors) ride
        in the last buffer -> their means over the ranks."""
        groups = [[p for p in params if p.grad is not None] for params in param_groups]
        out = []
        for i, params in enumerate(groups):
            extra = [m.reshape(1).float() for m in metrics] if i == len(groups) - 1 else []
            flat = torch.cat([p.grad.reshape(-1).float() for p in params] + extra)
            dist.all_reduce(flat)
            flat /= self.world
            offset = 0
            for p in params:
                n = p.grad.numel()
                p.grad.copy_(flat[offset : offset + n].view_as(p.grad))
                offset += n
            out = list(flat[offset:].unbind(0)) if extra else out
        return out

    def all_reduce_sum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of ``x`` over the ranks (a new tensor, no gradient)."""
        x = x.detach().clone()
        dist.all_reduce(x)
        return x

    def all_gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's ``x`` concatenated along dim 0, in rank order."""
        x = x.detach().contiguous()
        parts = [torch.empty_like(x) for _ in range(self.world)]
        dist.all_gather(parts, x)
        return torch.cat(parts)

    def broadcast_(self, tensors) -> None:
        """Overwrite each tensor with rank 0's, in place (tensors on the
        CPU travel through the card under NCCL)."""
        for t in tensors:
            if t.device == self.device or self.device.type == "cpu":
                dist.broadcast(t, 0)
            else:
                tmp = t.to(self.device)
                dist.broadcast(tmp, 0)
                t.copy_(tmp)

    def any(self, flag: bool) -> bool:
        """True on every rank when ``flag`` is true on any (host side)."""
        t = torch.tensor([int(flag)], dtype=torch.int32)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.control)
        return bool(t.item())

    def barrier(self) -> None:
        """Wait for every rank (host side, the control group's timeout)."""
        dist.barrier(group=self.control)

    def close(self) -> None:
        if self.control is not None:
            dist.destroy_process_group(self.control)
            self.control = None


def make_group(device: torch.device, timeout: datetime.timedelta | None = None) -> DataParallel:
    """The ``DataParallel`` of this process in the initialised default
    group (``make_mesh``'s counterpart): its world, rank and ``device``,
    and a gloo control group over the same ranks."""
    if not dist.is_initialized():
        msg = "torch.distributed is not initialised (parallel.distributed.ensure_initialized)"
        raise RuntimeError(msg)
    kwargs = {} if timeout is None else {"timeout": timeout}
    control = dist.new_group(backend="gloo", **kwargs)
    return DataParallel(dist.get_world_size(), dist.get_rank(), device, control)


def shard_batch(group: DataParallel | None, batch: torch.Tensor) -> torch.Tensor:
    """This rank's rows of a global batch (the batch itself without a group)."""
    return batch if group is None else group.shard(batch)


def _state_tensors(state) -> list[torch.Tensor]:
    """Every tensor of a ``TrainState``: the four networks' parameters (and
    the EMA generator's), the Adams' states, ADA and the replay buffer."""
    modules = [state.generator, state.mapping, state.discriminator, state.extractor]
    if state.ema_generator is not None:
        modules.append(state.ema_generator)
    out = [t for m in modules for t in (*m.parameters(), *m.buffers())]
    for opt in (state.opt_d, state.opt_g, state.opt_m, state.opt_s):
        for p in (p for g in opt.param_groups for p in g["params"]):
            out += [v for _, v in sorted(opt.state.get(p, {}).items()) if torch.is_tensor(v)]
    out += [*state.ada, state.buffer.images, state.buffer.count]
    return out


@torch.no_grad()
def replicate(group: DataParallel | None, state) -> None:
    """Make every rank's ``TrainState`` rank 0's, in place: parameters,
    Adam states, EMA, ADA and the buffer. All ranks must hold the same
    structure (the same config; Adam's states made on all or on none)."""
    if group is None:
        return
    group.broadcast_(_state_tensors(state))
