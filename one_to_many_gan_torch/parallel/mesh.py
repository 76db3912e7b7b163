"""The ("data", "spatial") group: what one rank knows of the others.

The JAX package writes its step on global arrays over a ("data",
"spatial") mesh, and XLA inserts the collectives (its
``parallel/mesh.py``). Here the same program runs in every rank and the
step calls the collectives itself, through ``DataParallel``. Its ranks
form JAX's grid: rank ``d * S + s`` is data row ``d`` and spatial column
``s`` of ``D`` data rows and ``S`` spatial columns (``spatial`` = 1: data
parallelism alone). A rank holds data row ``d``'s rows of the global
batch and, with ``S`` > 1, band ``s`` of the rows of each image
(``parallel/halo.py``), which the ``S`` ranks of its spatial subgroup
(those that share ``d``) split between them:

- ``rows`` / ``shard``: this data row's contiguous rows of a global batch
  (``shard_batch``'s counterpart; the interleaved packing of
  ``core/train_step.batch_pack`` keeps a rank's packed rows contiguous);
- ``reduce_gradients``: each optimiser's gradients summed over the
  spatial subgroup (each band's gradient is a part of its samples') and
  averaged over the data rows, in one flat buffer and one all-reduce over
  the world per optimiser, with a few scalar metrics riding in the last
  buffer;
- ``all_reduce_sum``: a global sum (the KL loss's moments);
- ``all_gather_rows``: every data row's rows, in order, over the data
  subgroup (the ranks that share ``s``: the replay buffer's fakes);
- ``spatial``: the spatial subgroup (``halo.Spatial``; None for ``S`` =
  1), which carries the halos, the instance norms' statistics and the
  losses' sums;
- ``replicate``: rank 0's state broadcast to every rank once at start
  (``replicate``'s counterpart; JAX assumes the copies equal, the
  broadcast makes them so);
- ``any`` / ``gather_int`` / ``barrier``: host-side agreement on a flag
  (SIGTERM), every rank's view of a number (the resumed step) and a
  meeting point (rank 0 evaluating), on a gloo group of their own, so
  that none waits for the card.

With ``S`` = 1 the group is bitwise the data-parallel group it was
before the spatial axis: no subgroup is made.

Across nodes, torchrun numbers the ranks node by node, so a spatial
subgroup (``S`` consecutive ranks), whose halo exchanges are many and
small, stays within one node whenever ``S`` divides the ranks of a node;
otherwise ``make_group`` warns once, naming the subgroups that cross.
Each data row's rows of the batch are read by its own ranks, so the data
needs nothing per node.
"""

from __future__ import annotations

import datetime
import os
import warnings

import torch
import torch.distributed as dist

from one_to_many_gan_torch.parallel.halo import Spatial
from one_to_many_gan_torch.utils.profiling import span


class DataParallel:
    """One rank of a ("data", "spatial") process group (``world`` ranks,
    this one ``rank``, its tensors on ``device``; ``spatial`` ranks to a
    data row). ``control`` is a gloo group of the same ranks for host-side
    flags and barriers; ``data_pg`` the process group of this rank's data
    subgroup and ``spatial_pg`` of its spatial subgroup (both None for
    ``spatial`` = 1: the default group is the data subgroup)."""

    def __init__(self, world: int, rank: int, device: torch.device, control=None, *,
                 spatial: int = 1, data_pg=None, spatial_pg=None):
        if spatial < 1 or world % spatial:
            msg = f"spatial={spatial} must divide the {world} ranks"
            raise ValueError(msg)
        self.world = world
        self.rank = rank
        self.device = device
        self.control = control
        self.data_ranks = world // spatial
        self.data_index = rank // spatial
        self.data_pg = data_pg
        self.spatial = None
        if spatial > 1:
            row = self.data_index * spatial
            self.spatial = Spatial(spatial, rank % spatial, range(row, row + spatial), spatial_pg)

    def __repr__(self) -> str:
        return (f"DataParallel(world={self.world}, rank={self.rank}, "
                f"spatial={self.spatial_ranks}, device={self.device})")

    @property
    def spatial_ranks(self) -> int:
        return 1 if self.spatial is None else self.spatial.size

    @property
    def is_main(self) -> bool:
        """Rank 0: the one that writes logs, grids, evaluation and checkpoints."""
        return self.rank == 0

    def rows(self, n: int) -> slice:
        """This rank's data row's rows of a global leading dimension ``n``."""
        if n % self.data_ranks:
            msg = f"{n} rows do not split over {self.data_ranks} ranks"
            raise ValueError(msg)
        local = n // self.data_ranks
        return slice(self.data_index * local, (self.data_index + 1) * local)

    def shard(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows of ``x`` (a view)."""
        return x[self.rows(x.shape[0])]

    def reduce_gradients(self, param_groups, metrics: list[torch.Tensor] = ()) -> list[torch.Tensor]:
        """Replace the ``.grad`` of every parameter of ``param_groups`` (one
        list per optimiser) by its sum over the spatial subgroup, averaged
        over the data rows: one flat float32 buffer and one all-reduce over
        the world per group. ``metrics`` (0-d tensors, the same on every
        rank of a spatial subgroup, so taken at ``1 / S`` each) ride in the
        last buffer -> their means over the data rows. Each group's
        exchange is an ``otm.train.exchange`` span."""
        groups = [[p for p in params if p.grad is not None] for params in param_groups]
        out = []
        s = self.spatial_ranks
        for i, params in enumerate(groups):
            extra = []
            if i == len(groups) - 1:
                extra = [m.reshape(1).float() / s if s > 1 else m.reshape(1).float()
                         for m in metrics]
            with span("otm.train.exchange"):
                flat = torch.cat([p.grad.reshape(-1).float() for p in params] + extra)
                dist.all_reduce(flat)
                flat /= self.data_ranks
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
        """Every data row's ``x`` concatenated along dim 0, in order (over
        the data subgroup)."""
        x = x.detach().contiguous()
        parts = [torch.empty_like(x) for _ in range(self.data_ranks)]
        dist.all_gather(parts, x, group=self.data_pg)
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

    def gather_int(self, value: int) -> list[int]:
        """Every rank's ``value``, in rank order (host side)."""
        parts = [torch.zeros(1, dtype=torch.int64) for _ in range(self.world)]
        dist.all_gather(parts, torch.tensor([value], dtype=torch.int64), group=self.control)
        return [int(p.item()) for p in parts]

    def barrier(self) -> None:
        """Wait for every rank (host side, the control group's timeout)."""
        dist.barrier(group=self.control)

    def close(self) -> None:
        if self.control is not None:
            dist.destroy_process_group(self.control)
            self.control = None


def crossing_subgroups(world: int, spatial: int, local_world: int) -> list[list[int]]:
    """The spatial subgroups (ranks ``d * S .. d * S + S - 1``) that span
    more than one node when torchrun numbers the ranks node by node,
    ``local_world`` to a node: none when ``spatial`` divides
    ``local_world``."""
    return [list(range(d, d + spatial)) for d in range(0, world, spatial)
            if d // local_world != (d + spatial - 1) // local_world]


def _warn_crossing_nodes(world: int, spatial: int) -> None:
    """Under torchrun, one warning naming the spatial subgroups whose halo
    exchanges cross nodes (the layout still runs, as JAX's mesh does)."""
    local = os.environ.get("LOCAL_WORLD_SIZE")
    crossing = crossing_subgroups(world, spatial, int(local)) if local else []
    if crossing:
        warnings.warn(f"tpu.spatial_parallel={spatial} does not divide the {local} ranks of a "
                      f"node: the spatial subgroups {crossing} span nodes, and their halo "
                      "exchanges cross the network", stacklevel=3)


def make_group(device: torch.device, timeout: datetime.timedelta | None = None,
               spatial: int = 1) -> DataParallel:
    """The ``DataParallel`` of this process in the initialised default
    group (``make_mesh``'s counterpart): its world, rank and ``device``, a
    gloo control group over the same ranks and, for ``spatial`` > 1, its
    data and spatial subgroups (every rank makes every subgroup, in one
    order, then joins its own two once so that their communicators exist
    before the first exchange)."""
    if not dist.is_initialized():
        msg = "torch.distributed is not initialised (parallel.distributed.ensure_initialized)"
        raise RuntimeError(msg)
    kwargs = {} if timeout is None else {"timeout": timeout}
    control = dist.new_group(backend="gloo", **kwargs)
    world, rank = dist.get_world_size(), dist.get_rank()
    if spatial == 1:
        return DataParallel(world, rank, device, control)
    if world % spatial:
        msg = f"tpu.spatial_parallel={spatial} must divide the {world} ranks"
        raise ValueError(msg)
    if rank == 0:
        _warn_crossing_nodes(world, spatial)
    data_pgs = [dist.new_group(list(range(s, world, spatial)), **kwargs) for s in range(spatial)]
    spatial_pgs = [dist.new_group(list(range(d, d + spatial)), **kwargs)
                   for d in range(0, world, spatial)]
    data_pg, spatial_pg = data_pgs[rank % spatial], spatial_pgs[rank // spatial]
    for pg in (data_pg, spatial_pg):
        dist.all_reduce(torch.zeros(1, device=device), group=pg)
    return DataParallel(world, rank, device, control, spatial=spatial, data_pg=data_pg,
                        spatial_pg=spatial_pg)


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
