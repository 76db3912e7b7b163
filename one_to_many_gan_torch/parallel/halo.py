"""The spatial axis: image rows split into bands over a spatial subgroup.

The JAX package shards the height of every image tensor over its mesh's
"spatial" axis and lets XLA insert the halo exchanges and the cross-shard
reductions (its ``parallel/mesh.py``). Here each rank of a spatial
subgroup of ``S`` ranks holds one band of rows of every feature map, and
the layers call the exchanges themselves while a ``Spatial`` is current
(``banded``):

- ``band``: the one rule that gives band ``s`` of ``n`` rows,
  ``[s * n // S, (s + 1) * n // S)``. A layer's output band comes from
  the rule at its output height, and its input rows from the output band
  (``window``); a band may be empty where a map has fewer rows than
  ranks.
- ``fetch``: global rows ``[lo, hi)`` of a banded map, from whichever
  ranks hold them (point-to-point, ``batch_isend_irecv``: NCCL on the
  card, gloo on the CPU). Its backward is the transposed exchange, each
  fetched row's gradient added onto its owner's row in rank order; each of
  the two ``autograd.Function``s is the other's backward, so a double
  backward (R1) passes through.
- ``all_reduce``: a differentiable sum over the subgroup whose backward is
  the same sum (the transpose of a sum that every rank receives);
  ``mean`` reduces over a band's rows with it.
- ``gather_whole``, ``on_whole``: whole maps on every rank (and back to
  the band), for the replay buffer and the ADA warp, which needs whole
  rows; ``take_band``: a rank's band of a map it holds whole (the
  inputs).
- ``share``: the loss that a rank differentiates, ``1 / S`` of the
  value that every rank of the subgroup holds, so that the gradients of
  the ranks of one subgroup sum to the sample's
  (``DataParallel.reduce_gradients``).

Outside ``banded`` every function here is the identity or the plain
reduction, so a model runs as on one process.
"""

from __future__ import annotations

import contextlib
from collections.abc import Callable, Iterator, Sequence
from typing import NamedTuple

import torch
import torch.distributed as dist

Rows = tuple[int, int]


def band(n: int, parts: int, index: int) -> Rows:
    """Rows ``[lo, hi)`` of band ``index`` of ``n`` rows split ``parts`` ways."""
    return index * n // parts, (index + 1) * n // parts


class Spatial:
    """One rank's spatial subgroup: ``size`` ranks holding the bands in
    order (global ranks ``ranks``), this one band ``index``, their process
    group ``pg`` (None: the default group)."""

    def __init__(self, size: int, index: int, ranks: Sequence[int], pg=None):
        self.size = size
        self.index = index
        self.ranks = list(ranks)
        self.pg = pg
        # a list to record what the exchanges move (tests, smoke runs set it):
        # (kind, shape, bytes) of each piece sent and each all-gather
        self.log: list[tuple[str, tuple[int, ...], int]] | None = None

    def note(self, kind: str, t: torch.Tensor) -> None:
        if self.log is not None:
            self.log.append((kind, tuple(t.shape), t.numel() * t.element_size()))

    def __repr__(self) -> str:
        return f"Spatial(size={self.size}, index={self.index}, ranks={self.ranks})"

    def band(self, n: int, index: int | None = None) -> Rows:
        return band(n, self.size, self.index if index is None else index)

    def bands(self, n: int) -> list[Rows]:
        return [band(n, self.size, t) for t in range(self.size)]


_current: Spatial | None = None


@contextlib.contextmanager
def banded(sp: Spatial | None) -> Iterator[Spatial | None]:
    """Run the layers inside the block on bands of ``sp`` (nothing changes
    for None)."""
    global _current
    outer = _current
    if sp is not None:
        _current = sp
    try:
        yield sp
    finally:
        _current = outer


def current() -> Spatial | None:
    return _current


# ---------------------------------------------------------------- exchange


def _exchange(sp: Spatial, sends: dict[int, torch.Tensor], recvs: dict[int, torch.Tensor],
              kind: str) -> None:
    """Post every send and receive of one exchange together, wait for all."""
    ops = []
    for t in range(sp.size):
        if t in sends:
            ops.append(dist.P2POp(dist.isend, sends[t], sp.ranks[t], sp.pg))
            sp.note(kind, sends[t])
        if t in recvs:
            ops.append(dist.P2POp(dist.irecv, recvs[t], sp.ranks[t], sp.pg))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()


def _overlap(a: Rows, b: Rows) -> Rows | None:
    lo, hi = max(a[0], b[0]), min(a[1], b[1])
    return (lo, hi) if lo < hi else None


def _rows_of(x: torch.Tensor, dim: int, lo: int, hi: int) -> torch.Tensor:
    return x.narrow(dim, lo, hi - lo)


class _Fetch(torch.autograd.Function):
    """Band of ``n`` rows (along ``dim``) -> the global rows ``needs[s]``
    of this rank ``s``; ``needs`` holds every rank's, clipped to ``[0, n)``."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, sp: Spatial, n: int, needs: tuple, dim: int):
        ctx.args = (sp, n, needs, dim)
        owned = sp.bands(n)
        s = sp.index
        lo0 = owned[s][0]
        sends, recvs = {}, {}
        for t in range(sp.size):
            if t == s:
                continue
            out = _overlap(owned[s], needs[t])
            if out is not None:
                sends[t] = _rows_of(x, dim, out[0] - lo0, out[1] - lo0).contiguous()
            into = _overlap(owned[t], needs[s])
            if into is not None:
                shape = list(x.shape)
                shape[dim] = into[1] - into[0]
                recvs[t] = x.new_empty(shape)
        _exchange(sp, sends, recvs, "halo")
        parts = []
        for t in range(sp.size):
            if t == s:
                mine = _overlap(owned[s], needs[s])
                if mine is not None:
                    parts.append(_rows_of(x, dim, mine[0] - lo0, mine[1] - lo0))
            elif t in recvs:
                parts.append(recvs[t])
        if not parts:
            return _rows_of(x, dim, 0, 0).clone()
        return parts[0].clone() if len(parts) == 1 else torch.cat(parts, dim)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return _Return.apply(g, *ctx.args), None, None, None, None


class _Return(torch.autograd.Function):
    """The transpose of ``_Fetch``: the gradient of fetched rows ``g`` ->
    the gradient of this rank's band, each row's contributions added in
    rank order."""

    @staticmethod
    def forward(ctx, g: torch.Tensor, sp: Spatial, n: int, needs: tuple, dim: int):
        ctx.args = (sp, n, needs, dim)
        owned = sp.bands(n)
        s = sp.index
        lo0, hi0 = owned[s]
        nlo = needs[s][0]
        sends, recvs = {}, {}
        for t in range(sp.size):
            if t == s:
                continue
            into = _overlap(owned[t], needs[s])
            if into is not None:
                sends[t] = _rows_of(g, dim, into[0] - nlo, into[1] - nlo).contiguous()
            out = _overlap(owned[s], needs[t])
            if out is not None:
                shape = list(g.shape)
                shape[dim] = out[1] - out[0]
                recvs[t] = g.new_empty(shape)
        _exchange(sp, sends, recvs, "halo_t")
        shape = list(g.shape)
        shape[dim] = hi0 - lo0
        gx = g.new_zeros(shape)
        for t in range(sp.size):
            if t == s:
                mine = _overlap(owned[s], needs[s])
                if mine is None:
                    continue
                part = _rows_of(g, dim, mine[0] - nlo, mine[1] - nlo)
                rows = mine
            elif t in recvs:
                part, rows = recvs[t], _overlap(owned[s], needs[t])
            else:
                continue
            _rows_of(gx, dim, rows[0] - lo0, rows[1] - lo0).add_(part)
        return gx

    @staticmethod
    def backward(ctx, gg: torch.Tensor):
        return _Fetch.apply(gg, *ctx.args), None, None, None, None


def _clip(rows: Rows, n: int) -> Rows:
    lo = min(max(rows[0], 0), n)
    return lo, max(min(rows[1], n), lo)


def fetch(x: torch.Tensor, n: int, needs: Sequence[Rows], dim: int = 2) -> torch.Tensor:
    """This rank's band ``x`` of a map of ``n`` rows along ``dim`` -> its
    global rows ``needs[index]`` (``needs``: every rank's wanted rows, in
    band order, clipped to ``[0, n)``). Every rank of the subgroup calls
    it together."""
    return _Fetch.apply(x, _current, n, tuple(_clip(r, n) for r in needs), dim)


def pad_rows(x: torch.Tensor, top: int, bottom: int, mode: str) -> torch.Tensor:
    """Pad dim 2 (H) of NCHW rows at the true border: ``zero``,
    ``reflect`` or ``replicate`` (``ops/pad.py``: a deterministic
    backward)."""
    if top == 0 and bottom == 0:
        return x
    if mode == "zero":
        return torch.nn.functional.pad(x, (0, 0, top, bottom))
    from one_to_many_gan_torch.ops.pad import pad

    return pad(x, (0, 0, top, bottom), mode)


class Window(NamedTuple):
    """What ``window`` gives a banded layer: ``rows``, the input rows that
    output rows ``span`` read (H padded where they run past the map), and
    ``keep``, how many of those output rows are this rank's band."""

    rows: torch.Tensor
    span: Rows
    keep: int


def window(x: torch.Tensor, n: int, n_out: int, reads: Callable[[int, int], Rows],
           mode: str) -> Window:
    """The rows of a map of ``n`` rows (NCHW, banded along H) that this
    rank's band ``[lo, hi)`` of a layer's ``n_out`` output rows reads,
    ``reads(lo, hi)`` (global, unclipped), fetched from the other bands and
    padded by ``mode`` where they run past the map (its true top and
    bottom). An empty band reads nothing, and computes output row 0 from
    zeros (``span`` (0, 1), ``keep`` 0): every rank then runs the same ops
    and saves the same tensors, so that the exchanges of the backward and
    of a rematerialised forward (``ops/remat.py``) come in the same order
    on every rank."""
    sp = _current
    wanted = [reads(lo, hi) if lo < hi else (0, 0) for lo, hi in sp.bands(n_out)]
    rows = fetch(x, n, wanted)
    lo, hi = sp.band(n_out)
    if lo == hi:
        a, b = reads(0, 1)
        return Window(pad_rows(rows, 0, b - a, "zero"), (0, 1), 0)
    a, b = wanted[sp.index]
    return Window(pad_rows(rows, max(0, -a), max(0, b - n), mode), (lo, hi), hi - lo)


# -------------------------------------------------------------- reductions


class _AllReduce(torch.autograd.Function):
    """The sum over the subgroup, on every rank; its backward is the same
    sum of the gradients (a sum received by every rank transposes to one)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, sp: Spatial):
        ctx.sp = sp
        out = x.contiguous().clone()
        dist.all_reduce(out, group=sp.pg)
        return out

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return _AllReduce.apply(g, ctx.sp), None


def all_reduce(x: torch.Tensor, sp: Spatial | None = None) -> torch.Tensor:
    """Differentiable sum of ``x`` over ``sp`` (default: the current
    subgroup; ``x`` itself outside ``banded``)."""
    sp = _current if sp is None else sp
    return x if sp is None else _AllReduce.apply(x, sp)


def mean(x: torch.Tensor, dims: Sequence[int] | None = None) -> torch.Tensor:
    """``x.mean(dims)`` (every dim for None; ``dims`` must hold the row
    dim) over the whole map: the bands' sums and element counts summed over
    the subgroup in one all-reduce, the sum divided by the count (a float of
    the sum's dtype, exact below 2^24 in float32)."""
    if _current is None:
        return x.mean() if dims is None else x.mean(dim=tuple(dims))
    dims = tuple(range(x.dim()) if dims is None else dims)
    total = x.sum(dim=dims)
    count = 1
    for d in dims:
        count *= x.shape[d]
    flat = all_reduce(torch.cat([total.reshape(-1), total.new_full((1,), float(count))]))
    return flat[:-1].reshape(total.shape) / flat[-1]


class _ScaleGrad(torch.autograd.Function):
    """Identity forward; the gradient times ``factor`` backward."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, factor: float):
        ctx.factor = factor
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return g * ctx.factor, None


def scale_grad(x: torch.Tensor, factor: float) -> torch.Tensor:
    """``x``, whose gradient is ``factor`` times its own."""
    return _ScaleGrad.apply(x, factor)


def share(loss: torch.Tensor) -> torch.Tensor:
    """``loss`` (the same on every rank of the subgroup), whose gradient is
    ``1 / S`` of its own: the ranks' gradients then sum to the loss's."""
    return loss if _current is None else _ScaleGrad.apply(loss, 1.0 / _current.size)


# ------------------------------------------------------------ whole maps


def _gather(x: torch.Tensor, sp: Spatial, n: int, dim: int, kind: str) -> torch.Tensor:
    """Every rank's band of ``n`` rows along ``dim`` -> the whole map: one
    all-gather of the bands padded to the longest."""
    owned = sp.bands(n)
    longest = max(hi - lo for lo, hi in owned)
    shape = list(x.shape)
    shape[dim] = longest
    mine = x.new_zeros(shape)
    _rows_of(mine, dim, 0, x.shape[dim]).copy_(x)
    out = x.new_empty([sp.size * shape[0], *shape[1:]])
    dist.all_gather_into_tensor(out, mine, group=sp.pg)
    out = out.view(sp.size, *shape)
    sp.note(kind, out)
    parts = [_rows_of(out[t], dim, 0, hi - lo) for t, (lo, hi) in enumerate(owned)]
    return torch.cat(parts, dim)


class _GatherWhole(torch.autograd.Function):
    """Band -> whole map, the same on every rank; backward: this rank's
    band of the whole map's gradient, which every rank holds whole
    (``_KeepBand``'s backward makes it so)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, sp: Spatial, n: int, dim: int, kind: str):
        ctx.args = (sp, n, dim, kind)
        return _gather(x, sp, n, dim, kind)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return _KeepBand.apply(g, *ctx.args), None, None, None, None


class _KeepBand(torch.autograd.Function):
    """Whole map -> this rank's band; backward: every rank's band
    gradient gathered, the whole map's gradient on every rank."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, sp: Spatial, n: int, dim: int, kind: str):
        ctx.args = (sp, n, dim, kind)
        lo, hi = sp.band(n)
        return _rows_of(x, dim, lo, hi).clone()

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return _GatherWhole.apply(g, *ctx.args), None, None, None, None


def gather_whole(x: torch.Tensor, n: int, dim: int = 2, kind: str = "whole") -> torch.Tensor:
    """The whole map of ``n`` rows along ``dim`` from every rank's band, on
    every rank (the map itself outside ``banded``)."""
    return x if _current is None else _GatherWhole.apply(x, _current, n, dim, kind)


def take_band(x: torch.Tensor, dim: int = 2) -> torch.Tensor:
    """This rank's band of a map every rank holds whole, as a plain slice
    (inputs: no exchange in either direction)."""
    if _current is None:
        return x
    lo, hi = _current.band(x.shape[dim])
    return _rows_of(x, dim, lo, hi)


def on_whole(fn: Callable[[torch.Tensor], torch.Tensor], x: torch.Tensor, n: int,
             dim: int = 2, kind: str = "whole") -> torch.Tensor:
    """``fn`` of the whole map on every rank, of which this rank keeps its
    band: the ADA pipeline, whose warp needs whole rows. ``fn`` must hold
    no parameters (its gradient runs on the whole cotangent, the same on
    every rank). Outside ``banded``, ``fn(x)``."""
    if _current is None:
        return fn(x)
    whole = _GatherWhole.apply(x, _current, n, dim, kind)
    return _KeepBand.apply(fn(whole), _current, n, dim, kind)
