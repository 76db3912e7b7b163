"""Device-resident image replay buffer (CycleGAN-style).

Per image, sequentially over the batch: while the buffer is not full,
store the image and pass it through; once it is full, with probability
0.5 return a randomly stored image and put the new one in its slot, else
pass the new image through. The draws are injected (``BufferDraws``: the
JAX package's ``uniform(k1, (B,))`` swap draws and
``randint(k2, (B,), 0, size)`` slot draws), so a slot drawn twice in one
batch swaps twice, in batch order, as in the JAX ``fori_loop``.

The loop runs on the device with index tensors (``index_select`` and
``index_copy_``: no host round trip). It updates ``state.images`` in
place, which saves a copy of the buffer per image; the returned state
holds the same tensor.

Under data parallelism (a ``parallel.DataParallel`` group) every rank
all-gathers the fakes once, runs the same sequential loop over the global
batch with the global draws, and keeps its own rows of the output, so
the buffer state stays identical on every rank (the JAX package gathers
the fakes once and reslices the output, its ``core/buffer.py``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class BufferState(NamedTuple):
    images: torch.Tensor  # [size, H, W, C] float32
    count: torch.Tensor  # int32: slots filled


class BufferDraws(NamedTuple):
    swap: torch.Tensor  # [B] uniform [0, 1): swap when > 0.5
    slot: torch.Tensor  # [B] integers in [0, size)


def init_buffer(
    size: int, image_shape: tuple[int, int, int], device: str | torch.device = "cpu"
) -> BufferState:
    if size < 1:
        msg = "buffer size must be >= 1"
        raise ValueError(msg)
    return BufferState(
        images=torch.zeros((size, *image_shape), dtype=torch.float32, device=device),
        count=torch.zeros((), dtype=torch.int32, device=device),
    )


def draw_buffer(generator: torch.Generator, b: int, size: int, device) -> BufferDraws:
    return BufferDraws(
        swap=torch.rand((b,), generator=generator, device=device),
        slot=torch.randint(0, size, (b,), generator=generator, device=device),
    )


def buffer_apply(
    state: BufferState, fakes: torch.Tensor, draws: BufferDraws, group=None
) -> tuple[torch.Tensor, BufferState]:
    """Push a batch of fakes [B, H, W, C] (no gradient); -> (the batch to
    train D on, the updated buffer). With ``group``, ``fakes`` are this
    rank's rows, ``draws`` the global batch's, and the output this rank's
    rows."""
    if group is not None:
        fakes = group.all_gather_rows(fakes)
    size = state.images.shape[0]
    images, count = state.images, state.count
    out = torch.empty_like(fakes)
    for i in range(fakes.shape[0]):
        img = fakes[i]
        not_full = count < size
        slot = draws.slot[i : i + 1].long()
        old = images.index_select(0, slot)[0]
        use_swap = ~not_full & (draws.swap[i] > 0.5)
        out[i] = torch.where(use_swap, old, img)
        write_idx = torch.where(not_full, count.long(), slot)
        images.index_copy_(0, write_idx.view(1), torch.where(not_full | use_swap, img, old)[None])
        count = torch.where(not_full, count + 1, count)
    if group is not None:
        out = group.shard(out)
    return out, BufferState(images=images, count=count)
