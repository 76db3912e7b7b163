"""Batch pipeline: infinite, shuffled, per-host-sharded iterators.

The JAX package's ``data/pipeline.py``, copied: epoch permutations from
``default_rng(seed + host_id)`` with drop-last, a per-sample horizontal
flip with probability ``flip_prob``, each host taking every
``host_count``-th image of an epoch, and ``skip(n)`` to fast-forward a
resumed run. ``rows`` makes a data-parallel rank gather only its rows of
each batch, from the same stream (the same permutations and flip draws)
as the whole batch's. The same seed gives the same batches, byte for byte, as
the JAX package's iterator. With ``native=True`` float batches come from
the C++ assembler (``native.assemble_batch``), as in the JAX package,
whose iterator quietly turns it off where the library is missing; this
one raises.
"""

from __future__ import annotations

import numpy as np

from one_to_many_gan_torch.data import native as native_lib


def normalize_u8(batch_u8: np.ndarray) -> np.ndarray:
    """uint8 [0,255] -> float32 [-1, 1] (ToTensor + Normalize((0.5,),(0.5,)))."""
    return batch_u8.astype(np.float32) / 127.5 - 1.0


class BatchIterator:
    """Infinite iterator over a uint8 image array.

    Args:
        images: [N, H, W, C] uint8.
        batch_size: per-host batch size.
        shuffle: epoch-permutation shuffling (training) or sequential (val).
        flip_prob: per-sample horizontal flip probability.
        seed: RNG seed (deterministic stream).
        host_id/host_count: this process's shard of each epoch.
        native: float batches from the C++ assembler (uint8 batches take
            the numpy gather either way).
        as_float: normalised float32 batches; False gives flipped uint8
            batches, which the trainer moves to the device (4x fewer
            bytes) and normalises there.
        rows: a slice: gather only those rows of each batch (a
            data-parallel rank's, ``DataParallel.rows``); the stream is the
            whole batch's.
    """

    def __init__(
        self,
        images: np.ndarray,
        batch_size: int,
        *,
        shuffle: bool = True,
        flip_prob: float = 0.5,
        seed: int = 0,
        host_id: int = 0,
        host_count: int = 1,
        native: bool = False,
        as_float: bool = True,
        rows: slice | None = None,
    ):
        if images.ndim != 4:
            msg = f"expected [N,H,W,C], got {images.shape}"
            raise ValueError(msg)
        if native:
            native_lib.library()  # raises here where it cannot be built
        self.native = native
        self.images = images
        self.batch_size = batch_size
        self.as_float = as_float
        self.shuffle = shuffle
        self.flip_prob = flip_prob
        self.host_id = host_id
        self.host_count = host_count
        if rows is not None and not 0 <= rows.start < rows.stop <= batch_size:
            msg = f"rows {rows} are not a range of a batch of {batch_size}"
            raise ValueError(msg)
        self.rows = rows
        self._rng = np.random.default_rng(seed + host_id)
        self._queue: list[np.ndarray] = []
        n_local = len(self._epoch_order())
        if n_local < batch_size:
            msg = (
                f"dataset shard has {n_local} images < batch size {batch_size} "
                "(drop_last would yield nothing)"
            )
            raise ValueError(msg)

    def _epoch_order(self) -> np.ndarray:
        n = self.images.shape[0]
        order = self._rng.permutation(n) if self.shuffle else np.arange(n)
        return order[self.host_id :: self.host_count]

    def _next_indices(self) -> np.ndarray:
        """Pop the next batch's indices, refilling the epoch queue as needed."""
        if not self._queue:
            order = self._epoch_order()
            n_batches = len(order) // self.batch_size  # drop_last
            for b in range(n_batches):
                self._queue.append(order[b * self.batch_size : (b + 1) * self.batch_size])
        return self._queue.pop(0)

    def skip(self, n: int) -> None:
        """Advance the stream by ``n`` batches without gathering them: the
        RNG draws of ``n`` ``__next__`` calls (epoch permutations and flip
        draws) and nothing else, so the stream then continues exactly as
        if ``n`` batches had been taken."""
        for _ in range(n):
            idx = self._next_indices()
            if self.flip_prob > 0:
                self._rng.random(len(idx))

    def __iter__(self):
        return self

    def __next__(self) -> np.ndarray:
        idx = self._next_indices()
        flips = (
            self._rng.random(len(idx)) < self.flip_prob
            if self.flip_prob > 0
            else np.zeros(len(idx), dtype=bool)
        )
        if self.rows is not None:
            idx, flips = idx[self.rows], flips[self.rows]
        if self.native and self.as_float:
            return native_lib.assemble_batch(self.images, idx, flips)
        batch = self.images[idx]  # gather, uint8
        if flips.any():
            batch = batch.copy()
            batch[flips] = batch[flips, :, ::-1]
        if not self.as_float:
            return batch
        return normalize_u8(batch)
