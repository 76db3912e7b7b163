"""The native host image loader: ctypes over ``csrc/loader.cpp``.

The JAX package's ``runtime/`` on the port: ``load_images`` decodes
(libjpeg, libpng), converts to grayscale or RGB and resizes (bilinear,
torch's half-pixel convention) a list of files into one [N, H, W, C]
uint8 array on a pool of threads; ``assemble_batch`` gathers a batch by
index, flips it and normalises it to float32 [-1, 1] as ``x * (1 /
127.5) - 1``, which is not always ``normalize_u8``'s ``x / 127.5 - 1``:
the two differ by one float32 ulp at 111 of the 256 levels, as in the
JAX package.

The library is built at first use by ``ops/cuda/build.py`` with ``g++``
into the git-ignored ``build/kernels/``, never into the source tree.
There is no fallback: without a compiler or without the libjpeg and
libpng headers every call raises with the compiler's message (the JAX
package falls back to PIL and numpy there, and ``ShoeDataset(native=True)``
decodes differently from PIL when it resizes).
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from one_to_many_gan_torch.ops.cuda import build

_U8 = ctypes.POINTER(ctypes.c_uint8)


def library() -> ctypes.CDLL:
    """The loaded library, built first if needed; raises with the
    compiler's message where it cannot be built."""
    lib = build.load("loader")
    lib.otm_load_images.restype = ctypes.c_int
    lib.otm_load_images.argtypes = [ctypes.POINTER(ctypes.c_char_p), *[ctypes.c_int] * 5,
                                    _U8, _U8]
    lib.otm_assemble_batch.restype = None
    lib.otm_assemble_batch.argtypes = [_U8, ctypes.POINTER(ctypes.c_int64),
                                       *[ctypes.c_int] * 4, _U8,
                                       ctypes.POINTER(ctypes.c_float)]
    return lib


def available() -> str | None:
    """None when the loader builds and loads here, else why it does not
    (the compiler's message)."""
    try:
        library()
    except (RuntimeError, OSError) as e:
        return str(e)
    return None


def load_images(
    paths: list[str | os.PathLike],
    image_size: tuple[int, int],
    channels: int,
    threads: int | None = None,
) -> np.ndarray:
    """Decode and resize images in parallel -> [N, H, W, C] uint8. Raises
    ``RuntimeError`` naming up to 5 files it could not decode."""
    if channels not in (1, 3):
        msg = f"channels must be 1 or 3, got {channels}"
        raise ValueError(msg)
    lib = library()
    h, w = image_size
    n = len(paths)
    out = np.zeros((n, h, w, channels), dtype=np.uint8)
    ok = np.zeros((n,), dtype=np.uint8)
    arr = (ctypes.c_char_p * n)(*[str(p).encode() for p in paths])
    if threads is None:
        threads = min(8, os.cpu_count() or 1)
    loaded = lib.otm_load_images(arr, n, h, w, channels, threads,
                                 out.ctypes.data_as(_U8), ok.ctypes.data_as(_U8))
    if loaded != n:
        bad = [str(paths[i]) for i in np.nonzero(ok == 0)[0][:5]]
        msg = f"failed to decode {n - loaded}/{n} images, e.g. {bad}"
        raise RuntimeError(msg)
    return out


def assemble_batch(images: np.ndarray, indices: np.ndarray, flips: np.ndarray) -> np.ndarray:
    """Gather ``images[indices]`` (uint8 [N, H, W, C]), flip horizontally
    where ``flips``, normalise -> float32 [B, H, W, C] in [-1, 1]."""
    if images.dtype != np.uint8 or images.ndim != 4:
        msg = f"expected uint8 [N,H,W,C], got {images.dtype} {images.shape}"
        raise ValueError(msg)
    n, h, w, c = images.shape
    idx = np.ascontiguousarray(indices, dtype=np.int64)
    flp = np.ascontiguousarray(flips, dtype=np.uint8)
    b = len(idx)
    if flp.shape != (b,) or (b and (idx.min() < 0 or idx.max() >= n)):
        msg = f"{b} indices in [0, {n}) and as many flips expected, got {indices}, {flips}"
        raise IndexError(msg)
    lib = library()
    out = np.empty((b, h, w, c), dtype=np.float32)
    images = np.ascontiguousarray(images)
    lib.otm_assemble_batch(images.ctypes.data_as(_U8),
                           idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), b, h, w, c,
                           flp.ctypes.data_as(_U8),
                           out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    return out
