"""The yardstick's arithmetic: operations and bytes from shapes.

- ``instance_norm_bytes``: the least the instance norm moves, one read of
  its input and one write of its output (``chip_smoke.py``'s bound for
  the kernel, frozen here).
- ``serve_work``: the model FLOPs of one served image and the instance
  norms' bytes of one encode, counted on the plain reference on the meta
  device (``FlopCounterMode``: two FLOPs a multiply-add of every conv,
  transposed conv and matmul; no elementwise work), never from what the
  program dispatches, so a change to the program leaves them unchanged.
"""

from __future__ import annotations

import math

import torch
from torch.utils.flop_counter import FlopCounterMode

ESIZE = {"float32": 4, "bfloat16": 2}


def instance_norm_bytes(shape: tuple[int, ...], esize: int) -> int:
    return 2 * math.prod(shape) * esize


def _flops(fn) -> int:
    counter = FlopCounterMode(display=False)
    with counter:
        fn()
    return counter.get_total_flops()


def serve_work(ref, config: dict, n: int, batch: int) -> dict:
    """For ``n`` images a request and sources encoded ``batch`` at a time:
    ``flops_per_image`` (the decode of one image, plus one mapping and
    1/n of the source's encode), ``encode_flops``, ``decode_flops`` and
    ``instance_norm_bytes`` of one encode at ``batch`` sources, in the
    configuration's precision."""
    gen, mapping = ref.build(config, "meta")
    c = config["data"]["image_channels"]
    h, w = config["data"]["image_size"]
    w_dim = config["architecture"]["w_dim"]
    x = torch.empty((1, c, h, w), device="meta")
    z = torch.empty((1, w_dim), device="meta")
    latent = gen.encode(x)
    encode = _flops(lambda: gen.encode(x))
    decode = _flops(lambda: gen.decode(latent, z))
    maps = _flops(lambda: mapping(z))
    with ref.in_sites() as sites:
        gen.encode(torch.empty((batch, c, h, w), device="meta"))
    esize = ESIZE[config["tpu"]["precision"]]
    return {
        "flops_per_image": decode + maps + encode / n,
        "encode_flops": encode,
        "decode_flops": decode,
        "instance_norm_bytes": sum(instance_norm_bytes(s, esize) for s, _ in sites),
        "instance_norm_sites": len(sites),
    }
