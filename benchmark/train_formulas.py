"""The yardstick's arithmetic for training: model FLOPs of a trained image.

``flops_per_image``: the FLOPs of one period of ``r1_interval`` steps of
the plain reference (``reference/otm_train.py``) at the config's global
batch, counted on the meta device by ``FlopCounterMode``'s formulas
(applied by a dispatch mode of its own: the counter's module hooks are
refused by R1's ``autograd.grad``): two FLOPs a multiply-add of every
conv, transposed conv and matmul, forward and backward, R1's double
backward included, no elementwise work; over the images the period
trains. The period has one step with R1 and the path term,
``r1_interval / path_interval - 1`` with the path term alone and the
rest with neither. Counted from the reference, never from what the
program dispatches, so a change to the program leaves it unchanged.
"""

from __future__ import annotations

import functools
import json

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from benchmark.reference import otm_train


def draws(config: dict, generator: torch.Generator) -> dict:
    """One step's draws in the layout the reference takes (the program's
    ``StepDraws`` as dicts), host tensors from ``generator``."""
    b = config["training"]["batch_size"]
    w_dim = config["architecture"]["w_dim"]
    size = config["training"]["image_buffer_size"]
    with torch.device("meta"):
        n_blocks = otm_train.Nets(config).g.n_style_blocks

    def u(*shape):
        return torch.rand(shape or (b,), generator=generator)

    def n(*shape):
        return torch.randn(shape or (b,), generator=generator)

    def i(high):
        return torch.randint(0, high, (b,), generator=generator)

    def style():
        return {"z1": n(b, w_dim), "z2": n(b, w_dim), "mix": torch.rand((), generator=generator)
                < config["training"]["style_mixing_prob"],
                "crossover": torch.randint(0, n_blocks, (), generator=generator)}

    def aug():
        names = ("i_xflip u_xflip i_rot90 u_rot90 u_xint u_xint_gate n_scale u_scale u_rot_pre "
                 "u_rot_pre_gate n_aniso u_aniso u_rot_post u_rot_post_gate n_xfrac u_xfrac")
        geom = dict(zip(names.split(), (i(2), u(), i(4), u(), u(b, 2), u(), n(), u(), u(), u(),
                                        n(), u(), u(), u(), n(b, 2), u()), strict=True))
        names = ("n_brightness u_brightness n_contrast u_contrast i_lumaflip u_lumaflip u_hue "
                 "u_hue_gate n_saturation u_saturation")
        color = dict(zip(names.split(), (n(), u(), n(), u(), i(2), u(), u(), u(), n(), u()),
                         strict=True))
        return {"geom": geom, "color": color}

    lo, hi = config["optimisation"]["path_loss_jacobian_granularity"]
    d = {"style": style(), "buffer": {"swap": u(), "slot": torch.randint(0, size, (b,),
                                                                          generator=generator)},
         "aug_fake": aug(), "aug_real": aug()}
    g = {"theta": u(), "fin_diff_h": u() * (hi - lo) + lo, "latent_noise": None,
         "style": style(), "aug": aug(), "path_style": style()}
    return {"d": d, "g": g}


class _Count(TorchDispatchMode):
    """Sums ``flop_registry``'s FLOPs of every op dispatched inside."""

    total = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            self.total += formula(*args, **kwargs, out_val=out)
        return out


def _meta(tree):
    if isinstance(tree, dict):
        return {k: v if k == "buffer" else _meta(v) for k, v in tree.items()}
    return tree.to("meta") if torch.is_tensor(tree) else tree


def step_flops(config: dict, step: int) -> int:
    """FLOPs of the reference's step number ``step`` (R1 and the path term
    by its schedule) at the config's global batch, on the meta device."""
    h, w = config["data"]["image_size"]
    c = config["data"]["image_channels"]
    b = config["training"]["batch_size"]
    st = otm_train.State(config, None, "meta", 0.25)
    st.step = step
    dr = _meta(draws(config, torch.Generator().manual_seed(0)))
    batches = {k: torch.empty((b, h, w, c), device="meta")
               for k in ("d_shoeprints", "d_shoemarks", "g_shoeprints", "g_shoemarks")}
    counter = _Count()
    with counter:
        otm_train.train_step(st, batches, dr, rows=b)
    return counter.total


@functools.lru_cache(maxsize=4)
def _period_flops(config_json: str) -> float:
    config = json.loads(config_json)
    r1, path = config["tpu"]["r1_interval"], config["tpu"]["path_interval"]
    kinds = {}
    for k in range(r1):
        key = (k % r1 == 0, k % path == 0)
        kinds.setdefault(key, [k, 0])[1] += 1
    total = sum(step_flops(config, k) * count for k, count in kinds.values())
    return total / (r1 * config["training"]["batch_size"])


def flops_per_image(config: dict) -> float:
    """Model FLOPs per trained image over one period (module docstring)."""
    return _period_flops(json.dumps(config, sort_keys=True, default=str))
