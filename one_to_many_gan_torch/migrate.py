"""The reference's checkpoint schema, in both directions.

The reference saves its training state as one ``torch.save`` dict,
``<run>/models/<step>.tar``:

- ``generator_state_dict``, ``discriminator_state_dict``,
  ``mapping_network_state_dict``, ``style_extractor_state_dict``: each
  network's ``state_dict()``, keyed by the reference's ``Sequential``
  layout (``encoder.1.weight.weight``, ``decoder.3.to_style.bias``, ...);
- ``*_optim_state_dict``: each network's Adam ``state_dict()``, its
  moments keyed by the parameter's position in the network's
  ``parameters()`` order;
- ``ada_p``: the ADA probability; ``image_buffer_images``: the replay
  buffer as a list of ``count`` float32 [1, C, H, W] tensors, and
  ``image_buffer_size``.

``to_reference_checkpoint(state)`` writes the port's ``TrainState`` in
that schema and ``from_reference_checkpoint(ckpt, state)`` reads it back
into one. The JAX package's importer reads the same file (its
``migrate.import_torch_checkpoint``), and the reader here reads a
reference checkpoint. The key arithmetic is the inverse of the JAX
package's ``migrate.map_*_params``: the generator's stem is
``encoder.1``, down conv i ``encoder.{4+4i}``, encoder resnet block i's
convs ``encoder.{4+4n_down+i}.conv_block.{1,5}``, decoder block i's
``decoder.{i}.conv_block.{1,4}``, up conv i ``decoder.{n_dec+3i+1}``,
the output conv ``decoder.{n_dec+3n_down+1}``; the trunks' convs
``model.{0,3,7,11}``, the discriminator's head ``model.14``, the
extractor's ``model.16``; the mapping's layers ``net.{2i}``. Values are
copied: the port's layouts are the reference's (linear ``[out, in]``,
convs OIHW), and equalized layers store raw weights on both sides.

Key order is the reference's registration order, a module's own
parameters before its submodules' (an equalized layer's ``bias`` before
its ``weight.weight``; a modulated conv's ``weight.weight`` before its
``to_style``): the importers pair Adam's positional state with the
state_dict's keys in that order, so the Adams' state is re-keyed to it.
The reference's fixed blur buffers (``*.smooth.kernel``) are not
written, and are skipped when read.

For an exact resume the file also carries what the reference drops,
under keys the JAX importer ignores: ``step``; ``ada_window``, the ADA
controller's open window (``count``, ``accum``); and, with EMA on
(``tpu.ema_decay > 0``), ``ema_generator_state_dict``, the EMA
generator's weights in the generator's keys and order. A reference file
has none of them: its step comes from the file name, the window starts
fresh, and EMA starts as a copy of the generator (the JAX importer's
rule, its ``migrate.py``). Everything is tensors, numbers, lists and
dicts, so ``torch.load(..., weights_only=True)`` reads it.

The JAX importer reads the port's files, but it cannot read the EMA key:
it starts its EMA as a copy of the imported generator. So a port file
with EMA on carries into the JAX package exactly except for the EMA
weights, which restart there from the generator.

``CheckpointManager`` keeps a run's files, ``<run>/models/<step>.tar``
(the reference's name): the latest by step, at most
``tpu.keep_checkpoints`` of them, each written through a temporary file
and ``os.replace``. The trainer writes through it; the serving entry
points read the latest file with ``latest_checkpoint``.
"""

from __future__ import annotations

import os
from collections.abc import Iterator
from pathlib import Path

import torch
from torch import nn

from one_to_many_gan_torch.augment.controller import AdaState
from one_to_many_gan_torch.core.buffer import BufferState
from one_to_many_gan_torch.core.state import TrainState
from one_to_many_gan_torch.ops import EqualizedConv, EqualizedLinear, ModulatedConv

# (checkpoint name, TrainState module, TrainState optimizer)
NETWORKS = (
    ("generator", "generator", "opt_g"),
    ("discriminator", "discriminator", "opt_d"),
    ("mapping_network", "mapping", "opt_m"),
    ("style_extractor", "extractor", "opt_s"),
)

# The EMA generator's state_dict: the generator's keys, under a key of the
# port's own (the reference has no EMA).
EMA_KEY = "ema_generator_state_dict"

# The trunks' conv positions in the reference's Sequential.
_TRUNK_IDX = (0, 3, 7, 11)


class MigrationError(ValueError):
    """A checkpoint did not match the configured architecture."""


def _layer_keys(prefix: str, layer: nn.Module) -> Iterator[tuple[str, nn.Parameter]]:
    if isinstance(layer, (EqualizedConv, EqualizedLinear)):
        if layer.bias is not None:
            yield f"{prefix}.bias", layer.bias
        yield f"{prefix}.weight.weight", layer.weight
    elif isinstance(layer, ModulatedConv):
        yield f"{prefix}.weight.weight", layer.weight
        yield from _layer_keys(f"{prefix}.to_style", layer.to_style)
    else:
        msg = f"no reference layout for {type(layer).__name__}"
        raise TypeError(msg)


def _generator_layers(gen) -> Iterator[tuple[str, nn.Module]]:
    n_down, n_dec = len(gen.enc_down), len(gen.dec_blocks)
    yield "encoder.1", gen.enc_stem
    for i, conv in enumerate(gen.enc_down):
        yield f"encoder.{4 + 4 * i}", conv
    for i, block in enumerate(gen.enc_blocks):
        base = f"encoder.{4 + 4 * n_down + i}.conv_block"
        yield f"{base}.1", block.conv0
        yield f"{base}.5", block.conv1
    for i, block in enumerate(gen.dec_blocks):
        yield f"decoder.{i}.conv_block.1", block.conv0
        yield f"decoder.{i}.conv_block.4", block.conv1
    for i, conv in enumerate(gen.dec_up):
        yield f"decoder.{n_dec + 3 * i + 1}", conv
    yield f"decoder.{n_dec + 3 * n_down + 1}", gen.out_conv


def _trunk_layers(net, head_idx: int) -> Iterator[tuple[str, nn.Module]]:
    for k, conv in zip(_TRUNK_IDX, net.trunk, strict=True):
        yield f"model.{k}", conv
    yield f"model.{head_idx}", net.head


def _mapping_layers(mapping) -> Iterator[tuple[str, nn.Module]]:
    for i, layer in enumerate(mapping.layers):
        yield f"net.{2 * i}", layer


def reference_keys(name: str, module: nn.Module) -> list[tuple[str, nn.Parameter]]:
    """(reference state_dict key, port parameter) of network ``name`` (a
    checkpoint name of ``NETWORKS``), in the reference's order."""
    layers = {
        "generator": lambda m: _generator_layers(m),
        "discriminator": lambda m: _trunk_layers(m, 14),
        "style_extractor": lambda m: _trunk_layers(m, 16),
        "mapping_network": lambda m: _mapping_layers(m),
    }[name](module)
    pairs = [kp for prefix, layer in layers for kp in _layer_keys(prefix, layer)]
    if len(pairs) != len(list(module.parameters())):
        msg = f"{name}: {len(pairs)} reference keys for {len(list(module.parameters()))} parameters"
        raise MigrationError(msg)
    return pairs


def _opt_positions(opt: torch.optim.Optimizer) -> dict[int, int]:
    """id(parameter) -> its position in the optimizer's state_dict."""
    params = [p for group in opt.param_groups for p in group["params"]]
    return {id(p): i for i, p in enumerate(params)}


def _cpu(value):
    return value.detach().to("cpu", copy=True) if torch.is_tensor(value) else value


def to_reference_checkpoint(state: TrainState) -> dict:
    """``state`` as a reference checkpoint dict (CPU tensors, copies)."""
    ckpt: dict = {}
    for name, attr, opt_attr in NETWORKS:
        pairs = reference_keys(name, getattr(state, attr))
        ckpt[f"{name}_state_dict"] = {k: _cpu(p) for k, p in pairs}
        opt = getattr(state, opt_attr)
        saved = opt.state_dict()
        pos = _opt_positions(opt)
        ckpt[f"{name}_optim_state_dict"] = {
            "state": {
                j: {k: _cpu(v) for k, v in saved["state"][pos[id(p)]].items()}
                for j, (_, p) in enumerate(pairs)
                if pos[id(p)] in saved["state"]
            },
            "param_groups": [{**saved["param_groups"][0], "params": list(range(len(pairs)))}],
        }
    count = int(state.buffer.count)
    images = state.buffer.images[:count].permute(0, 3, 1, 2).float().cpu()
    ckpt["ada_p"] = float(state.ada.p)
    ckpt["image_buffer_images"] = [img[None].clone() for img in images]
    ckpt["image_buffer_size"] = state.buffer.images.shape[0]
    ckpt["step"] = int(state.step)
    ckpt["ada_window"] = {"count": _cpu(state.ada.count), "accum": _cpu(state.ada.accum)}
    if state.ema_generator is not None:
        ckpt[EMA_KEY] = {k: _cpu(p) for k, p in reference_keys("generator", state.ema_generator)}
    return ckpt


def _param_keys(sd: dict) -> list[str]:
    """The state_dict's parameter keys in order (blur buffers left out)."""
    return [k for k in sd if not k.endswith("smooth.kernel")]


def from_reference_checkpoint(
    ckpt: dict, state: TrainState, *, step: int | None = None
) -> TrainState:
    """Load a reference checkpoint dict into ``state`` (in place; returned):
    the four networks, their Adams, ADA p (and the open window when the
    file has one; else a fresh window), the replay buffer, the step
    (``ckpt["step"]``, else ``step``) and, when ``state`` keeps an EMA
    generator, the file's EMA weights, or a copy of the generator's when
    the file has none. Every key and shape is checked."""
    if "step" not in ckpt and step is None:
        msg = "the checkpoint carries no step; pass step= (the reference's <step>.tar name)"
        raise MigrationError(msg)
    for name, attr, opt_attr in NETWORKS:
        pairs = _load_params(ckpt[f"{name}_state_dict"], name, getattr(state, attr))
        _load_optimizer(getattr(state, opt_attr), ckpt[f"{name}_optim_state_dict"],
                        ckpt[f"{name}_state_dict"], pairs, name)
    if state.ema_generator is not None:
        sd = ckpt.get(EMA_KEY, ckpt["generator_state_dict"])
        _load_params(sd, "generator", state.ema_generator)
    device = state.ada.p.device
    window = ckpt.get("ada_window")
    state.ada = AdaState(
        p=torch.tensor(float(ckpt.get("ada_p", 0.0)), dtype=torch.float32, device=device),
        count=(window["count"].to(device, torch.int32) if window is not None
               else torch.zeros((), dtype=torch.int32, device=device)),
        accum=(window["accum"].to(device, torch.float32) if window is not None
               else torch.zeros((), dtype=torch.float32, device=device)),
    )
    images = state.buffer.images
    size = images.shape[0]
    stored = list(ckpt.get("image_buffer_images", []))[:size]
    images.zero_()
    if stored:
        images[: len(stored)] = torch.cat(stored, 0).permute(0, 2, 3, 1).to(images)
    state.buffer = BufferState(
        images=images, count=torch.tensor(len(stored), dtype=torch.int32, device=images.device)
    )
    state.step = int(ckpt.get("step", step))
    return state


@torch.no_grad()
def _load_params(sd: dict, name: str, module: nn.Module) -> list[tuple[str, nn.Parameter]]:
    """Copy the state_dict ``sd`` of network ``name`` into ``module``;
    -> its (key, parameter) pairs."""
    pairs = reference_keys(name, module)
    keys, want = set(_param_keys(sd)), {k for k, _ in pairs}
    if keys != want:
        missing, extra = sorted(want - keys), sorted(keys - want)
        msg = f"{name}: checkpoint keys do not match: missing {missing}, unexpected {extra}"
        raise MigrationError(msg)
    for key, param in pairs:
        value = sd[key]
        if tuple(value.shape) != tuple(param.shape):
            msg = (f"{name}: '{key}' has shape {tuple(value.shape)}, the configured "
                   f"model {tuple(param.shape)}")
            raise MigrationError(msg)
        param.copy_(value)
    return pairs


def load_inference_weights(ckpt: dict, models) -> bool:
    """Copy the generator and the mapping network of a checkpoint dict
    into ``models`` (a ``Models`` or a ``TrainState``), for serving: the
    EMA generator's weights when the file has them. -> whether it had."""
    ema = EMA_KEY in ckpt
    _load_params(ckpt[EMA_KEY if ema else "generator_state_dict"], "generator", models.generator)
    _load_params(ckpt["mapping_network_state_dict"], "mapping_network", models.mapping)
    return ema


def _load_optimizer(opt: torch.optim.Optimizer, opt_sd: dict, sd: dict, pairs, name: str) -> None:
    """Re-key a reference Adam state_dict (positions in the state_dict's
    key order) to ``opt``'s parameter order and load it."""
    ref_pos = {k: j for j, k in enumerate(_param_keys(sd))}
    ids = list(opt_sd["param_groups"][0]["params"])
    if len(ids) != len(ref_pos):
        msg = (f"{name}: the optimizer state has {len(ids)} parameters, the state_dict "
               f"{len(ref_pos)}")
        raise MigrationError(msg)
    pos = _opt_positions(opt)
    state = {}
    for key, param in pairs:
        ref_id = ids[ref_pos[key]]
        if ref_id not in opt_sd["state"]:
            continue  # never stepped: Adam starts it from zero moments
        entry = opt_sd["state"][ref_id]
        for field in ("exp_avg", "exp_avg_sq"):
            if tuple(entry[field].shape) != tuple(param.shape):
                msg = (f"{name}: the Adam {field} of '{key}' has shape "
                       f"{tuple(entry[field].shape)}, the parameter {tuple(param.shape)}")
                raise MigrationError(msg)
        state[pos[id(param)]] = dict(entry)
    group = {**opt_sd["param_groups"][0], "params": list(range(len(pairs)))}
    opt.load_state_dict({"state": state, "param_groups": [group]})


class CheckpointManager:
    """``<directory>/<step>.tar`` files: the latest by step, at most
    ``keep`` of them."""

    def __init__(self, directory: Path | str, keep: int):
        self.directory = Path(directory)
        self.keep = max(1, int(keep))

    def path(self, step: int) -> Path:
        return self.directory / f"{step}.tar"

    def all_steps(self) -> list[int]:
        if not self.directory.is_dir():
            return []
        return sorted(int(p.stem) for p in self.directory.glob("*.tar") if p.stem.isdigit())

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, ckpt: dict) -> Path:
        """Write ``ckpt`` as ``<step>.tar`` through a temporary file and
        ``os.replace``, then delete the oldest files beyond ``keep``."""
        self.directory.mkdir(parents=True, exist_ok=True)
        final = self.path(step)
        tmp = final.with_name(f".{step}.tar.tmp")
        torch.save(ckpt, tmp)
        os.replace(tmp, final)
        for old in self.all_steps()[: -self.keep]:
            self.path(old).unlink(missing_ok=True)
        return final

    def load(self, step: int) -> dict:
        return torch.load(self.path(step), map_location="cpu", weights_only=True)


def checkpoint_manager(config) -> CheckpointManager:
    """The run's manager: ``<checkpoint_directory>/<training_run>/models``."""
    training = config["training"]
    directory = training["checkpoint_directory"] / training["training_run"] / "models"
    return CheckpointManager(directory, config["tpu"]["keep_checkpoints"])


def latest_checkpoint(config) -> tuple[dict | None, int]:
    """-> (the configured run's latest checkpoint dict, its step), or
    (None, 0) without one."""
    mgr = checkpoint_manager(config)
    step = mgr.latest_step()
    return (None, 0) if step is None else (mgr.load(step), step)
