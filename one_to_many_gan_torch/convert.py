"""The weight bridge: JAX parameter trees <-> the port's modules.

``from_jax_params`` takes the generator, mapping-network and (optionally)
discriminator and style-extractor variable trees as the JAX package
writes them (``{"params": {...}}``, nested dicts of numpy arrays, e.g.
from ``export.load_inference_artifact``) and copies them into a
``Models`` (serving) or a ``TrainState`` (training, which holds the
discriminator and the extractor). Conv kernels go HWIO -> OIHW, linear
weights ``[in, out]`` -> ``[out, in]``. The leaf names are the ones the
JAX ``Generator``, ``MappingNetwork``, ``Discriminator`` and
``StyleExtractor`` produce. Every shape is checked, and a missing or
extra leaf raises.
"""

from __future__ import annotations

from collections.abc import Iterator, Mapping

import numpy as np
import torch
from torch import nn

from one_to_many_gan_torch.core.state import Models, TrainState
from one_to_many_gan_torch.ops import EqualizedConv, EqualizedLinear, ModulatedConv


def _flatten(tree, prefix: str, out: dict) -> None:
    if isinstance(tree, Mapping):
        for key, sub in tree.items():
            _flatten(sub, f"{prefix}/{key}" if prefix else key, out)
    else:
        out[prefix] = np.asarray(tree)


def _layer_leaves(name: str, layer: nn.Module) -> Iterator[tuple[str, nn.Parameter, str]]:
    """(JAX leaf path, port parameter, layout) for one layer."""
    if isinstance(layer, EqualizedLinear):
        yield f"{name}/weight", layer.weight, "linear"
        yield f"{name}/bias", layer.bias, "vector"
    elif isinstance(layer, EqualizedConv):
        yield f"{name}/weight", layer.weight, "conv"
        if layer.bias is not None:
            yield f"{name}/bias", layer.bias, "vector"
    elif isinstance(layer, ModulatedConv):
        yield f"{name}/weight", layer.weight, "conv"
        yield from _layer_leaves(f"{name}/to_style", layer.to_style)
    else:
        msg = f"no JAX layout for {type(layer).__name__}"
        raise TypeError(msg)


def _generator_layers(gen) -> Iterator[tuple[str, nn.Module]]:
    yield "enc_stem", gen.enc_stem
    for i, conv in enumerate(gen.enc_down):
        yield f"enc_down_{i}", conv
    for i, block in enumerate(gen.enc_blocks):
        yield f"enc_blocks_{i}/EqualizedConv_0", block.conv0
        yield f"enc_blocks_{i}/EqualizedConv_1", block.conv1
    for i, block in enumerate(gen.dec_blocks):
        yield f"dec_blocks_{i}/ModulatedConv_0", block.conv0
        yield f"dec_blocks_{i}/ModulatedConv_1", block.conv1
    for i, conv in enumerate(gen.dec_up):
        yield f"dec_up_{i}", conv
    yield "out_conv", gen.out_conv


def _mapping_layers(mapping) -> Iterator[tuple[str, nn.Module]]:
    for i, layer in enumerate(mapping.layers):
        yield f"EqualizedLinear_{i}", layer


def _discriminator_layers(disc) -> Iterator[tuple[str, nn.Module]]:
    for i, conv in enumerate(disc.trunk):
        yield f"EqualizedConv_{i}", conv
    yield f"EqualizedConv_{len(disc.trunk)}", disc.head


def _extractor_layers(extractor) -> Iterator[tuple[str, nn.Module]]:
    for i, conv in enumerate(extractor.trunk):
        yield f"EqualizedConv_{i}", conv
    yield "EqualizedLinear_0", extractor.head


def jax_leaves(layers) -> Iterator[tuple[str, nn.Parameter, str]]:
    """(JAX leaf path, port parameter, layout) of every leaf of ``layers``
    (e.g. ``_discriminator_layers(state.discriminator)``)."""
    for name, layer in layers:
        yield from _layer_leaves(f"params/{name}", layer)


def _to_torch_layout(arr: np.ndarray, layout: str) -> np.ndarray:
    if layout == "conv":
        return arr.transpose(3, 2, 0, 1) if arr.ndim == 4 else arr
    if layout == "linear":
        return arr.T if arr.ndim == 2 else arr
    return arr


def _load(layers, variables, what: str) -> None:
    flat: dict[str, np.ndarray] = {}
    _flatten(variables, "", flat)
    expected = {path: (param, layout) for path, param, layout in jax_leaves(layers)}
    missing = sorted(set(expected) - set(flat))
    extra = sorted(set(flat) - set(expected))
    if missing or extra:
        msg = f"{what} parameter tree mismatch: missing {missing}, unexpected {extra}"
        raise ValueError(msg)
    for path, (param, layout) in expected.items():
        value = _to_torch_layout(flat[path], layout)
        if tuple(value.shape) != tuple(param.shape):
            msg = (
                f"{what} leaf {path}: JAX shape {flat[path].shape} does not give "
                f"the port's {tuple(param.shape)}"
            )
            raise ValueError(msg)
        with torch.no_grad():
            param.copy_(torch.from_numpy(np.array(value, dtype=np.float32)))


def from_jax_params(
    target: Models | TrainState, params_g, params_m, params_d=None, params_s=None,
    ema_params_g=None,
) -> Models | TrainState:
    """Copy the JAX generator, mapping and (when given) discriminator,
    style-extractor and EMA generator (``ema_params_g``) variables into
    ``target`` (in place; returned for chaining): a ``Models`` for
    serving, or a ``TrainState``, the holder of the discriminator, the
    extractor and, with EMA on, the EMA generator."""
    _load(_generator_layers(target.generator), params_g, "generator")
    _load(_mapping_layers(target.mapping), params_m, "mapping")
    if params_d is not None:
        _load(_discriminator_layers(target.discriminator), params_d, "discriminator")
    if params_s is not None:
        _load(_extractor_layers(target.extractor), params_s, "extractor")
    if ema_params_g is not None:
        if getattr(target, "ema_generator", None) is None:
            msg = "ema_params_g given, but the target holds no EMA generator (tpu.ema_decay = 0)"
            raise ValueError(msg)
        _load(_generator_layers(target.ema_generator), ema_params_g, "EMA generator")
    return target


def _to_jax_layout(arr: np.ndarray, layout: str) -> np.ndarray:
    if layout == "conv":
        return arr.transpose(2, 3, 1, 0)
    if layout == "linear":
        return arr.T
    return arr


def _dump(layers) -> dict:
    tree: dict = {}
    for path, param, layout in jax_leaves(layers):
        *parents, leaf = path.split("/")
        node = tree
        for part in parents:
            node = node.setdefault(part, {})
        value = param.detach().to("cpu", torch.float32).numpy()
        node[leaf] = np.ascontiguousarray(_to_jax_layout(value, layout))
    return tree


def to_jax_params(source: Models | TrainState) -> tuple[dict, dict]:
    """-> (params_g, params_m): ``source``'s generator and mapping network
    as the JAX package's variable trees (nested dicts of float32 numpy
    arrays, HWIO convs, ``[in, out]`` linears); ``from_jax_params`` of
    them gives back the same values."""
    return _dump(_generator_layers(source.generator)), _dump(_mapping_layers(source.mapping))
