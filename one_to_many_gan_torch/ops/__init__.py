"""Primitive ops: equalized layers, modulated conv, resampling, norms."""

from one_to_many_gan_torch.ops.cuda import fused_instance_norm
from one_to_many_gan_torch.ops.equalized import EqualizedConv, EqualizedLinear
from one_to_many_gan_torch.ops.modulated import ModulatedConv
from one_to_many_gan_torch.ops.norm import instance_norm, l2_normalize
from one_to_many_gan_torch.ops.quantize import int8_conv, quantize_activations, quantize_weight
from one_to_many_gan_torch.ops.resample import (
    bilinear_resize,
    blur3,
    downsample2x,
    pil_bicubic_resize,
    upsample2x,
)

__all__ = [
    "EqualizedConv",
    "EqualizedLinear",
    "ModulatedConv",
    "bilinear_resize",
    "blur3",
    "downsample2x",
    "fused_instance_norm",
    "instance_norm",
    "int8_conv",
    "l2_normalize",
    "pil_bicubic_resize",
    "quantize_activations",
    "quantize_weight",
    "upsample2x",
]
