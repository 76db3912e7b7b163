"""Hand-written CUDA kernels for Hopper and their wrappers.

Importing these modules builds nothing; ``build.load`` compiles a kernel
at its first launch.
"""

from one_to_many_gan_torch.ops.cuda.instance_norm import (
    fused_instance_norm,
    instance_norm_plain,
)
from one_to_many_gan_torch.ops.cuda.int8_conv import (
    fused_int8_conv,
    int8_conv_plain,
    int8_prepass,
    modulated_int8_conv,
    modulated_int8_conv_plain,
)
from one_to_many_gan_torch.ops.cuda.warp import (
    warp,
    warp_bwd,
    warp_bwd_plain,
    warp_bwd_sum_bound,
    warp_plain,
)

__all__ = [
    "fused_instance_norm",
    "instance_norm_plain",
    "fused_int8_conv",
    "int8_conv_plain",
    "int8_prepass",
    "modulated_int8_conv",
    "modulated_int8_conv_plain",
    "warp",
    "warp_bwd",
    "warp_bwd_plain",
    "warp_bwd_sum_bound",
    "warp_plain",
]
