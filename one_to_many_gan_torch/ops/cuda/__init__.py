"""Hand-written CUDA kernels for Hopper and their wrappers.

Importing these modules builds nothing; ``build.load`` compiles a kernel
at its first launch.
"""

from one_to_many_gan_torch.ops.cuda.instance_norm import (
    fused_instance_norm,
    instance_norm_plain,
)
from one_to_many_gan_torch.ops.cuda.warp import warp, warp_plain

__all__ = ["fused_instance_norm", "instance_norm_plain", "warp", "warp_plain"]
