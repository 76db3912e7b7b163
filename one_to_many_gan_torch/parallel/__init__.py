"""Data parallelism: the process group, the group's collectives, the
local launcher (the JAX package's ``parallel/``, without its spatial
axis)."""

from one_to_many_gan_torch.parallel import distributed
from one_to_many_gan_torch.parallel.mesh import DataParallel, make_group, replicate, shard_batch

__all__ = ["DataParallel", "distributed", "make_group", "replicate", "shard_batch"]
