"""Data and spatial parallelism: the process group, the ("data",
"spatial") group's collectives, the halo exchanges of the spatial axis,
the local launcher (the JAX package's ``parallel/``)."""

from one_to_many_gan_torch.parallel import distributed, halo
from one_to_many_gan_torch.parallel.mesh import DataParallel, make_group, replicate, shard_batch

__all__ = ["DataParallel", "distributed", "halo", "make_group", "replicate", "shard_batch"]
