"""one_to_many_gan_torch: the PyTorch + CUDA port of the 1->N serving path
and of training (the fused step, the Trainer loop, checkpoints and
evaluation).

A second package beside the JAX reference package, for
an NVIDIA H100. It mirrors the reference's module names so each part has
an obvious counterpart, and uses PyTorch's idiom inside: ``nn.Module``s,
NCHW tensors within the models, NHWC images at the public inference
functions, an explicit ``device`` and explicit ``torch.Generator``s.

The package imports ``torch``, ``numpy``, ``PIL`` and the standard
library (and scipy, for FID) only; it never imports the JAX package.
The TPU kernels on these paths, the fused instance norm and the ADA
warp's forward and backward, are hand-written CUDA kernels
(``csrc/instance_norm.cu``, ``csrc/warp.cu``) built with ``nvcc`` at
first use.
"""

__version__ = "0.1.0"

from one_to_many_gan_torch.config import Config, load_config

__all__ = ["Config", "load_config", "__version__"]
