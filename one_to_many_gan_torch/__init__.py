"""one_to_many_gan_torch: the PyTorch + CUDA port of the 1->N serving path.

A second package beside the JAX reference package, for
an NVIDIA H100. It mirrors the reference's module names so each part has
an obvious counterpart, and uses PyTorch's idiom inside: ``nn.Module``s,
NCHW tensors within the models, NHWC images at the public inference
functions, an explicit ``device`` and explicit ``torch.Generator``s.

The package imports ``torch``, ``numpy``, ``PIL`` and the standard
library only; it never imports the JAX package. The one TPU kernel on
this path, the fused instance norm, is a hand-written CUDA kernel
(``csrc/instance_norm.cu``) built with ``nvcc`` at first use.
"""

__version__ = "0.1.0"

from one_to_many_gan_torch.config import Config, load_config

__all__ = ["Config", "load_config", "__version__"]
