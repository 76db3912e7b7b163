"""Core: the models, the inference entry points and the D phase of training."""

from one_to_many_gan_torch.core.inference import make_inference_fns
from one_to_many_gan_torch.core.state import Models

__all__ = ["Models", "make_inference_fns"]
