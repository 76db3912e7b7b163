"""Serving core: the models and the inference entry points."""

from one_to_many_gan_torch.core.inference import make_inference_fns
from one_to_many_gan_torch.core.state import Models

__all__ = ["Models", "make_inference_fns"]
