"""Generator: CycleGAN-style encoder/decoder with a StyleGAN2-modulated decoder (NCHW).

Encoder (style-free):
  reflect-pad 3 -> eq-conv7x7(C -> 64) -> InstanceNorm -> ReLU
  n_downsamples x [eq-conv3x3(f -> 2f, zero pad 1) -> IN -> ReLU -> DownSample]
  (n_resnet_blocks // 2) x ResnetBlock
Decoder (one style vector per *style block*):
  ceil(n_resnet_blocks / 2) x ModulatedResnetBlock (reflect pads)
  n_downsamples x [UpSample -> modulated conv3x3(f -> f/2, zero pad 1) -> ReLU]
  reflect-pad 3 -> eq-conv7x7(-> C) -> tanh

Every instance norm of the encoder (1 + n_downsamples + 2 per resnet
block: 9 at the shipped config) runs the CUDA kernel through
``fused_instance_norm``, ReLU fused where one follows. ``int8_decode``
(inference only) runs the decoder's modulated convs on int8 codes
(``ops/quantize.py``; 10 at the shipped config) with the same parameters,
so checkpoints and artifacts load unchanged.

``extract`` returns the feature map after each style block: after each
modulated resnet block's residual add, and after each upsample-stage
modulated conv, post-ReLU for every upsample conv except the last, which
stays pre-ReLU.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from one_to_many_gan_torch.models.blocks import ModulatedResnetBlock, ResnetBlock
from one_to_many_gan_torch.ops import (
    EqualizedConv,
    ModulatedConv,
    downsample2x,
    fused_instance_norm,
    upsample2x,
)
from one_to_many_gan_torch.ops.activations import relu


def generator_arithmetic(
    image_size: tuple[int, int], min_latent_resolution: int, n_resnet_blocks: int
) -> tuple[int, int, int, int]:
    """(n_downsamples, n_encoder_blocks, n_decoder_blocks, n_style_blocks)."""
    n_down = math.ceil(math.log2(min(image_size) / min_latent_resolution))
    n_enc = n_resnet_blocks // 2
    n_dec = math.ceil(n_resnet_blocks / 2)
    return n_down, n_enc, n_dec, n_dec + n_down


class Generator(nn.Module):
    def __init__(
        self,
        channels: int,
        w_dim: int,
        image_size: tuple[int, int],
        min_latent_resolution: int,
        n_resnet_blocks: int,
        *,
        start_filters: int = 64,
        dtype: torch.dtype = torch.float32,
        int8_decode: bool = False,
    ):
        super().__init__()
        n_down, n_enc, n_dec, n_style = generator_arithmetic(
            image_size, min_latent_resolution, n_resnet_blocks
        )
        self.n_style_blocks = n_style
        self.dtype = dtype
        f = start_filters
        self.enc_stem = EqualizedConv(channels, f, 7, padding=3, pad_mode="reflect", dtype=dtype)
        enc_down = []
        for _ in range(n_down):
            enc_down.append(EqualizedConv(f, f * 2, 3, padding=1, dtype=dtype))
            f *= 2
        self.enc_down = nn.ModuleList(enc_down)
        self.enc_blocks = nn.ModuleList(ResnetBlock(f, dtype=dtype) for _ in range(n_enc))
        self.latent_features = f

        self.dec_blocks = nn.ModuleList(
            ModulatedResnetBlock(f, w_dim, dtype=dtype, int8=int8_decode) for _ in range(n_dec)
        )
        dec_up = []
        for _ in range(n_down):
            dec_up.append(ModulatedConv(f, f // 2, w_dim, 3, padding=1, dtype=dtype,
                                        int8=int8_decode))
            f //= 2
        self.dec_up = nn.ModuleList(dec_up)
        self.out_conv = EqualizedConv(f, channels, 7, padding=3, pad_mode="reflect", dtype=dtype)

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """Image [B,C,H,W] -> latent feature map."""
        z = fused_instance_norm(self.enc_stem(x.to(self.dtype)), relu=True)
        for conv in self.enc_down:
            z = fused_instance_norm(conv(z), relu=True)
            z = downsample2x(z)
        for block in self.enc_blocks:
            z = block(z)
        return z

    def decode(self, z: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """Latent + per-block styles w [n_style_blocks, B, w_dim] -> image."""
        i = 0
        for block in self.dec_blocks:
            z = block(z, w[i])
            i += 1
        for conv in self.dec_up:
            z = relu(conv(upsample2x(z), w[i]))
            i += 1
        return torch.tanh(self.out_conv(z))

    def extract(self, z: torch.Tensor, w: torch.Tensor) -> list[torch.Tensor]:
        """Feature maps after each style block (path-loss taps)."""
        features = []
        n_total = len(self.dec_blocks) + len(self.dec_up)
        i = 0
        for block in self.dec_blocks:
            z = block(z, w[i])
            features.append(z)
            i += 1
        for conv in self.dec_up:
            z = conv(upsample2x(z), w[i])
            i += 1
            if i < n_total:
                z = relu(z)
            features.append(z)
        return features

    def forward(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return self.decode(self.encode(x), w)
