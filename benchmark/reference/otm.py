"""Plain float32 reference of the one-to-many GAN's serving function.

The generator (a CycleGAN-style encoder, a StyleGAN2-modulated decoder)
and the mapping network of struan-robertson/one-to-many-gan, written from
the model's description with plain ``torch`` operations: no kernel, no
cache, no batching tricks. It imports nothing of the program under test.
Parameter names and shapes follow the served modules' ``state_dict``, so
that one set of weights made by the benchmark loads into both.

- Equalized learning rate: weights are stored N(0, 1) and scaled at use
  by ``1/sqrt(fan_in)``.
- Encoder: reflect-pad 3, 7x7 conv, instance norm, ReLU; per downsample a
  3x3 conv (zero pad 1), instance norm, ReLU, then blur and halve;
  ``n_resnet_blocks // 2`` residual blocks (reflect-pad 1, 3x3 conv, IN,
  ReLU, reflect-pad 1, 3x3 conv, IN, add).
- Decoder: ``ceil(n_resnet_blocks / 2)`` modulated residual blocks (the
  same style for both convs), per upsample a 2x bilinear upsample and
  blur, a modulated 3x3 conv (zero pad 1) and ReLU; reflect-pad 3, 7x7
  conv, tanh.
- Modulated conv (StyleGAN2): ``s = affine(w)`` scales the input
  channels and ``rsqrt(sum (s W)^2 + 1e-8)`` demodulates each output
  channel, computed as the equivalent scaling of activations.
- Blur: [1, 2, 1] / 4 along each axis on the edge-replicated map;
  resampling is bilinear with half-pixel centres (``F.interpolate``).
- Mapping: L2-normalised z, ``mapping_network_layers`` equalized linear
  layers, LeakyReLU(0.2) between them and ReLU last; the domain
  coordinate theta scales the style (theta = 0 is the zero style).

Instance norms report each input's shape to ``in_sites`` while one is
open, so the benchmark counts the bytes the norm has to move at the sizes
it runs.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F
from torch import nn

_sites: list | None = None


@contextlib.contextmanager
def in_sites():
    """Collect ``(shape, dtype)`` of every instance norm run inside."""
    global _sites
    outer, _sites = _sites, []
    try:
        yield _sites
    finally:
        _sites = outer


def instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    if _sites is not None:
        _sites.append((tuple(x.shape), x.dtype))
    mean = x.mean(dim=(2, 3), keepdim=True)
    var = (x - mean).square().mean(dim=(2, 3), keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps)


def blur(x: torch.Tensor) -> torch.Tensor:
    c = x.shape[1]
    k = torch.tensor([0.25, 0.5, 0.25], dtype=x.dtype, device=x.device)
    x = F.conv2d(F.pad(x, (0, 0, 1, 1), mode="replicate"),
                 k.reshape(1, 1, 3, 1).expand(c, 1, 3, 1), groups=c)
    return F.conv2d(F.pad(x, (1, 1, 0, 0), mode="replicate"),
                    k.reshape(1, 1, 1, 3).expand(c, 1, 1, 3), groups=c)


def downsample(x: torch.Tensor) -> torch.Tensor:
    h, w = x.shape[-2:]
    return F.interpolate(blur(x), size=(h // 2, w // 2), mode="bilinear",
                         align_corners=False, antialias=False)


def upsample(x: torch.Tensor) -> torch.Tensor:
    return blur(F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=False))


class Linear(nn.Module):
    def __init__(self, n_in: int, n_out: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(n_out, n_in))
        self.bias = nn.Parameter(torch.empty(n_out))

    def forward(self, x):
        return F.linear(x, self.weight / math.sqrt(self.weight.shape[1]), self.bias)


class Conv(nn.Module):
    def __init__(self, n_in: int, n_out: int, k: int, pad: int, mode: str, bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(n_out, n_in, k, k))
        self.bias = nn.Parameter(torch.empty(n_out)) if bias else None
        self.pad, self.mode = pad, mode

    def forward(self, x):
        x = F.pad(x, (self.pad,) * 4, mode=self.mode)
        w = self.weight / math.sqrt(self.weight[0].numel())
        return F.conv2d(x, w, self.bias)


class ModConv(nn.Module):
    def __init__(self, n_in: int, n_out: int, w_dim: int, mode: str):
        super().__init__()
        self.to_style = Linear(w_dim, n_in)
        self.weight = nn.Parameter(torch.empty(n_out, n_in, 3, 3))
        self.mode = mode

    def forward(self, x, w_style):
        s = self.to_style(w_style)
        wc = self.weight / math.sqrt(self.weight[0].numel())
        d = torch.rsqrt(s.square() @ wc.square().sum(dim=(2, 3)).T + 1e-8)
        x = F.pad(x * s[:, :, None, None], (1, 1, 1, 1), mode=self.mode)
        return F.conv2d(x, wc) * d[:, :, None, None]


class ResBlock(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.conv0 = Conv(c, c, 3, 1, "reflect", bias=False)
        self.conv1 = Conv(c, c, 3, 1, "reflect", bias=False)

    def forward(self, x):
        return x + instance_norm(self.conv1(torch.relu(instance_norm(self.conv0(x)))))


class ModResBlock(nn.Module):
    def __init__(self, c: int, w_dim: int):
        super().__init__()
        self.conv0 = ModConv(c, c, w_dim, "reflect")
        self.conv1 = ModConv(c, c, w_dim, "reflect")

    def forward(self, x, w):
        return x + self.conv1(torch.relu(self.conv0(x, w)), w)


class Generator(nn.Module):
    def __init__(self, channels: int, w_dim: int, image_size, min_latent: int,
                 n_resnet_blocks: int, start_filters: int = 64):
        super().__init__()
        n_down = math.ceil(math.log2(min(image_size) / min_latent))
        f = start_filters
        self.enc_stem = Conv(channels, f, 7, 3, "reflect")
        self.enc_down = nn.ModuleList()
        for _ in range(n_down):
            self.enc_down.append(Conv(f, 2 * f, 3, 1, "constant"))
            f *= 2
        self.enc_blocks = nn.ModuleList(ResBlock(f) for _ in range(n_resnet_blocks // 2))
        n_dec = math.ceil(n_resnet_blocks / 2)
        self.dec_blocks = nn.ModuleList(ModResBlock(f, w_dim) for _ in range(n_dec))
        self.dec_up = nn.ModuleList()
        for _ in range(n_down):
            self.dec_up.append(ModConv(f, f // 2, w_dim, "constant"))
            f //= 2
        self.out_conv = Conv(f, channels, 7, 3, "reflect")
        self.n_style_blocks = n_dec + n_down

    def encode(self, x):
        z = torch.relu(instance_norm(self.enc_stem(x)))
        for conv in self.enc_down:
            z = downsample(torch.relu(instance_norm(conv(z))))
        for block in self.enc_blocks:
            z = block(z)
        return z

    def decode(self, z, w):
        """``w``: one style per image, the same for every style block."""
        for block in self.dec_blocks:
            z = block(z, w)
        for conv in self.dec_up:
            z = torch.relu(conv(upsample(z), w))
        return torch.tanh(self.out_conv(z))


class Mapping(nn.Module):
    def __init__(self, w_dim: int, n_layers: int):
        super().__init__()
        self.layers = nn.ModuleList(Linear(w_dim, w_dim) for _ in range(n_layers))

    def forward(self, z):
        x = z / torch.linalg.vector_norm(z, dim=1, keepdim=True).clamp_min(1e-12)
        for i, layer in enumerate(self.layers):
            x = layer(x)
            x = torch.relu(x) if i == len(self.layers) - 1 else F.leaky_relu(x, 0.2)
        return x


def build(config: dict, device="cpu") -> tuple[Generator, Mapping]:
    """The reference generator and mapping network of a config (the
    program's sections), float32, parameters uninitialised."""
    arch, data = config["architecture"], config["data"]
    with torch.device(device):
        gen = Generator(data["image_channels"], arch["w_dim"], tuple(data["image_size"]),
                        arch["min_latent_resolution"], arch["n_resnet_blocks"])
        mapping = Mapping(arch["w_dim"], arch["mapping_network_layers"])
    return gen.requires_grad_(False).eval(), mapping.requires_grad_(False).eval()


def init_weights(normals: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """Weights from N(0, 1) draws of a ``state_dict``'s layout: every
    weight N(0, 1), as the equalized layers store them; a style affine's
    bias 1 + 0.1 N(0, 1) (its init is 1: unit modulation); every other
    bias 0.1 N(0, 1). The output conv's weights are centred per output
    channel, so that the image's mean does not hang on the sum of its
    weights: uncentred, some draws put the whole image near white or
    black, where tanh flattens the decoder's output and its errors."""
    out = {}
    for name, t in normals.items():
        if name.endswith("bias"):
            t = t * 0.1 + (1.0 if name.endswith("to_style.bias") else 0.0)
        elif name == "out_conv.weight":
            t = t - t.mean(dim=(1, 2, 3), keepdim=True)
        out[name] = t
    return out


def one_to_many(gen: Generator, mapping: Mapping, image_u8: torch.Tensor, z: torch.Tensor,
                theta: float, chunk: int = 16) -> torch.Tensor:
    """One source ``[H, W, C]`` uint8 and draws ``z`` ``[n, w_dim]`` ->
    ``[n, H, W, C]`` uint8 shoemarks, decoded ``chunk`` images at a time."""
    x = image_u8.to(torch.float32).permute(2, 0, 1)[None] / 127.5 - 1.0
    latent = gen.encode(x)
    styles = mapping(z.to(torch.float32)) * theta
    out = []
    for i in range(0, z.shape[0], chunk):
        w = styles[i : i + chunk]
        img = gen.decode(latent.expand(w.shape[0], *latent.shape[1:]), w)
        out.append(((img + 1.0) * 127.5).clamp(0, 255).to(torch.uint8))
    return torch.cat(out).permute(0, 2, 3, 1)
