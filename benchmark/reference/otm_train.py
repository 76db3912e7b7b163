"""Plain float32 reference of the one-to-many GAN's training step.

One step of struan-robertson/one-to-many-gan as the production config
trains it, written from the model's and the step's description with
plain ``torch`` operations: no kernel, no cache, no parallelism. It
imports nothing of the program under test; the generator and mapping
network are ``otm``'s (the serving reference), with per-block styles.
Parameter names follow the trained modules' ``state_dict``, so one set of
weights made by the benchmark loads into both.

A step takes the global batch (four NHWC batches in [-1, 1]) and its
draws (the program's ``StepDraws`` as nested dicts of tensors, the same
inputs the program's step takes) and computes:

- **D phase**: the fakes ``decode(encode(prints), style)`` without
  gradient (the mapping's two draws crossed over at a block when the
  mixing flag is set); the CycleGAN replay buffer over the global batch,
  in order; ADA (below) of the buffered fakes and the real marks at the
  probability entering the step; the LSGAN loss
  ``(mean((D(real) - 1)^2) + mean(D(fake)^2)) / 2``; on R1 steps
  ``r1_gamma / 2`` times the batch mean of ``|d sum_patches mean D(x) /
  dx|^2`` on the augmented reals, by double backward; Adam; the ADA
  controller fed the mean of ``sign(2 D(real) - 1)``.
- **G phase** against the updated discriminator: the packed [prints;
  marks] encoded, the KL term ``mean^2 + (var - 1)^2`` over all their
  latents; reconstruction (zero style) and identity (the marks' extracted
  style) L1; the translations (mapped styles) augmented at the step's
  entering probability and scored by D (``mean((D - 1)^2)``); the style
  cycle ``1 - mean cos + 0.2 mean (a - b)^2`` of the L2-normalised mapped
  and re-extracted styles; on path steps the theta-path term (features
  after each style block at theta +- h/2, ``mean over taps of mean(((f1 -
  f2) / h)^2)``) weighted by ``path_loss_lambda * path_interval``; three
  Adams (generator and extractor at ``learning_rate``, mapping at
  ``mapping_network_learning_rate``), then the EMA generator.
- **ADA**: the 12 published categories as one inverse affine and one
  colour matrix per image from the draws, the affine applied by an
  antialiased tent warp: each output pixel a sum over the taps within a
  tent of width ``clip(|row of the Jacobian|, 1, 4)`` around its source
  coordinate, normalised over the taps of the frame widened by 8 pixels,
  zero outside the frame, by gathers (differentiable in the images).

Batch-coupled terms see the whole global batch; the rest runs in blocks
of ``rows`` images, each block's gradient accumulated, so that the step
fits on one card: the KL term's moments come from a first encode of all
rows without gradient, and each block differentiates its rows' share of
the global term (``mean`` held constant in the variance, whose gradient
is exactly the global one). With one block the step is the plain
autograd of the whole losses.

Departures from the program's docstrings (``core/train_step.py``):
float32 throughout with TF32 off where the program computes in bfloat16
with float32 parameters, statistics and losses; the He constants unrounded;
the warp's sums in the order of its taps; ``torch.relu``'s derivative at
0 in the generator. ``precision = "fp8"`` (``quantized``) is the
benchmark's control: the reference with every learned conv and linear
layer in float8 as the float8 training recipe runs them, inputs and
weights rounded to e4m3 in the forward and the output's gradient to e5m2
in the backward, each tensor under a per-tensor scale.
"""

from __future__ import annotations

import contextlib
import math
from types import SimpleNamespace

import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference import otm

TRUNK_FEATURES = (64, 128, 256, 512)
AA_MAX_WIDTH = 4.0
RADIUS = 8  # the tent normaliser's taps run over the frame widened by this
TAPS = 10  # taps per axis that cover a tent of width AA_MAX_WIDTH from floor(c - width)
XINT_MAX, SCALE_STD, ROTATE_MAX, ANISO_STD, XFRAC_STD = 0.125, 0.2, 1.0, 0.2, 0.125
BRIGHTNESS_STD, CONTRAST_STD = 0.2, 0.5
E4M3_MAX, E5M2_MAX = 448.0, 57344.0


# ------------------------------------------------------------ precision


def _round(x: torch.Tensor, dtype: torch.dtype, top: float) -> torch.Tensor:
    """``x`` rounded to the float8 ``dtype`` under a per-tensor scale that
    maps its largest magnitude to ``top``."""
    scale = x.abs().amax().clamp_min(1e-30) / top
    return (x / scale).to(dtype).to(x.dtype) * scale


def _fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 in the forward, straight through in
    the backward."""
    return x + (_round(x.detach(), torch.float8_e4m3fn, E4M3_MAX) - x.detach())


class _GradE5M2(torch.autograd.Function):
    """The identity, whose backward rounds the gradient to float8 e5m2
    (differentiable again, straight through, for R1's double backward)."""

    @staticmethod
    def forward(ctx, y):
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        return g + (_round(g.detach(), torch.float8_e5m2, E5M2_MAX) - g.detach())


class _Functional:
    """``torch.nn.functional`` with the learned convs and linears (groups
    of 1) in float8: inputs and weights rounded to e4m3 in the forward,
    the output's gradient to e5m2 in the backward (the float8 training
    recipe's two formats)."""

    def __getattr__(self, name):
        return getattr(F, name)

    @staticmethod
    def conv2d(x, w, bias=None, stride=1, padding=0, dilation=1, groups=1):
        if groups != 1:
            return F.conv2d(x, w, bias, stride, padding, dilation, groups)
        return _GradE5M2.apply(F.conv2d(_fp8(x), _fp8(w), bias, stride, padding, dilation))

    @staticmethod
    def linear(x, w, bias=None):
        return _GradE5M2.apply(F.linear(_fp8(x), _fp8(w), bias))


@contextlib.contextmanager
def quantized(precision: str):
    """Inside, the reference's layers compute at ``precision``:
    "float32" (the reference) or "fp8" (the control)."""
    if precision == "float32":
        yield
        return
    if precision != "fp8":
        msg = f"unknown precision {precision!r}"
        raise ValueError(msg)
    outer = otm.F
    otm.F = _Functional()
    try:
        yield
    finally:
        otm.F = outer


# ------------------------------------------------------------ the models


def leaky_relu(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x >= 0, x, 0.2 * x)


def _blur_axis(x: torch.Tensor, dim: int) -> torch.Tensor:
    n = x.shape[dim]
    x = torch.cat([x.narrow(dim, 0, 1), x, x.narrow(dim, n - 1, 1)], dim)
    return (0.25 * x.narrow(dim, 0, n) + 0.5 * x.narrow(dim, 1, n)
            + 0.25 * x.narrow(dim, 2, n))


def blur(x: torch.Tensor) -> torch.Tensor:
    """``otm.blur`` ([1, 2, 1] / 4 along each axis of the edge-replicated
    map) by slices: its derivatives of every order are slices too, where
    a grouped conv's double backward (R1's) runs a conv per channel."""
    return _blur_axis(_blur_axis(x, 2), 3)


def downsample(x: torch.Tensor) -> torch.Tensor:
    """``otm.downsample``: the blur, then bilinear to half the size."""
    h, w = x.shape[-2:]
    return F.interpolate(blur(x), size=(h // 2, w // 2), mode="bilinear",
                         align_corners=False, antialias=False)


def upsample(x: torch.Tensor) -> torch.Tensor:
    """``otm.upsample``: bilinear 2x, then the blur."""
    return blur(F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=False))


class Trunk(nn.ModuleList):
    """Four 4x4 convs (zero pad 1) to 64, 128, 256, 512 channels; a blur
    and halving after the first three; an instance norm before the
    LeakyReLU(0.2) of the last three."""

    def __init__(self, channels: int):
        fins = (channels, *TRUNK_FEATURES[:-1])
        super().__init__(otm.Conv(a, b, 4, 1, "constant")
                         for a, b in zip(fins, TRUNK_FEATURES, strict=True))

    def forward(self, x):
        for i, conv in enumerate(self):
            x = conv(x)
            if i > 0:
                x = otm.instance_norm(x)
            x = leaky_relu(x)
            if i < len(self) - 1:
                x = downsample(x)
        return x


class Discriminator(nn.Module):
    """The trunk and a 4x4 conv to one channel: patch logits."""

    def __init__(self, channels: int):
        super().__init__()
        self.trunk = Trunk(channels)
        self.head = otm.Conv(TRUNK_FEATURES[-1], 1, 4, 1, "constant")

    def forward(self, x):
        return self.head(self.trunk(x))


class StyleExtractor(nn.Module):
    """The trunk, its spatial mean and a linear layer to ``w_dim``."""

    def __init__(self, channels: int, w_dim: int):
        super().__init__()
        self.trunk = Trunk(channels)
        self.head = otm.Linear(TRUNK_FEATURES[-1], w_dim)

    def forward(self, x):
        return self.head(self.trunk(x).mean(dim=(2, 3)))


def encode(gen: otm.Generator, x):
    """``otm.Generator.encode`` with this module's resampling."""
    z = torch.relu(otm.instance_norm(gen.enc_stem(x)))
    for conv in gen.enc_down:
        z = downsample(torch.relu(otm.instance_norm(conv(z))))
    for block in gen.enc_blocks:
        z = block(z)
    return z


def decode(gen: otm.Generator, z, w):
    """Latents and per-block styles ``w`` [n_blocks, B, w_dim] -> images."""
    i = 0
    for block in gen.dec_blocks:
        z = block(z, w[i])
        i += 1
    for conv in gen.dec_up:
        z = torch.relu(conv(upsample(z), w[i]))
        i += 1
    return torch.tanh(gen.out_conv(z))


def extract(gen: otm.Generator, z, w) -> list[torch.Tensor]:
    """The features after each style block (the last upsample conv's
    before its ReLU)."""
    feats, i = [], 0
    n = len(gen.dec_blocks) + len(gen.dec_up)
    for block in gen.dec_blocks:
        z = block(z, w[i])
        feats.append(z)
        i += 1
    for conv in gen.dec_up:
        z = conv(upsample(z), w[i])
        i += 1
        if i < n:
            z = torch.relu(z)
        feats.append(z)
    return feats


def style_vector(mapping: otm.Mapping, rngs: dict, n_blocks: int, rows=slice(None)):
    """[n_blocks, B, w_dim] styles of ``rngs``' rows ``rows``: ``z1``'s,
    or with the mixing flag ``z1``'s below the crossover block and
    ``z2``'s from it."""
    s1 = mapping(rngs["z1"][rows])
    s2 = mapping(rngs["z2"][rows])
    idx = torch.arange(n_blocks, device=s1.device)[:, None, None]
    mixed = torch.where(idx < rngs["crossover"], s1[None], s2[None])
    return torch.where(rngs["mix"], mixed, s1[None].expand(n_blocks, *s1.shape))


class Nets(nn.Module):
    """The four trained networks and the EMA generator of a config."""

    def __init__(self, config: dict):
        super().__init__()
        arch, data = config["architecture"], config["data"]
        c, w_dim = data["image_channels"], arch["w_dim"]
        self.g = otm.Generator(c, w_dim, tuple(data["image_size"]),
                               arch["min_latent_resolution"], arch["n_resnet_blocks"])
        self.m = otm.Mapping(w_dim, arch["mapping_network_layers"])
        self.d = Discriminator(c)
        self.s = StyleExtractor(c, w_dim)
        self.ema = otm.Generator(c, w_dim, tuple(data["image_size"]),
                                 arch["min_latent_resolution"], arch["n_resnet_blocks"])
        self.ema.requires_grad_(False)


NETS = ("g", "m", "d", "s")


def shapes(config: dict) -> dict[str, torch.Size]:
    """Every weight of the four networks, ``<net>.<name>``, on the meta
    device."""
    with torch.device("meta"):
        nets = Nets(config)
    return {f"{k}.{name}": p.shape for k in NETS
            for name, p in getattr(nets, k).state_dict().items()}


def init_weights(normals: dict[str, torch.Tensor]) -> dict[str, dict[str, torch.Tensor]]:
    """Per network, its weights from N(0, 1) draws of ``shapes``' layout
    (``otm.init_weights``: biases 0.1 N(0, 1), a style affine's 1 + 0.1
    N(0, 1), the output conv's weights centred)."""
    return {k: otm.init_weights({n[len(k) + 1:]: t for n, t in normals.items()
                                 if n.startswith(k + ".")}) for k in NETS}


# ------------------------------------------------------------ ADA


def _eye(n, b, device):
    return torch.eye(n, dtype=torch.float32, device=device).expand(b, n, n).clone()


def _translate(tx, ty):
    m = _eye(3, tx.shape[0], tx.device)
    m[:, 0, 2], m[:, 1, 2] = tx, ty
    return m


def _scale(sx, sy):
    m = _eye(3, sx.shape[0], sx.device)
    m[:, 0, 0], m[:, 1, 1] = sx, sy
    return m


def _rotate(t):
    c, s = torch.cos(t), torch.sin(t)
    m = _eye(3, t.shape[0], t.device)
    m[:, 0, 0], m[:, 0, 1], m[:, 1, 0], m[:, 1, 1] = c, -s, s, c
    return m


def _gate(gate, value, default: float):
    return torch.where(gate, value, torch.full_like(value, default))


def geometric_matrix(d: dict, h: int, w: int, p) -> torch.Tensor:
    """The inverse affine [B, 3, 3] (centred output pixel -> centred
    source): xflip, rotate90, integer translation, isotropic scale,
    rotation, anisotropic scale, rotation, fractional translation; the
    rotations at ``1 - sqrt(1 - p)`` each, the others at ``p``."""
    g = _eye(3, d["u_xflip"].shape[0], d["u_xflip"].device)
    ones = torch.ones_like(d["u_xflip"])
    g = g @ _scale(1.0 - 2.0 * _gate(d["u_xflip"] < p, d["i_xflip"].float(), 0.0), ones)
    g = g @ _rotate(math.pi / 2.0 * _gate(d["u_rot90"] < p, d["i_rot90"].float(), 0.0))
    t = _gate((d["u_xint_gate"] < p)[:, None], (d["u_xint"] * 2.0 - 1.0) * XINT_MAX, 0.0)
    g = g @ _translate(-torch.round(t[:, 0] * w), -torch.round(t[:, 1] * h))
    s = _gate(d["u_scale"] < p, torch.exp2(d["n_scale"] * SCALE_STD), 1.0)
    g = g @ _scale(1.0 / s, 1.0 / s)
    p_rot = 1.0 - torch.sqrt(torch.clamp_min(1.0 - p, 0.0))
    g = g @ _rotate(_gate(d["u_rot_pre_gate"] < p_rot,
                          (d["u_rot_pre"] * 2.0 - 1.0) * math.pi * ROTATE_MAX, 0.0))
    s = _gate(d["u_aniso"] < p, torch.exp2(d["n_aniso"] * ANISO_STD), 1.0)
    g = g @ _scale(1.0 / s, s)
    g = g @ _rotate(_gate(d["u_rot_post_gate"] < p_rot,
                          (d["u_rot_post"] * 2.0 - 1.0) * math.pi * ROTATE_MAX, 0.0))
    t = _gate((d["u_xfrac"] < p)[:, None], d["n_xfrac"] * XFRAC_STD, 0.0)
    return g @ _translate(-t[:, 0] * w, -t[:, 1] * h)


def color_gain_bias(d: dict, p) -> tuple[torch.Tensor, torch.Tensor]:
    """Per image (gain, bias) of one-channel images: brightness, contrast
    and luma flip composed as 4x4 colour matrices, then averaged over the
    three colour rows (hue and saturation act on colour images only)."""
    b, device = d["u_brightness"].shape[0], d["u_brightness"].device
    c = _eye(4, b, device)
    m = _eye(4, b, device)
    m[:, 0:3, 3] = _gate(d["u_brightness"] < p, d["n_brightness"] * BRIGHTNESS_STD, 0.0)[:, None]
    c = m @ c
    s = _gate(d["u_contrast"] < p, torch.exp2(d["n_contrast"] * CONTRAST_STD), 1.0)
    m = _eye(4, b, device)
    m[:, 0, 0] = m[:, 1, 1] = m[:, 2, 2] = s
    c = m @ c
    v = torch.tensor([1 / math.sqrt(3.0)] * 3 + [0.0], device=device)
    flip = _gate(d["u_lumaflip"] < p, d["i_lumaflip"].float(), 0.0)
    c = (_eye(4, b, device) - 2.0 * torch.outer(v, v)[None] * flip[:, None, None]) @ c
    row = c[:, :3, :].mean(dim=1)
    return row[:, :3].sum(dim=1), row[:, 3]


def _tents(coord: torch.Tensor, width: torch.Tensor, n: int):
    """[(index, weight)] of the ``TAPS`` taps from ``floor(coord - width)``:
    tent weights normalised over the taps inside [-RADIUS, n + RADIUS),
    zero (index clamped) outside the frame [0, n)."""
    wd = width[:, None, None]
    first = torch.floor(coord - wd)
    taps = [first + k for k in range(TAPS)]
    raw = [torch.relu(1.0 - (coord - t).abs() / wd) for t in taps]
    norm = sum(torch.where((t >= -RADIUS) & (t < n + RADIUS), r, torch.zeros_like(r))
               for t, r in zip(taps, raw, strict=True)).clamp_min(1e-8)
    return [(t.clamp(0, n - 1).long(),
             torch.where((t >= 0) & (t < n), r / norm, torch.zeros_like(r)))
            for t, r in zip(taps, raw, strict=True)]


def warp(images: torch.Tensor, g_inv: torch.Tensor) -> torch.Tensor:
    """Antialiased affine warp of [B, H, W] images by ``g_inv``."""
    b, h, w = images.shape
    ys = torch.arange(h, dtype=torch.float32, device=images.device) - (h - 1) / 2.0
    xs = torch.arange(w, dtype=torch.float32, device=images.device) - (w - 1) / 2.0
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    g = g_inv.detach()
    sx = g[:, 0, 0, None, None] * gx + g[:, 0, 1, None, None] * gy + g[:, 0, 2, None, None]
    sy = g[:, 1, 0, None, None] * gx + g[:, 1, 1, None, None] * gy + g[:, 1, 2, None, None]
    sx, sy = sx + (w - 1) / 2.0, sy + (h - 1) / 2.0
    width_x = torch.sqrt(g[:, 0, 0] ** 2 + g[:, 0, 1] ** 2).clamp(1.0, AA_MAX_WIDTH)
    width_y = torch.sqrt(g[:, 1, 0] ** 2 + g[:, 1, 1] ** 2).clamp(1.0, AA_MAX_WIDTH)
    flat = images.reshape(b, h * w)
    xt = _tents(sx, width_x, w)
    out = None
    for iy, wy in _tents(sy, width_y, h):
        row = None
        for ix, wx in xt:
            px = torch.gather(flat, 1, (iy * w + ix).reshape(b, -1)).reshape(b, h, w)
            row = wx * px if row is None else row + wx * px
        out = wy * row if out is None else out + wy * row
    return out


def augment(x: torch.Tensor, p, draws: dict) -> torch.Tensor:
    """ADA of one-channel NHWC images at probability ``p``."""
    _, h, w, _ = x.shape
    g_inv = geometric_matrix(draws["geom"], h, w, p)
    gain, bias = color_gain_bias(draws["color"], p)
    return (warp(x[..., 0], g_inv) * gain[:, None, None] + bias[:, None, None])[..., None]


def _rows(tree, rows: slice):
    """The rows ``rows`` of every per-image draw of an augment's draws."""
    return {k: {n: t[rows] for n, t in v.items()} for k, v in tree.items()}


# ------------------------------------------------------------ the step


def nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def l2_normalize(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp_min(1e-12)


class Adam:
    """Adam with bias correction, ``p -= lr / bc1 * m / (sqrt(v) /
    sqrt(bc2) + eps)``, over ``params``."""

    def __init__(self, params, lr: float, betas, eps: float = 1e-8):
        self.params = list(params)
        self.lr, (self.b1, self.b2), self.eps = lr, betas, eps
        self.m = [torch.zeros_like(p) for p in self.params]
        self.v = [torch.zeros_like(p) for p in self.params]
        self.t = 0

    @torch.no_grad()
    def step(self) -> None:
        self.t += 1
        bc1, bc2 = 1.0 - self.b1 ** self.t, 1.0 - self.b2 ** self.t
        for p, m, v in zip(self.params, self.m, self.v, strict=True):
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            m.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            v.mul_(self.b2).add_(g * g, alpha=1.0 - self.b2)
            p.sub_(self.lr / bc1 * m / (v.sqrt() / math.sqrt(bc2) + self.eps))
            p.grad = None


class State:
    """The training state from ``weights`` (None: as the networks are
    built, for counting): ``nets``, one ``Adam`` per network (``opt``),
    the ADA state (``p``, ``count``, ``accum``), the replay buffer
    (``buffer`` [size, H, W, C], ``filled``) and the step."""

    def __init__(self, config: dict, weights: dict, device, ada_p: float):
        self.config = config
        with torch.device(device):
            self.nets = Nets(config)
        if weights is not None:
            for k in NETS:
                getattr(self.nets, k).load_state_dict(weights[k])
            self.nets.ema.load_state_dict(weights["g"])
        opt = config["optimisation"]
        betas = tuple(opt["adam_betas"])
        self.opt = {k: Adam(getattr(self.nets, k).parameters(),
                            opt["mapping_network_learning_rate"] if k == "m"
                            else opt["learning_rate"], betas) for k in NETS}
        self.p = torch.tensor(ada_p, dtype=torch.float32, device=device)
        self.count, self.accum = 0, 0.0
        h, w = config["data"]["image_size"]
        c = config["data"]["image_channels"]
        size = config["training"]["image_buffer_size"]
        self.buffer = torch.zeros((size, h, w, c), device=device)
        self.filled = 0
        self.step = 0
        self.n_blocks = self.nets.g.n_style_blocks


def _blocks(b: int, rows: int) -> list[slice]:
    return [slice(i, min(i + rows, b)) for i in range(0, b, rows)]


def _buffer(st: State, fakes: torch.Tensor, draws: dict) -> torch.Tensor:
    """The replay buffer over the batch, in order: stored while not full,
    then with probability 1/2 (``swap > 0.5``) a stored image returned and
    replaced; draws are host tensors."""
    out = []
    swap, slot = draws["swap"].tolist(), draws["slot"].tolist()
    for i in range(fakes.shape[0]):
        if st.filled < st.buffer.shape[0]:
            st.buffer[st.filled] = fakes[i]
            st.filled += 1
            out.append(fakes[i])
        elif swap[i] > 0.5:
            out.append(st.buffer[slot[i]].clone())
            st.buffer[slot[i]] = fakes[i]
        else:
            out.append(fakes[i])
    return torch.stack(out)


def d_phase(st: State, prints, marks, draws: dict, rows: int) -> dict:
    cfg = st.config
    nets, b = st.nets, prints.shape[0]
    p = st.p
    with torch.no_grad():
        s = style_vector(nets.m, draws["style"], st.n_blocks)
        fakes = torch.cat([decode(nets.g, encode(nets.g, nchw(prints[r])), s[:, r])
                           for r in _blocks(b, rows)]).permute(0, 2, 3, 1)
        buffered = _buffer(st, fakes, draws["buffer"])
        aug_fake = augment(buffered, p, draws["aug_fake"])
        aug_real = augment(marks, p, draws["aug_real"])
    loss = torch.zeros((), device=prints.device)
    signs = torch.zeros((), device=prints.device)
    n_scores = None
    for r in _blocks(b, rows):
        fake_s, real_s = nets.d(nchw(aug_fake[r])), nets.d(nchw(aug_real[r]))
        n_scores = b * fake_s[0].numel()
        part = ((real_s - 1.0).square().sum() + fake_s.square().sum()) / (2.0 * n_scores)
        part.backward()
        loss += part.detach()
        signs += torch.sign(real_s.detach() * 2.0 - 1.0).sum()
    gamma = cfg["tpu"]["r1_gamma"]
    r1 = torch.zeros((), device=prints.device)
    if gamma > 0 and st.step % cfg["tpu"]["r1_interval"] == 0:
        for r in _blocks(b, rows):
            x = nchw(aug_real[r]).detach().requires_grad_(True)
            (grad,) = torch.autograd.grad(nets.d(x).mean(dim=(1, 2, 3)).sum(), x,
                                          create_graph=True)
            part = (gamma / 2.0) * grad.square().sum(dim=(1, 2, 3)).sum() / b
            part.backward()
            r1 += part.detach()
    sign_real = signs / n_scores
    st.opt["d"].step()
    _ada_update(st, sign_real)
    return {"disc_loss": loss + r1, "disc_real_acc": sign_real, "r1": r1}


def _ada_update(st: State, sign_real: torch.Tensor) -> None:
    """Integral control: a window of ``ada_e // batch`` scores closes at
    the next score, and ``p`` moves by ``adjustment * ada_e`` toward the
    target of the window's mean (the closing score counted)."""
    ada, b = st.config["ada"], st.config["training"]["batch_size"]
    n = ada["ada_overfitting_measurement_n_images"] // b
    if st.count == n:
        mean = (st.accum + sign_real) / (st.count + 1.0)
        target = ada["discriminator_real_acc_target"]
        step = ada["ada_adjustment_size"] * ada["ada_overfitting_measurement_n_images"]
        delta = torch.where(mean > target, step, torch.where(mean < target, -step, 0.0))
        st.p = torch.relu(st.p + delta)
        st.count, st.accum = 1, sign_real
    else:
        st.count, st.accum = st.count + 1, st.accum + sign_real


def g_phase(st: State, prints, marks, draws: dict, p_used, rows: int) -> dict:
    cfg, opt = st.config, st.config["optimisation"]
    nets, b, nb = st.nets, prints.shape[0], st.n_blocks
    path_step = st.step % cfg["tpu"]["path_interval"] == 0
    path_weight = opt["path_loss_lambda"] * cfg["tpu"]["path_interval"]
    blocks = _blocks(b, rows)
    nets.d.requires_grad_(False)
    if len(blocks) > 1:
        with torch.no_grad():
            lat = torch.cat([encode(nets.g, nchw(x[r])) for x in (prints, marks) for r in blocks])
            n = lat.numel()
            mean = lat.mean()
            var = (lat - mean).square().mean()
            del lat
    terms = dict.fromkeys(("gan_loss", "reconstruction_loss", "identity_loss",
                           "style_loss", "path_loss"), 0.0)
    kl_value = None
    for r in blocks:
        k = r.stop - r.start
        pl = encode(nets.g, nchw(prints[r]))
        ml = encode(nets.g, nchw(marks[r]))
        lat = torch.cat([pl, ml])
        if len(blocks) == 1:
            mean_b = lat.mean()
            kl = mean_b.square() + ((lat - mean_b).square().mean() - 1.0).square()
            kl_value = kl.detach()
        else:
            kl = (2.0 * mean / n * lat.sum()
                  + 2.0 * (var - 1.0) / n * (lat - mean).square().sum())
        mark_w = nets.s(nchw(marks[r]))
        w_t = style_vector(nets.m, draws["style"], nb, r)
        recon = decode(nets.g, pl, torch.zeros_like(w_t))
        idt = decode(nets.g, ml, mark_w[None].expand(nb, -1, -1))
        gen = decode(nets.g, pl, w_t)
        pixels = b * recon[0].numel()
        rec = (recon - nchw(prints[r])).abs().sum() / pixels
        idt_l = (idt - nchw(marks[r])).abs().sum() / pixels
        aug = augment(gen.permute(0, 2, 3, 1), p_used, _rows(draws["aug"], r))
        scores = nets.d(nchw(aug))
        gan = (scores - 1.0).square().sum() / (b * scores[0].numel())
        a, c = l2_normalize(w_t[-1]), l2_normalize(nets.s(gen))
        cos = (a * c).sum(dim=-1) / (torch.linalg.vector_norm(a, dim=-1)
                                     * torch.linalg.vector_norm(c, dim=-1)).clamp_min(1e-8)
        style = -cos.sum() / b + 0.2 * (a - c).square().sum() / (b * a.shape[-1])
        total = (gan + opt["identity_loss_lambda"] * idt_l
                 + opt["reconstruction_loss_lambda"] * rec + opt["kl_loss_lambda"] * kl
                 + opt["style_cycle_loss_lambda"] * style)
        path = torch.zeros((), device=prints.device)
        if path_step:
            w_path = style_vector(nets.m, draws["path_style"], nb, r)
            theta, h = draws["theta"][r], draws["fin_diff_h"][r]
            f1 = extract(nets.g, pl, w_path * (theta + h / 2.0).clamp(0.0, 1.0)[None, :, None])
            f2 = extract(nets.g, pl, w_path * (theta - h / 2.0).clamp(0.0, 1.0)[None, :, None])
            hh = h[:, None, None, None]
            path = sum(((x1 - x2) / hh).square().sum() / (b * x1[0].numel())
                       for x1, x2 in zip(f1, f2, strict=True)) / len(f1)
            total = total + path_weight * path
        total.backward()
        for name, v in (("gan_loss", gan), ("reconstruction_loss", rec),
                        ("identity_loss", idt_l), ("style_loss", style), ("path_loss", path)):
            terms[name] += v.detach()
        del pl, ml, lat, recon, idt, gen, aug, scores, total
    nets.d.requires_grad_(True)
    terms["style_loss"] = terms["style_loss"] + 1.0
    if kl_value is None:
        kl_value = mean.square() + (var - 1.0).square()
    terms["kl_loss"] = kl_value
    terms["total_gen_loss"] = (
        terms["gan_loss"] + opt["identity_loss_lambda"] * terms["identity_loss"]
        + opt["reconstruction_loss_lambda"] * terms["reconstruction_loss"]
        + opt["kl_loss_lambda"] * kl_value + opt["style_cycle_loss_lambda"] * terms["style_loss"]
        + path_weight * terms["path_loss"])
    for k in ("g", "m", "s"):
        st.opt[k].step()
    decay = cfg["tpu"]["ema_decay"]
    if decay > 0:
        with torch.no_grad():
            for e, q in zip(nets.ema.parameters(), nets.g.parameters(), strict=True):
                e.mul_(decay).add_(q * (1.0 - decay))
    st.step += 1
    return terms


def train_step(st: State, batches: dict, draws: dict, rows: int) -> dict:
    """One step on the global ``batches`` (``d_shoeprints``,
    ``d_shoemarks``, ``g_shoeprints``, ``g_shoemarks``: NHWC in [-1, 1])
    with the step's ``draws`` (``d`` and ``g``), ``rows`` images a block;
    -> its losses (0-d tensors)."""
    p_used = st.p
    out = d_phase(st, batches["d_shoeprints"], batches["d_shoemarks"], draws["d"], rows)
    out |= g_phase(st, batches["g_shoeprints"], batches["g_shoemarks"], draws["g"], p_used, rows)
    return out


def leaf_norms(named) -> dict[str, float]:
    return {name: float(torch.linalg.vector_norm(t.detach().float())) for name, t in named}


def first_gradients(st: State) -> dict[str, dict[str, float]]:
    """Per network, each leaf's norm of the gradient its Adam took, worked
    out from its first moment after one step (``m / (1 - beta1)``)."""
    return {k: leaf_norms((name, m / (1.0 - st.opt[k].b1)) for (name, _), m in
                          zip(getattr(st.nets, k).named_parameters(), st.opt[k].m, strict=True))
            for k in NETS}


def changes(st: State, start: dict[str, dict[str, torch.Tensor]]) -> dict[str, dict[str, float]]:
    """Per network (and ``ema``, against the generator's start), each
    leaf's norm of its change since ``start``."""
    out = {}
    for k in (*NETS, "ema"):
        ref = start["g" if k == "ema" else k]
        out[k] = leaf_norms((name, p - ref[name])
                            for name, p in getattr(st.nets, k).named_parameters())
    return out


def run_steps(config: dict, weights: dict, batches: list[dict], draws: list[dict], *,
              ada_p: float, rows: int, device, precision: str = "float32") -> SimpleNamespace:
    """The steps of ``batches`` and ``draws`` from ``weights``; ->
    ``losses`` (per step, floats), ``grads`` (``first_gradients`` after
    the first step) and ``changes`` (after the last), each leaf by name."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    st = State(config, weights, device, ada_p)
    start = {k: {n: t.detach().clone() for n, t in getattr(st.nets, k).named_parameters()}
             for k in NETS}
    losses, grads = [], None
    with quantized(precision):
        for i, (bt, dr) in enumerate(zip(batches, draws, strict=True)):
            out = train_step(st, bt, dr, rows)
            losses.append({k: float(v) for k, v in out.items()})
            if i == 0:
                grads = first_gradients(st)
    return SimpleNamespace(losses=losses, grads=grads, changes=changes(st, start))
