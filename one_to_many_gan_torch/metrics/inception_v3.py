"""InceptionV3 up to its pool3 features, for FID comparable with clean-fid.

The graph of torchvision's ``inception_v3`` up to the global average pool
(2048 features), NCHW, each ``BasicConv2d`` a convolution without bias
and its BatchNorm (eps 1e-3) folded into a per-channel ``scale`` and
``shift``, then ReLU. These are plain PyTorch ops (cuDNN on the card):
no hand-written kernel.

Two published variants (``variant``):

- ``"clean_fid"`` (the default): the network clean-fid and pytorch-fid
  run, ported from TensorFlow: the 3x3 average pools leave the padding
  out of the divisor (``count_include_pad=False``) and ``Mixed_7c``
  pools its last branch with a max pool. Use it with the ``pt_inception``
  weights for FIDs comparable with published ones.
- ``"torchvision"``: stock torchvision, whose average pools divide by 9
  everywhere; for torchvision's ImageNet weights.

Weights come in torchvision's format: a state dict whose keys are
``<name>.conv.weight`` (OIHW) and ``<name>.bn.{weight, bias,
running_mean, running_var}``, read from a ``.npz`` or from a torch
checkpoint (``load_state_dict_file``). The repository ships none;
``random_state_dict`` makes a random set of that format.

``make_extractor`` is clean-fid's preprocessing and forward on uint8
images: one channel repeated to three, PIL's antialiased bicubic resize
to 299x299 on the 0..255 scale (``ops/resample.py``), then
``(x - 127.5) / 127.5``; float32 with TF32 off.
"""

from __future__ import annotations

import contextlib
import pickle
import zipfile
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from one_to_many_gan_torch.device import select_device
from one_to_many_gan_torch.ops.resample import pil_bicubic_resize

BN_EPS = 1e-3
VARIANTS = ("clean_fid", "torchvision")
# What a weights file that cannot be used raises while it is read and folded.
UNUSABLE_WEIGHTS = (OSError, KeyError, ValueError, RuntimeError, pickle.UnpicklingError,
                    zipfile.BadZipFile)


def _conv_specs() -> list[tuple[str, int, int, int, int]]:
    """(name, in_ch, out_ch, kh, kw) of every BasicConv2d, in order."""
    specs = [
        ("Conv2d_1a_3x3", 3, 32, 3, 3),
        ("Conv2d_2a_3x3", 32, 32, 3, 3),
        ("Conv2d_2b_3x3", 32, 64, 3, 3),
        ("Conv2d_3b_1x1", 64, 80, 1, 1),
        ("Conv2d_4a_3x3", 80, 192, 3, 3),
    ]

    def a_block(prefix, in_ch, pool_features):
        return [
            (f"{prefix}.branch1x1", in_ch, 64, 1, 1),
            (f"{prefix}.branch5x5_1", in_ch, 48, 1, 1),
            (f"{prefix}.branch5x5_2", 48, 64, 5, 5),
            (f"{prefix}.branch3x3dbl_1", in_ch, 64, 1, 1),
            (f"{prefix}.branch3x3dbl_2", 64, 96, 3, 3),
            (f"{prefix}.branch3x3dbl_3", 96, 96, 3, 3),
            (f"{prefix}.branch_pool", in_ch, pool_features, 1, 1),
        ]

    specs += a_block("Mixed_5b", 192, 32)
    specs += a_block("Mixed_5c", 256, 64)
    specs += a_block("Mixed_5d", 288, 64)
    specs += [
        ("Mixed_6a.branch3x3", 288, 384, 3, 3),
        ("Mixed_6a.branch3x3dbl_1", 288, 64, 1, 1),
        ("Mixed_6a.branch3x3dbl_2", 64, 96, 3, 3),
        ("Mixed_6a.branch3x3dbl_3", 96, 96, 3, 3),
    ]

    def c_block(prefix, c7):
        return [
            (f"{prefix}.branch1x1", 768, 192, 1, 1),
            (f"{prefix}.branch7x7_1", 768, c7, 1, 1),
            (f"{prefix}.branch7x7_2", c7, c7, 1, 7),
            (f"{prefix}.branch7x7_3", c7, 192, 7, 1),
            (f"{prefix}.branch7x7dbl_1", 768, c7, 1, 1),
            (f"{prefix}.branch7x7dbl_2", c7, c7, 7, 1),
            (f"{prefix}.branch7x7dbl_3", c7, c7, 1, 7),
            (f"{prefix}.branch7x7dbl_4", c7, c7, 7, 1),
            (f"{prefix}.branch7x7dbl_5", c7, 192, 1, 7),
            (f"{prefix}.branch_pool", 768, 192, 1, 1),
        ]

    specs += c_block("Mixed_6b", 128)
    specs += c_block("Mixed_6c", 160)
    specs += c_block("Mixed_6d", 160)
    specs += c_block("Mixed_6e", 192)
    specs += [
        ("Mixed_7a.branch3x3_1", 768, 192, 1, 1),
        ("Mixed_7a.branch3x3_2", 192, 320, 3, 3),
        ("Mixed_7a.branch7x7x3_1", 768, 192, 1, 1),
        ("Mixed_7a.branch7x7x3_2", 192, 192, 1, 7),
        ("Mixed_7a.branch7x7x3_3", 192, 192, 7, 1),
        ("Mixed_7a.branch7x7x3_4", 192, 192, 3, 3),
    ]

    def e_block(prefix, in_ch):
        return [
            (f"{prefix}.branch1x1", in_ch, 320, 1, 1),
            (f"{prefix}.branch3x3_1", in_ch, 384, 1, 1),
            (f"{prefix}.branch3x3_2a", 384, 384, 1, 3),
            (f"{prefix}.branch3x3_2b", 384, 384, 3, 1),
            (f"{prefix}.branch3x3dbl_1", in_ch, 448, 1, 1),
            (f"{prefix}.branch3x3dbl_2", 448, 384, 3, 3),
            (f"{prefix}.branch3x3dbl_3a", 384, 384, 1, 3),
            (f"{prefix}.branch3x3dbl_3b", 384, 384, 3, 1),
            (f"{prefix}.branch_pool", in_ch, 192, 1, 1),
        ]

    specs += e_block("Mixed_7b", 1280)
    specs += e_block("Mixed_7c", 2048)
    return specs


class BasicConv2d(nn.Module):
    """A convolution without bias, its folded BatchNorm and ReLU. The
    weight (OIHW), ``scale`` and ``shift`` are buffers: the network only
    extracts features."""

    def __init__(self, cin: int, cout: int, kh: int, kw: int):
        super().__init__()
        self.register_buffer("weight", torch.zeros(cout, cin, kh, kw))
        self.register_buffer("scale", torch.ones(cout))
        self.register_buffer("shift", torch.zeros(cout))

    def forward(self, x: torch.Tensor, stride: int = 1, padding=0) -> torch.Tensor:
        y = F.conv2d(x, self.weight, stride=stride, padding=padding)
        return F.relu(y * self.scale[:, None, None] + self.shift[:, None, None])


class InceptionV3(nn.Module):
    """pool3 features ``[N, 2048]`` of ``[N, 3, 299, 299]`` images in
    [-1, 1]. The convolutions are held by name (``Mixed_5b`` ->
    ``branch1x1``, ...), as torchvision names them."""

    def __init__(self, variant: str = "clean_fid"):
        super().__init__()
        if variant not in VARIANTS:
            msg = f"unknown inception variant {variant!r}; use one of {VARIANTS}"
            raise ValueError(msg)
        self.variant = variant
        self.convs = nn.ModuleDict()
        for name, cin, cout, kh, kw in _conv_specs():
            block, _, branch = name.partition(".")
            conv = BasicConv2d(cin, cout, kh, kw)
            if branch:
                if block not in self.convs:
                    self.convs[block] = nn.ModuleDict()
                self.convs[block][branch] = conv
            else:
                self.convs[block] = conv

    def conv(self, name: str) -> BasicConv2d:
        block, _, branch = name.partition(".")
        return self.convs[block][branch] if branch else self.convs[block]

    def _cbr(self, name: str, x: torch.Tensor, stride: int = 1, padding=0) -> torch.Tensor:
        return self.conv(name)(x, stride, padding)

    def _avgpool(self, x: torch.Tensor) -> torch.Tensor:
        return F.avg_pool2d(x, 3, stride=1, padding=1,
                            count_include_pad=self.variant == "torchvision")

    def _a(self, p: str, x: torch.Tensor) -> torch.Tensor:
        b1 = self._cbr(f"{p}.branch1x1", x)
        b5 = self._cbr(f"{p}.branch5x5_2", self._cbr(f"{p}.branch5x5_1", x), padding=2)
        b3 = self._cbr(f"{p}.branch3x3dbl_1", x)
        b3 = self._cbr(f"{p}.branch3x3dbl_2", b3, padding=1)
        b3 = self._cbr(f"{p}.branch3x3dbl_3", b3, padding=1)
        bp = self._cbr(f"{p}.branch_pool", self._avgpool(x))
        return torch.cat([b1, b5, b3, bp], 1)

    def _b(self, p: str, x: torch.Tensor) -> torch.Tensor:
        b3 = self._cbr(f"{p}.branch3x3", x, stride=2)
        bd = self._cbr(f"{p}.branch3x3dbl_1", x)
        bd = self._cbr(f"{p}.branch3x3dbl_2", bd, padding=1)
        bd = self._cbr(f"{p}.branch3x3dbl_3", bd, stride=2)
        return torch.cat([b3, bd, F.max_pool2d(x, 3, stride=2)], 1)

    def _c(self, p: str, x: torch.Tensor) -> torch.Tensor:
        b1 = self._cbr(f"{p}.branch1x1", x)
        b7 = self._cbr(f"{p}.branch7x7_1", x)
        b7 = self._cbr(f"{p}.branch7x7_2", b7, padding=(0, 3))
        b7 = self._cbr(f"{p}.branch7x7_3", b7, padding=(3, 0))
        bd = self._cbr(f"{p}.branch7x7dbl_1", x)
        bd = self._cbr(f"{p}.branch7x7dbl_2", bd, padding=(3, 0))
        bd = self._cbr(f"{p}.branch7x7dbl_3", bd, padding=(0, 3))
        bd = self._cbr(f"{p}.branch7x7dbl_4", bd, padding=(3, 0))
        bd = self._cbr(f"{p}.branch7x7dbl_5", bd, padding=(0, 3))
        bp = self._cbr(f"{p}.branch_pool", self._avgpool(x))
        return torch.cat([b1, b7, bd, bp], 1)

    def _d(self, p: str, x: torch.Tensor) -> torch.Tensor:
        b3 = self._cbr(f"{p}.branch3x3_2", self._cbr(f"{p}.branch3x3_1", x), stride=2)
        b7 = self._cbr(f"{p}.branch7x7x3_1", x)
        b7 = self._cbr(f"{p}.branch7x7x3_2", b7, padding=(0, 3))
        b7 = self._cbr(f"{p}.branch7x7x3_3", b7, padding=(3, 0))
        b7 = self._cbr(f"{p}.branch7x7x3_4", b7, stride=2)
        return torch.cat([b3, b7, F.max_pool2d(x, 3, stride=2)], 1)

    def _e(self, p: str, x: torch.Tensor, max_pool_branch: bool = False) -> torch.Tensor:
        b1 = self._cbr(f"{p}.branch1x1", x)
        b3 = self._cbr(f"{p}.branch3x3_1", x)
        b3 = torch.cat([self._cbr(f"{p}.branch3x3_2a", b3, padding=(0, 1)),
                        self._cbr(f"{p}.branch3x3_2b", b3, padding=(1, 0))], 1)
        bd = self._cbr(f"{p}.branch3x3dbl_1", x)
        bd = self._cbr(f"{p}.branch3x3dbl_2", bd, padding=1)
        bd = torch.cat([self._cbr(f"{p}.branch3x3dbl_3a", bd, padding=(0, 1)),
                        self._cbr(f"{p}.branch3x3dbl_3b", bd, padding=(1, 0))], 1)
        pooled = F.max_pool2d(x, 3, stride=1, padding=1) if max_pool_branch else self._avgpool(x)
        bp = self._cbr(f"{p}.branch_pool", pooled)
        return torch.cat([b1, b3, bd, bp], 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self._cbr("Conv2d_1a_3x3", x, stride=2)
        y = self._cbr("Conv2d_2a_3x3", y)
        y = self._cbr("Conv2d_2b_3x3", y, padding=1)
        y = F.max_pool2d(y, 3, stride=2)
        y = self._cbr("Conv2d_3b_1x1", y)
        y = self._cbr("Conv2d_4a_3x3", y)
        y = F.max_pool2d(y, 3, stride=2)
        for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d"):
            y = self._a(name, y)
        y = self._b("Mixed_6a", y)
        for name in ("Mixed_6b", "Mixed_6c", "Mixed_6d", "Mixed_6e"):
            y = self._c(name, y)
        y = self._d("Mixed_7a", y)
        y = self._e("Mixed_7b", y)
        y = self._e("Mixed_7c", y, max_pool_branch=self.variant == "clean_fid")
        return y.mean(dim=(2, 3))


# ------------------------------------------------------------ weights


def random_state_dict(seed: int = 0) -> dict[str, np.ndarray]:
    """A random torchvision-format state dict (numpy float32): He-scaled
    conv weights and BatchNorm statistics and affines near the identity,
    so that the activations stay of order one through the network."""
    r = np.random.default_rng(seed)
    state = {}
    for name, cin, cout, kh, kw in _conv_specs():
        state[f"{name}.conv.weight"] = (
            r.standard_normal((cout, cin, kh, kw)) / np.sqrt(kh * kw * cin)
        ).astype(np.float32)
        state[f"{name}.bn.weight"] = r.random(cout).astype(np.float32) + 0.5
        state[f"{name}.bn.bias"] = r.standard_normal(cout).astype(np.float32) * 0.1
        state[f"{name}.bn.running_mean"] = r.standard_normal(cout).astype(np.float32) * 0.1
        state[f"{name}.bn.running_var"] = r.random(cout).astype(np.float32) + 0.5
    return state


def load_state_dict_file(path: Path | str) -> dict[str, np.ndarray]:
    """A torchvision-format state dict from a ``.npz``, or from a torch
    checkpoint (read with ``weights_only=True``), as numpy arrays."""
    path = Path(path)
    if path.suffix == ".npz":
        with np.load(path) as z:
            return {k: z[k] for k in z.files}
    state = torch.load(path, map_location="cpu", weights_only=True)
    return {k: v.numpy() for k, v in state.items() if torch.is_tensor(v)}


def from_torchvision_state(state: dict, variant: str = "clean_fid") -> InceptionV3:
    """An ``InceptionV3`` (on the CPU) with every conv of ``state`` folded:
    ``scale = gamma / sqrt(var + 1e-3)``, ``shift = beta - mean * scale``,
    in float32. A missing key raises ``KeyError``, a
    conv of the wrong shape ``ValueError``; keys past pool3 (``AuxLogits``,
    ``fc``) are not read."""
    model = InceptionV3(variant)
    for name, cin, cout, kh, kw in _conv_specs():
        w = np.asarray(state[f"{name}.conv.weight"])
        if w.shape != (cout, cin, kh, kw):
            msg = f"{name}: expected {(cout, cin, kh, kw)}, got {w.shape}"
            raise ValueError(msg)
        gamma, beta, mean, var = (np.asarray(state[f"{name}.bn.{k}"], np.float32)
                                  for k in ("weight", "bias", "running_mean", "running_var"))
        scale = gamma / np.sqrt(var + np.float32(BN_EPS))
        conv = model.conv(name)
        conv.weight.copy_(torch.from_numpy(w.astype(np.float32)))
        conv.scale.copy_(torch.from_numpy(scale))
        conv.shift.copy_(torch.from_numpy(beta - mean * scale))
    return model


# ------------------------------------------------------------ extractor


@contextlib.contextmanager
def _tf32_off():
    """TF32 off for cuBLAS and cuDNN inside the block, restored after."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def preprocess(images_u8: np.ndarray, device: torch.device) -> torch.Tensor:
    """uint8 NHWC images -> the network's [N, 3, 299, 299] input on
    ``device``: PIL's bicubic to 299x299 on the 0..255 scale, one channel
    repeated to three (the resize acts on each channel alike, so it runs
    once before the repeat), then ``(x - 127.5) / 127.5``."""
    x = torch.from_numpy(np.ascontiguousarray(images_u8)).to(device)
    x = pil_bicubic_resize(x.permute(0, 3, 1, 2).float(), 299, 299)
    if x.shape[1] == 1:
        x = x.expand(-1, 3, -1, -1)
    return (x - 127.5) / 127.5


def make_extractor(model: InceptionV3, batch: int = 32, device=None):
    """A ``FeatureFn``: uint8 NHWC images -> pool3 features ``[N, 2048]``
    (float32 numpy), ``model`` on ``device`` (None: ``cuda``, raising
    without a GPU), ``batch`` images a forward, float32 with TF32 off."""
    device = select_device(device)
    model = model.to(device).eval()

    @torch.no_grad()
    def extract(images_u8: np.ndarray) -> np.ndarray:
        out = []
        with _tf32_off():
            for i in range(0, images_u8.shape[0], batch):
                out.append(model(preprocess(images_u8[i : i + batch], device)).cpu().numpy())
        return np.concatenate(out)

    return extract
