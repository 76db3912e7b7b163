"""Adaptive discriminator augmentation (ADA), from injected draws.

The JAX package's ``augment/pipeline.py`` composes the 12 published ADA
categories per sample with probability ``p``: the geometric ones (xflip,
rotate90, xint, scale, rotate, aniso, xfrac) into ONE inverse affine
``G_inv [B,3,3]`` applied by one warp, the colour ones (brightness,
contrast, lumaflip, hue, saturation) into ONE ``[B,4,4]`` colour matrix.
This module computes the same matrices from the same raw draws:
``GeometricDraws`` and ``ColorDraws`` hold the uniform, normal and
randint tensors that the JAX code draws from its keys
(``split(k_geom, 16)``, ``split(k_color, 10)``), so tests hand both
packages the same draws, and training draws them from a
``torch.Generator`` with the same distributions (``draw_augment``).

Every category is always on (the JAX training step's default). The warp
runs through ``ops/cuda/warp.py``, the hand-written CUDA kernels that
replace the Pallas warp kernels (forward and image cotangent), so
``augment`` is differentiable in the images, as the generator phase
needs. The port always takes those kernels' numerics (the JAX package's
``tpu.ada_pallas`` is a TPU choice between them and an XLA contraction
that rounds differently in bfloat16). The antialiased warp widens the
tent per image and per axis; ``supersample`` (``tpu.ada_supersample``)
runs the published 2x supersampled warp instead: a sym6 2x upsample, the
same warp kernels without antialiasing on the 2x grid, a sym6 2x
downsample (``warp_supersampled``).

Images are NHWC at this module's functions, as in the JAX package.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from one_to_many_gan_torch.ops.cuda.warp import AA_MAX_WIDTH, warp

# Published default strengths (the JAX package's constants).
XINT_MAX = 0.125
SCALE_STD = 0.2
ROTATE_MAX = 1.0
ANISO_STD = 0.2
XFRAC_STD = 0.125
BRIGHTNESS_STD = 0.2
CONTRAST_STD = 0.5
HUE_MAX = 1.0
SATURATION_STD = 1.0


class GeometricDraws(NamedTuple):
    """Raw draws of one geometric matrix, in the JAX key order 0-15.
    ``u_*`` uniform [0, 1), ``n_*`` standard normal, ``i_*`` integers."""

    i_xflip: torch.Tensor  # [B] in {0, 1}
    u_xflip: torch.Tensor  # [B] gate
    i_rot90: torch.Tensor  # [B] in {0, 1, 2, 3}
    u_rot90: torch.Tensor  # [B] gate
    u_xint: torch.Tensor  # [B, 2]
    u_xint_gate: torch.Tensor  # [B]
    n_scale: torch.Tensor  # [B]
    u_scale: torch.Tensor  # [B] gate
    u_rot_pre: torch.Tensor  # [B] angle
    u_rot_pre_gate: torch.Tensor  # [B]
    n_aniso: torch.Tensor  # [B]
    u_aniso: torch.Tensor  # [B] gate
    u_rot_post: torch.Tensor  # [B] angle
    u_rot_post_gate: torch.Tensor  # [B]
    n_xfrac: torch.Tensor  # [B, 2]
    u_xfrac: torch.Tensor  # [B] gate


class ColorDraws(NamedTuple):
    """Raw draws of one colour matrix, in the JAX key order 0-9."""

    n_brightness: torch.Tensor  # [B]
    u_brightness: torch.Tensor  # [B] gate
    n_contrast: torch.Tensor  # [B]
    u_contrast: torch.Tensor  # [B] gate
    i_lumaflip: torch.Tensor  # [B] in {0, 1}
    u_lumaflip: torch.Tensor  # [B] gate
    u_hue: torch.Tensor  # [B] angle
    u_hue_gate: torch.Tensor  # [B]
    n_saturation: torch.Tensor  # [B]
    u_saturation: torch.Tensor  # [B] gate


class AugmentDraws(NamedTuple):
    geom: GeometricDraws
    color: ColorDraws


def draw_augment(
    generator: torch.Generator, b: int, device: str | torch.device
) -> AugmentDraws:
    """The draws of one ``augment`` call on a batch of ``b`` images, with
    the JAX package's distributions, from ``generator`` (on ``device``)."""

    def u(*shape):
        return torch.rand(shape or (b,), generator=generator, device=device)

    def n(*shape):
        return torch.randn(shape or (b,), generator=generator, device=device)

    def i(high):
        return torch.randint(0, high, (b,), generator=generator, device=device)

    geom = GeometricDraws(
        i(2), u(), i(4), u(), u(b, 2), u(), n(), u(), u(), u(), n(), u(), u(), u(), n(b, 2), u()
    )
    color = ColorDraws(n(), u(), n(), u(), i(2), u(), u(), u(), n(), u())
    return AugmentDraws(geom, color)


def _eye(n: int, b: int, device) -> torch.Tensor:
    return torch.eye(n, dtype=torch.float32, device=device).expand(b, n, n).clone()


def _translate2d(tx: torch.Tensor, ty: torch.Tensor) -> torch.Tensor:
    m = _eye(3, tx.shape[0], tx.device)
    m[:, 0, 2] = tx
    m[:, 1, 2] = ty
    return m


def _scale2d(sx: torch.Tensor, sy: torch.Tensor) -> torch.Tensor:
    m = _eye(3, sx.shape[0], sx.device)
    m[:, 0, 0] = sx
    m[:, 1, 1] = sy
    return m


def _rotate2d(theta: torch.Tensor) -> torch.Tensor:
    c, s = torch.cos(theta), torch.sin(theta)
    m = _eye(3, theta.shape[0], theta.device)
    m[:, 0, 0] = c
    m[:, 0, 1] = -s
    m[:, 1, 0] = s
    m[:, 1, 1] = c
    return m


def _rotate3d_luma(theta: torch.Tensor) -> torch.Tensor:
    """4x4 rotation about the (1,1,1)/sqrt(3) axis (hue rotation)."""
    v = 1.0 / math.sqrt(3.0)
    c, s = torch.cos(theta), torch.sin(theta)
    cc = 1.0 - c
    m = _eye(4, theta.shape[0], theta.device)
    m[:, 0, 0] = v * v * cc + c
    m[:, 0, 1] = v * v * cc - v * s
    m[:, 0, 2] = v * v * cc + v * s
    m[:, 1, 0] = v * v * cc + v * s
    m[:, 1, 1] = v * v * cc + c
    m[:, 1, 2] = v * v * cc - v * s
    m[:, 2, 0] = v * v * cc - v * s
    m[:, 2, 1] = v * v * cc + v * s
    m[:, 2, 2] = v * v * cc + c
    return m


def _where(gate: torch.Tensor, value: torch.Tensor, default: float) -> torch.Tensor:
    return torch.where(gate, value, torch.full_like(value, default))


def geometric_matrix(
    draws: GeometricDraws, height: int, width: int, p: torch.Tensor
) -> torch.Tensor:
    """The per-sample inverse geometric transform G_inv [B,3,3]: centered
    output pixel coordinates -> centered input coordinates."""
    d = draws
    b = d.u_xflip.shape[0]
    g = _eye(3, b, d.u_xflip.device)
    ones = torch.ones_like(d.u_xflip)

    i = _where(d.u_xflip < p, d.i_xflip.float(), 0.0)
    g = g @ _scale2d(1.0 - 2.0 * i, ones)
    i = _where(d.u_rot90 < p, d.i_rot90.float(), 0.0)
    g = g @ _rotate2d(math.pi / 2.0 * i)
    t = _where((d.u_xint_gate < p)[:, None], (d.u_xint * 2.0 - 1.0) * XINT_MAX, 0.0)
    g = g @ _translate2d(-torch.round(t[:, 0] * width), -torch.round(t[:, 1] * height))
    s = _where(d.u_scale < p, torch.exp2(d.n_scale * SCALE_STD), 1.0)
    g = g @ _scale2d(1.0 / s, 1.0 / s)
    p_rot = 1.0 - torch.sqrt(torch.clamp_min(1.0 - p, 0.0))
    theta = (d.u_rot_pre * 2.0 - 1.0) * math.pi * ROTATE_MAX
    g = g @ _rotate2d(_where(d.u_rot_pre_gate < p_rot, theta, 0.0))
    s = _where(d.u_aniso < p, torch.exp2(d.n_aniso * ANISO_STD), 1.0)
    g = g @ _scale2d(1.0 / s, s)
    theta = (d.u_rot_post * 2.0 - 1.0) * math.pi * ROTATE_MAX
    g = g @ _rotate2d(_where(d.u_rot_post_gate < p_rot, theta, 0.0))
    t = _where((d.u_xfrac < p)[:, None], d.n_xfrac * XFRAC_STD, 0.0)
    return g @ _translate2d(-t[:, 0] * width, -t[:, 1] * height)


def color_matrix(draws: ColorDraws, channels: int, p: torch.Tensor) -> torch.Tensor:
    """The per-sample colour transform C [B,4,4]. Hue and saturation act
    only on multi-channel images, as in the published pipeline."""
    d = draws
    b = d.u_brightness.shape[0]
    device = d.u_brightness.device
    c = _eye(4, b, device)

    bright = _where(d.u_brightness < p, d.n_brightness * BRIGHTNESS_STD, 0.0)
    m = _eye(4, b, device)
    m[:, 0:3, 3] = bright[:, None]
    c = m @ c
    s = _where(d.u_contrast < p, torch.exp2(d.n_contrast * CONTRAST_STD), 1.0)
    m = _eye(4, b, device)
    m[:, 0, 0] = s
    m[:, 1, 1] = s
    m[:, 2, 2] = s
    c = m @ c
    v = torch.tensor([1 / math.sqrt(3.0)] * 3 + [0.0], device=device)  # the luma axis
    vvt = torch.outer(v, v)
    i = _where(d.u_lumaflip < p, d.i_lumaflip.float(), 0.0)
    c = (_eye(4, b, device) - 2.0 * vvt[None] * i[:, None, None]) @ c
    if channels > 1:
        theta = (d.u_hue * 2.0 - 1.0) * math.pi * HUE_MAX
        c = _rotate3d_luma(_where(d.u_hue_gate < p, theta, 0.0)) @ c
        s = _where(d.u_saturation < p, torch.exp2(d.n_saturation * SATURATION_STD), 1.0)
        eye = torch.eye(4, device=device)
        c = (vvt[None] + (eye[None] - vvt[None]) * s[:, None, None]) @ c
    return c


def source_coords(
    g_inv: torch.Tensor, height: int, width: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-output-pixel source coordinates (sx, sy), each [B,H,W], in input
    pixel units: the centered output grid mapped through ``g_inv``."""
    device = g_inv.device
    ys = torch.arange(height, dtype=torch.float32, device=device) - (height - 1) / 2.0
    xs = torch.arange(width, dtype=torch.float32, device=device) - (width - 1) / 2.0
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    grid = torch.stack([gx, gy, torch.ones_like(gx)], dim=-1)  # [H,W,3]
    src = torch.einsum("bij,hwj->bhwi", g_inv, grid)
    return src[..., 0] + (width - 1) / 2.0, src[..., 1] + (height - 1) / 2.0


def tent_widths(
    g_inv: torch.Tensor, *, antialias: bool
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-image tent widths (width_x, width_y), each [B]: the L2 norms of
    the Jacobian's rows clipped to [1, AA_MAX_WIDTH] when antialiasing
    (1 for a rigid transform, s for a minification by s), else 1."""
    if not antialias:
        ones = torch.ones(g_inv.shape[0], dtype=torch.float32, device=g_inv.device)
        return ones, ones
    jac = g_inv[:, :2, :2]
    width_x = torch.sqrt(jac[:, 0, 0] ** 2 + jac[:, 0, 1] ** 2).clamp(1.0, AA_MAX_WIDTH)
    width_y = torch.sqrt(jac[:, 1, 0] ** 2 + jac[:, 1, 1] ** 2).clamp(1.0, AA_MAX_WIDTH)
    return width_x, width_y


def warp_images(
    images: torch.Tensor, g_inv: torch.Tensor, *, antialias: bool, supersample: bool = False
) -> torch.Tensor:
    """Affine warp of single-channel NHWC images, zero outside the frame,
    through the warp kernels (``ops/cuda/warp.py``), which take contiguous
    images: a strided view (the G phase's translations are every third
    image of one decode) is copied first. ``supersample`` runs
    ``warp_supersampled`` instead (it overrides ``antialias``).
    Differentiable in the images only: the coordinates and widths are
    detached, as the JAX package stops their gradient (they come from the
    draws)."""
    if supersample:
        return warp_supersampled(images, g_inv)
    b, h, w, c = images.shape
    if c != 1:
        msg = f"the ADA warp takes single-channel images, got {c} channels"
        raise ValueError(msg)
    sx, sy = source_coords(g_inv.detach(), h, w)
    width_x, width_y = tent_widths(g_inv.detach(), antialias=antialias)
    return warp(images[..., 0].contiguous(), sx, sy, width_x, width_y,
                antialias=antialias)[..., None]


# sym6 scaling (low-pass) filter, the public wavelet constants (sum sqrt 2):
# the published ADA pipeline's filter for its 2x supersampled warp.
SYM6_LO = np.array([
    0.015404109327027373, 0.0034907120842174702, -0.11799011114819057, -0.048311742585633,
    0.4910559419267466, 0.787641141030194, 0.3379294217276218, -0.07263752278646252,
    -0.021060292512300564, 0.04472490177066578, 0.0017677118642428036, -0.007800708325034148,
])


@functools.lru_cache(maxsize=8)
def ss_updown_ops(n: int) -> tuple[np.ndarray, np.ndarray, float, float]:
    """(U [2n, n], D [n, 2n], a_up, a_dn): the dense sym6 2x up and down
    operators along an axis of ``n`` pixels and their sample phases, in
    float64, the JAX package's ``_ss_updown_ops`` bit for bit.

    The even-length filter has half-sample phases, so the shift pair is
    self-calibrated: the (c_up, c_dn) whose ``D @ U`` is closest to the
    identity in the interior of a probe of min(n, 64) pixels (the choice
    is shift-invariant there); then the phases are measured from the
    operators' row centroids. Upsampled pixel j stands for input
    coordinate (j - a_up) / 2, and down-output i reads its centroid at
    upsampled position 2 i + a_dn."""
    f = SYM6_LO / SYM6_LO.sum()  # DC gain 1
    length = len(f)
    idx_n = np.arange(n)
    idx_2n = np.arange(2 * n)

    def up_op(c, m):  # u[j, i] = 2 f[j - 2i + c]
        k = idx_2n[: 2 * m, None] - 2 * idx_n[None, :m] + c
        return np.where((k >= 0) & (k < length), 2 * f[np.clip(k, 0, length - 1)], 0.0)

    def down_op(c, m):  # d[i, j] = f[j - 2i + c]
        k = idx_2n[None, : 2 * m] - 2 * idx_n[:m, None] + c
        return np.where((k >= 0) & (k < length), f[np.clip(k, 0, length - 1)], 0.0)

    m = min(n, 64)
    best = None
    for c_up in range(length):
        u_m = up_op(c_up, m)
        for c_dn in range(length):
            err = np.abs(down_op(c_dn, m) @ u_m - np.eye(m))[4:-4, 4:-4].sum()
            if best is None or err < best[0]:
                best = (err, c_up, c_dn)
    _, c_up, c_dn = best
    u, d = up_op(c_up, n), down_op(c_dn, n)
    a_up = n - 2 * (u[n] @ idx_n / u[n].sum())
    i_mid = n // 2
    a_dn = (d[i_mid] @ idx_2n / d[i_mid].sum()) - 2 * i_mid
    return u, d, float(a_up), float(a_dn)


_OPS_CACHE: dict = {}


def _ss_tensors(n: int, dtype: torch.dtype, device) -> tuple[torch.Tensor, torch.Tensor]:
    """``ss_updown_ops(n)``'s U and D in ``dtype`` on ``device``, made once
    (normal tensors even under ``torch.inference_mode``)."""
    key = (n, dtype, str(device))
    if key not in _OPS_CACHE:
        u, d, _, _ = ss_updown_ops(n)
        with torch.inference_mode(False):
            _OPS_CACHE[key] = tuple(torch.from_numpy(a).to(device=device, dtype=dtype)
                                    for a in (u, d))
    return _OPS_CACHE[key]


def supersampled_coords(
    g_inv: torch.Tensor, height: int, width: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Source coordinates (sx, sy), each [B, 2H, 2W], of the 2x output grid
    in the 2x upsampled image's pixels: 2x output pixel j stands for output
    coordinate (j - a_dn) / 2, mapped through ``g_inv`` (centred), then to
    upsampled pixels through a_up (the JAX package's ``_warp_supersampled``)."""
    _, _, a_up_h, a_dn_h = ss_updown_ops(height)
    _, _, a_up_w, a_dn_w = ss_updown_ops(width)
    device = g_inv.device
    oy = (torch.arange(2 * height, dtype=torch.float32, device=device) - a_dn_h) / 2.0 \
        - (height - 1) / 2.0
    ox = (torch.arange(2 * width, dtype=torch.float32, device=device) - a_dn_w) / 2.0 \
        - (width - 1) / 2.0
    gy, gx = torch.meshgrid(oy, ox, indexing="ij")
    grid = torch.stack([gx, gy, torch.ones_like(gx)], dim=-1)  # [2H,2W,3]
    src = torch.einsum("bij,hwj->bhwi", g_inv, grid)
    sx = 2.0 * (src[..., 0] + (width - 1) / 2.0) + a_up_w
    sy = 2.0 * (src[..., 1] + (height - 1) / 2.0) + a_up_h
    return sx.contiguous(), sy.contiguous()


def warp_supersampled(images: torch.Tensor, g_inv: torch.Tensor) -> torch.Tensor:
    """The published 2x supersampled ADA warp of single-channel NHWC images
    (``tpu.ada_supersample``; the JAX package's ``_warp_supersampled``):
    the sym6 2x upsample along H, then along W (two matmuls with the dense
    operators of ``ss_updown_ops``, in the images' dtype and JAX's order of
    contraction), the warp kernel without antialiasing (tents of width 1)
    on the [B, 2H, 2W] grid, then the sym6 2x downsample along H, then
    along W. About 16x the direct warp's work. An identity transform is
    exact only in the interior: ``D @ U`` departs from the identity at the
    zero-extended borders, as in the published pipeline.

    Differentiable in the images only, as every warp of the port: the
    coordinates come from ``g_inv``, which comes from the draws, and are
    detached. (The JAX function is also differentiable in ``g_inv``;
    training never uses that.)"""
    b, h, w, c = images.shape
    if c != 1:
        msg = f"the ADA warp takes single-channel images, got {c} channels"
        raise ValueError(msg)
    uh, dh = _ss_tensors(h, images.dtype, images.device)
    uw, dw = _ss_tensors(w, images.dtype, images.device)
    x = torch.matmul(uh, images[..., 0])  # [B, 2H, W]
    x = torch.matmul(x, uw.T)  # [B, 2H, 2W]
    sx, sy = supersampled_coords(g_inv.detach().float(), h, w)
    ones = torch.ones(b, dtype=torch.float32, device=images.device)
    x = warp(x.contiguous(), sx, sy, ones, ones, antialias=False)
    x = torch.matmul(dh, x)  # [B, H, 2W]
    return torch.matmul(x, dw.T)[..., None]  # [B, H, W, 1]


def apply_color(images: torch.Tensor, cmat: torch.Tensor) -> torch.Tensor:
    """Apply per-sample 4x4 colour matrices to NHWC images (C in {1, 3})."""
    c = images.shape[-1]
    dtype = images.dtype
    if c == 3:
        m = cmat[:, :3, :3].to(dtype)
        t = cmat[:, :3, 3].to(dtype)
        return torch.einsum("bhwc,bdc->bhwd", images, m) + t[:, None, None, :]
    if c == 1:
        row = cmat[:, :3, :].mean(dim=1)  # [B,4]
        gain = row[:, :3].sum(dim=1).to(dtype)
        bias = row[:, 3].to(dtype)
        return images * gain[:, None, None, None] + bias[:, None, None, None]
    msg = f"apply_color supports 1 or 3 channels, got {c}"
    raise ValueError(msg)


def augment(
    images: torch.Tensor, p, draws: AugmentDraws, *, antialias: bool = True,
    supersample: bool = False,
) -> torch.Tensor:
    """ADA augmentation of an NHWC batch with application probability ``p``
    (the controller's output), deterministic given ``draws``;
    ``supersample`` takes the 2x supersampled warp (``warp_images``)."""
    b, h, w, c = images.shape
    p = torch.as_tensor(p, dtype=torch.float32, device=images.device)
    g_inv = geometric_matrix(draws.geom, h, w, p)
    out = warp_images(images, g_inv, antialias=antialias, supersample=supersample)
    return apply_color(out, color_matrix(draws.color, c, p))
