"""The host-side halves of the port's CUDA kernels, on the CPU.

The instance-norm kernel takes its block layout from
``ops/cuda/instance_norm.py::plan``; the warp kernels run a fully unrolled
loop of ``tap_count(width)`` taps per axis from ``first_tap(c, width)``.
Both are checked here without a card: the plan at every instance-norm
site of serving, of the D step and of the fused step (the site lists
``chip_smoke.py`` times) against the card's limits, with every plane
assigned exactly once; the taps against the dense tents of the plain
version. No JAX.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from one_to_many_gan_torch.ops.cuda import instance_norm as in_module
from one_to_many_gan_torch.ops.cuda.warp import (
    AA_MAX_WIDTH,
    AA_MIN_TAPS,
    RADIUS,
    _tent,
    _tent_k,
    first_tap,
    tap_count,
)

DTYPES = {torch.float32: 4, torch.bfloat16: 2}


def _sites() -> list[tuple[int, int, int, int]]:
    """(B, C, H, W) of every instance-norm site of serving (B = 1 and 4),
    of one D step and of one fused step."""
    serve = [(b, c, h, w) for b in (1, 4) for c, h, w, _ in chip_smoke.ENCODE_SITES]
    train = [site[:4] for site in chip_smoke.D_IN_SITES + chip_smoke.FUSED_IN_SITES]
    return sorted(set(serve + train))


def _block_ranges(p: in_module.Plan, planes: int, hw: int) -> np.ndarray:
    """[grid, 2] (start, length) of each block's range of the flattened
    input, as the kernel computes it from the plan."""
    blk = np.arange(p.grid, dtype=np.int64)
    if p.cluster > 1:
        plane, rank = blk // p.cluster, blk % p.cluster
        piece = -(-hw // p.cluster)
        s0 = np.minimum(rank * piece, hw)
        s1 = np.minimum(s0 + piece, hw)
        return np.stack([plane * hw + s0, s1 - s0], axis=1)
    p0 = blk * p.planes_per_block
    n = np.minimum(p.planes_per_block, planes - p0)
    return np.stack([p0 * hw, n * hw], axis=1)


def test_the_site_lists_match_the_launch_counts():
    assert len(chip_smoke.D_IN_SITES) == chip_smoke.D_IN_PER_STEP == 12
    assert len(chip_smoke.FUSED_IN_SITES) == chip_smoke.G_IN_PER_STEP == 30


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("site", _sites())
def test_instance_norm_plan_covers_each_site_within_the_card(site, dtype):
    b, c, h, w = site
    planes, hw, esize = b * c, h * w, DTYPES[dtype]
    p = in_module.plan(planes, hw, dtype)
    assert p.smem_bytes + 1024 <= in_module.SMEM_PER_BLOCK == 232448
    assert p.cluster in (1, 2, 4, 8) and p.cluster <= in_module.MAX_CLUSTER
    assert 32 <= p.threads <= 1024 and p.threads & (p.threads - 1) == 0
    assert p.threads // p.planes_per_block >= 32
    assert (p.variant == "cluster") == (p.cluster > 1)
    assert (p.variant == "packed") == (hw * esize <= in_module.PACK_BYTES)
    assert p.grid == (planes * p.cluster if p.cluster > 1 else -(-planes // p.planes_per_block))
    ranges = _block_ranges(p, planes, hw)
    # every element (so every plane) in exactly one block's range, in order
    assert ranges[0, 0] == 0 and (ranges[:, 1] > 0).all()
    assert (ranges[1:, 0] == ranges[:-1, 0] + ranges[:-1, 1]).all()
    assert ranges[-1, 0] + ranges[-1, 1] == planes * hw
    # a packed or resident block holds whole planes; a cluster's blocks one plane
    if p.cluster == 1:
        assert (ranges[:, 0] % hw == 0).all() and (ranges[:, 1] % hw == 0).all()
    else:
        assert ((ranges[:, 0] // hw) == np.arange(p.grid) // p.cluster).all()
    # the largest range at the worst 16-byte offset fits the block's memory
    worst = (15 + ranges[:, 1].max() * esize + 15) // 16 * 16
    assert worst <= p.smem_bytes


def test_instance_norm_plan_picks_the_layout_by_plane_size():
    """Packed up to 16 KB a plane, resident up to 128 KB, then a cluster of
    8: serving's 512x256 float32 stem (512 KB planes) takes 8 blocks of
    64 KB each."""
    p = in_module.plan(64, 512 * 256, torch.float32)
    assert (p.variant, p.cluster, p.grid, p.threads) == ("cluster", 8, 512, 256)
    assert in_module.plan(16 * 512, 30 * 30, torch.bfloat16).planes_per_block == 8
    assert in_module.plan(16 * 256, 62 * 62, torch.bfloat16).planes_per_block == 2
    resident = in_module.plan(64, 256 * 256, torch.bfloat16)
    assert (resident.variant, resident.threads) == ("resident", 512)
    assert in_module.plan(64, 126 * 126, torch.bfloat16).threads == 256


def test_instance_norm_plan_refuses_what_it_cannot_take():
    largest = (in_module.MAX_DYNAMIC_SMEM - 16) // 4 * in_module.MAX_CLUSTER
    assert in_module.plan(1, largest, torch.float32).cluster == in_module.MAX_CLUSTER
    with pytest.raises(ValueError, match="shared memory"):
        in_module.plan(1, largest + 8, torch.float32)
    with pytest.raises(ValueError, match="blocks"):
        in_module.plan(2**34, 1, torch.float32)
    with pytest.raises(ValueError, match="planes"):
        in_module.plan(0, 16, torch.float32)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        in_module.plan(1, 16, torch.float64)


def _coords(rng: np.random.Generator, n: int) -> torch.Tensor:
    """Positions across the extended range and past it, integers,
    half-integers, the frame's edges and their float32 neighbours."""
    edges = np.array([0.0, n - 1.0, -0.5, n - 0.5, -RADIUS, n + RADIUS - 1.0, 0.5 * n])
    near = np.concatenate([np.nextafter(edges, -np.inf), edges, np.nextafter(edges, np.inf)])
    spread = rng.uniform(-RADIUS - 6, n + RADIUS + 6, 400)
    ints = np.arange(-RADIUS - 4, n + RADIUS + 4, dtype=np.float64)
    c = np.concatenate([near, spread, ints, ints + 0.5]).astype(np.float32)
    return torch.from_numpy(c)


def _widths() -> torch.Tensor:
    w = np.array([1.0, 1.5, 2.0, 2.5, 3.0, 3.3, 4.0], dtype=np.float32)
    below = np.nextafter(w, np.float32(0))
    above = np.nextafter(w[:-1], np.float32(5))
    u = np.random.default_rng(3).uniform(1, 4, 12).astype(np.float32)
    return torch.from_numpy(np.concatenate([w, below, above, u]))


def test_warp_tap_count_per_width():
    widths = torch.tensor([0.25, 1.0, 1.01, 1.5, 2.0, 2.01, 3.99, 4.0, 4.001, 0.0, -1.0,
                           float("nan"), float("inf")])
    assert tap_count(widths).tolist() == [3, 3, 4, 4, 5, 6, 9, 9, 0, 0, 0, 0, 0]
    assert tap_count(torch.tensor([AA_MAX_WIDTH])).item() == 2 * AA_MAX_WIDTH + 1
    assert tap_count(torch.tensor([1.0])).item() == AA_MIN_TAPS


@pytest.mark.parametrize("n", [16, 37])
def test_warp_taps_cover_every_nonzero_tent_weight(n):
    """The premise of the kernels' unrolled loops: every nonzero k of the
    dense tent (over the extended range the normaliser sums, and so over
    the frame) lies in [first_tap, first_tap + tap_count)."""
    c = _coords(np.random.default_rng(n), n)
    for width in _widths():
        wd = torch.full((1,), width.item())
        k = _tent_k(c[None, None], n, wd)[0, 0]  # [len(c), n + 2 RADIUS]
        idx = torch.arange(-RADIUS, n + RADIUS)
        lo = first_tap(c, wd)[:, None]
        inside = (idx >= lo) & (idx < lo + tap_count(wd))
        assert (k[~inside] == 0).all(), f"a tap outside the loop at width {width.item()!r}"
        weights = _tent(c[None, None], n, wd, True)[0, 0]
        frame = inside[:, RADIUS : RADIUS + n]
        assert (weights[~frame] == 0).all()
        # the loop is no longer than the support needs, plus one tap
        support = (k > 0).sum(dim=1)
        assert (support <= tap_count(wd) - 1).all()


# ---- the warp backward's gather: a mirror of its box arithmetic

_WARP_CU = (Path(__file__).resolve().parents[1] / "one_to_many_gan_torch/csrc/warp.cu").read_text()


def _cu_constant(name: str) -> float:
    """A constexpr of csrc/warp.cu, read from the source."""
    return float(re.search(rf"constexpr \w+ {name} = ([0-9.e+-]+);", _WARP_CU).group(1))


TILE_X, TILE_Y = int(_cu_constant("kTileX")), int(_cu_constant("kTileY"))
QUAD = int(_cu_constant("kQuad"))
REACH_SLACK, BOX_SLACK = 2.0**-18, _cu_constant("kBoxSlack")
FLOAT_SLACK, FLOAT_REL = np.float32(2.0**-10), np.float32(2.0**-20)
assert "kReachSlack = 0x1p-18;" in _WARP_CU
assert "kFloatSlack = 0x1p-10f;" in _WARP_CU and "kFloatRel = 0x1p-20f;" in _WARP_CU
f32 = np.float32


def _box_range(c, r, n: int):
    """The kernel's ``box_range`` (float64): [lo, hi] of [0, n) within
    c -/+ (r + slack)."""
    s = BOX_SLACK * (1.0 + np.abs(c) + r)
    return np.clip(np.ceil(c - r - s), 0, n), np.clip(np.floor(c + r + s), -1, n - 1)


def _box_range_f(c, r, n: int):
    """The kernel's ``box_range_f`` (float32)."""
    c, r = f32(c), f32(r)
    s = FLOAT_SLACK + FLOAT_REL * (np.abs(c) + r)
    return np.clip(np.ceil(c - r - s), 0, n), np.clip(np.floor(c + r + s), -1, n - 1)


def _gather_frame(sx: np.ndarray, sy: np.ndarray, wdx: np.float32, wdy: np.float32) -> dict:
    """One image's hint (float64, ``make_hint``), the coordinates'
    deviation from it (float32, the pre-pass) and the reach (float64,
    ``load_frame``), as the kernel computes them."""
    h, w = sx.shape
    ox, oy = float(sx[0, 0]), float(sy[0, 0])
    axx = (float(sx[0, w - 1]) - ox) / (w - 1) if w > 1 else 0.0
    ayx = (float(sy[0, w - 1]) - oy) / (w - 1) if w > 1 else 0.0
    axy = (float(sx[h - 1, 0]) - ox) / (h - 1) if h > 1 else 0.0
    ayy = (float(sy[h - 1, 0]) - oy) / (h - 1) if h > 1 else 0.0
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    window = ((sx > f32(-wdx - f32(1))) & (sx < f32(w) + wdx)
              & (sy > f32(-wdy - f32(1))) & (sy < f32(h) + wdy))
    with np.errstate(invalid="ignore", over="ignore"):
        ex = np.abs(sx - (f32(axx) * xs + (f32(axy) * ys + f32(ox))))[window]
        ey = np.abs(sy - (f32(ayx) * xs + (f32(ayy) * ys + f32(oy))))[window]
        det = axx * ayy - axy * ayx
    devx = float(ex.max()) if ex.size else 0.0
    devy = float(ey.max()) if ey.size else 0.0
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        inv = np.array([[ayy, -axy], [-ayx, axx]]) / det
    mag = 1 + abs(ox) + abs(oy) + (abs(axx) + abs(ayx)) * w + (abs(axy) + abs(ayy)) * h
    reach = (float(wdx) + devx + REACH_SLACK * mag, float(wdy) + devy + REACH_SLACK * mag)
    whole = not (det != 0 and np.isfinite([det, mag, *reach, *inv.ravel()]).all())
    return {"o": (ox, oy), "a": np.array([[axx, axy], [ayx, ayy]]), "inv": inv, "reach": reach,
            "whole": whole, "dev": (devx, devy)}


def _gather_visits(f: dict, h: int, w: int, qx: np.ndarray, qy: np.ndarray):
    """For taps q = (qx, qy) [Q]: which output pixels p [P = h*w] the
    gather visits for q: inside its block's region (float64), staged (the
    hint position of p, relative to the tile's corner, within the tile
    widened by the reach; float32) and inside the box of q's thread (the
    preimage of its quad, float32, from the tile corner's). -> bool [P, Q]."""
    ys, xs = np.mgrid[0:h, 0:w]
    px, py = xs.ravel()[:, None], ys.ravel()[:, None]
    if f["whole"]:
        return np.ones((h * w, qx.size), dtype=bool)
    (ox, oy), (ex, ey), inv, a = f["o"], f["reach"], f["inv"], f["a"]
    tx0, ty0 = qx // TILE_X * TILE_X, qy // TILE_Y * TILE_Y
    tx1, ty1 = np.minimum(tx0 + TILE_X, w) - 1, np.minimum(ty0 + TILE_Y, h) - 1
    cx, cy = 0.5 * (tx0 + tx1) - ox, 0.5 * (ty0 + ty1) - oy
    hx, hy = 0.5 * (tx1 - tx0) + ex, 0.5 * (ty1 - ty0) + ey
    rx0, rx1 = _box_range(inv[0, 0] * cx + inv[0, 1] * cy,
                          abs(inv[0, 0]) * hx + abs(inv[0, 1]) * hy, w)
    ry0, ry1 = _box_range(inv[1, 0] * cx + inv[1, 1] * cy,
                          abs(inv[1, 0]) * hx + abs(inv[1, 1]) * hy, h)
    region = (rx0 <= px) & (px <= rx1) & (ry0 <= py) & (py <= ry1)
    # the staging test, float32 from the region's corner
    h0x = f32(ox + a[0, 0] * rx0 + a[0, 1] * ry0 - tx0)
    h0y = f32(oy + a[1, 0] * rx0 + a[1, 1] * ry0 - ty0)
    ux, uy = f32(px - rx0), f32(py - ry0)
    stx = h0x + (f32(a[0, 0]) * ux + f32(a[0, 1]) * uy)
    sty = h0y + (f32(a[1, 0]) * ux + f32(a[1, 1]) * uy)
    fex, fey = f32(ex), f32(ey)
    fex, fey = (np.nextafter(v, f32(np.inf)) if float(v) < r else v
                for v, r in ((fex, ex), (fey, ey)))
    mx, my = FLOAT_SLACK + FLOAT_REL * np.abs(stx), FLOAT_SLACK + FLOAT_REL * np.abs(sty)
    staged = ((stx >= -fex - mx) & (stx <= f32(tx1 - tx0) + fex + mx)
              & (sty >= -fey - my) & (sty <= f32(ty1 - ty0) + fey + my))
    # the box of q's thread (its QUAD x QUAD quad), float32 from the tile
    # corner's preimage
    dx, dy = tx0 - ox, ty0 - oy
    c0x, c0y = f32(inv[0, 0] * dx + inv[0, 1] * dy), f32(inv[1, 0] * dx + inv[1, 1] * dy)
    half = 0.5 * (QUAD - 1)
    dqx = f32((qx - tx0) // QUAD * QUAD + half)
    dqy = f32((qy - ty0) // QUAD * QUAD + half)
    fi = inv.astype(np.float32)
    bx = np.nextafter(f32(abs(inv[0, 0]) * (ex + half) + abs(inv[0, 1]) * (ey + half)), f32(9e9))
    by = np.nextafter(f32(abs(inv[1, 0]) * (ex + half) + abs(inv[1, 1]) * (ey + half)), f32(9e9))
    bx0, bx1 = _box_range_f(c0x + (fi[0, 0] * dqx + fi[0, 1] * dqy), bx, w)
    by0, by1 = _box_range_f(c0y + (fi[1, 0] * dqx + fi[1, 1] * dqy), by, h)
    own = (bx0 <= px) & (px <= bx1) & (by0 <= py) & (py <= by1)
    return own & region & staged


def _gather_cases() -> dict:
    """name -> (sx, sy, width_x, width_y, antialias): ADA draws at p = 1
    (their rotations, flips, scalings and translations), and
    ``chip_smoke.gather_transforms``' rotations by multiples of 90 degrees
    with and without the x-flip, 4x minification (tents to the width cap)
    and 4x magnification, each with and without antialias; and random
    coordinates."""
    from one_to_many_gan_torch.augment.pipeline import (
        draw_augment,
        geometric_matrix,
        source_coords,
        tent_widths,
    )

    b, h, w = 8, 40, 48
    gen = torch.Generator().manual_seed(1)
    transforms = {"ada_p1": geometric_matrix(draw_augment(gen, b, "cpu").geom, h, w,
                                             torch.tensor(1.0)),
                  **chip_smoke.gather_transforms(torch, gen, b, h, w, "cpu")}
    cases = {}
    for name, g in transforms.items():
        sx, sy = source_coords(g, h, w)
        for aa in (True, False):
            cases[f"{name}_aa{int(aa)}"] = (sx, sy, *tent_widths(g, antialias=aa), aa)
    rs = [torch.rand((4, 8, 8), generator=gen) * 12 - 2 for _ in range(2)]
    cases["random_8x8_aa1"] = (*rs, torch.full((4,), 1.5), torch.full((4,), 2.5), True)
    return cases


GATHER_CASES = _gather_cases()


@pytest.mark.parametrize("name", sorted(GATHER_CASES))
def test_warp_gather_visits_every_nonzero_term(name):
    """Every (output pixel p, tap q) pair whose two tent weights are nonzero
    (the plain version's ``_tent``) is visited by the gather for q: p lies
    in q's own box, in its block's region, and is staged there."""
    sx, sy, wx, wy, aa = GATHER_CASES[name]
    b, h, w = sx.shape
    mx = (_tent(sx, w, wx, aa) != 0).numpy()  # [B, H, W, W']
    my = (_tent(sy, h, wy, aa) != 0).numpy()  # [B, H, W, H']
    qy, qx = (v.ravel() for v in np.mgrid[0:h, 0:w])
    terms = 0
    for i in range(b):
        f = _gather_frame(sx[i].numpy(), sy[i].numpy(), wx[i].numpy(), wy[i].numpy())
        need = (my[i].reshape(h * w, h, 1) & mx[i].reshape(h * w, 1, w)).reshape(h * w, h * w)
        missed = need & ~_gather_visits(f, h, w, qx, qy)
        assert not missed.any(), f"image {i}: {missed.sum()} terms outside the gather's boxes"
        terms += need.sum()
    assert terms > 0


@pytest.mark.parametrize("name", ["ada_p1_aa1", "rot90_flip_aa1", "minify_4x_aa1",
                                  "magnify_4x_aa0"])
def test_warp_gather_boxes_stay_tight_on_the_systems_coordinates(name):
    """On affine coordinates (``source_coords``) the measured deviation is
    float32 rounding, far below 2^-8 px, and each tap visits few output
    pixels beyond those that reach it: the gather's cost follows the
    terms, not the frame."""
    sx, sy, wx, wy, aa = GATHER_CASES[name]
    b, h, w = sx.shape
    qy, qx = (v.ravel() for v in np.mgrid[0:h, 0:w])
    visits = need = 0
    for i in range(b):
        f = _gather_frame(sx[i].numpy(), sy[i].numpy(), wx[i].numpy(), wy[i].numpy())
        assert not f["whole"] and max(f["dev"]) < 2.0**-8
        visits += _gather_visits(f, h, w, qx, qy).sum()
    mx = _tent(sx, w, wx, aa) != 0
    my = _tent(sy, h, wy, aa) != 0
    need = (mx.sum(-1) * my.sum(-1)).sum().item()
    assert visits <= 4 * need + 16 * b * h * w


def test_warp_gather_takes_the_whole_frame_without_a_usable_hint():
    """A NaN or infinite corner, or three collinear corners, leave no hint:
    every tap's box is the whole frame."""
    sx = np.tile(np.arange(8, dtype=np.float32), (8, 1))
    sy = sx.T.copy()
    one = np.float32(1)
    assert not _gather_frame(sx, sy, one, one)["whole"]
    for bad in (np.nan, np.inf):
        corner = sx.copy()
        corner[0, 7] = bad
        assert _gather_frame(corner, sy, one, one)["whole"]
    assert _gather_frame(sx, sx.copy(), one, one)["whole"]  # sy = sx: singular
