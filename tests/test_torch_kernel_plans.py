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
