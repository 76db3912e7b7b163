"""Drive the port's data and spatial parallelism on several NVIDIA cards
of one host.

    python3 scripts/multi_card_smoke.py [--cards N] [--checks abcdefg]

Run it from the repository root on a host with N CUDA cards (default 4;
H100s: the kernels are built for sm_90a). It builds the CUDA kernels once
(``ops/cuda/build.build_kernels``), then:

(a) the instance-norm kernel at the production step's sites and the warp
    forward and backward at [8, 512, 512], float32 and bfloat16, antialias
    on and off, on every card but the first, against their plain versions
    at ``chip_smoke.py``'s limits (phases 2, 7 and 10), and the int8
    pre-pass and fused conv at phase 18's ragged shapes and a resnet-block
    site, float32 and bfloat16, both pad modes, bitwise; and the split
    instance norm (the spatial axis's partials and apply) at
    ``chip_smoke.py`` phase 19's sites, cut into 2 and 4 bands, against its
    plain version and the whole-plane kernel;
(b) the fused step at phase 11's config in float32 (256x256, global batch
    16, TF32 off, deterministic kernels), N ranks against one card, each
    step from the one card's state before it (its checkpoint dict) with
    the one card's ReLU / LeakyReLU pattern pinned, each rank its rows
    (``ops/activations.py``): a path step and another, metrics within the
    step tolerance, every gradient within ``PINNED_GRAD_RTOL`` of its
    leaf's largest entry, parameters within the step tolerance wherever
    Adam must move them alike (at least ``MIN_HELD_PINNED`` of them), the
    flipped kinks counted, and the ranks' parameters, buffer and ADA state
    bitwise equal; then two runs of 3 steps on N ranks from seed 0,
    bitwise equal;
(c) ``configs/tpu_v5e8_512.toml`` as N cards run it
    (``presets.write_card_config``: with N = 4 only ``spatial_parallel`` 2
    -> 1; global batch 32, 8 a card): 18 bare steps on synthetic batches,
    each phase synchronised and timed, per step kind (R1 + path, path,
    other) and 8 more as a loop runs them, beside one card's plain step
    (one replica's copy, no group) run the same way in the same call, and
    phase 15's images/s; every card's peak memory and launches per phase
    (phase 15's), the all-reduce of each optimiser's gradient buffer timed
    with its bytes, and one step under ``torch.profiler`` on every card
    (NCCL kernels, idle share);
(d) that config's ``Trainer`` through the training CLI (one command starts
    the N ranks), under deterministic kernels, on 512x512 image folders:
    16 steps, a one-card server on the checkpoint, a resume to 32 that
    ``POST /reload`` then serves; rank 0's files written once; ``32.tar``
    bitwise equal to an uninterrupted N-rank run's;
(e) the server of ``configs/default.toml`` (512x256, float32, fresh
    weights) with ``--data-parallel N`` against one card, float and int8
    (``--int8``): ``/generate`` at n = 8, 32 and 64, the images within
    1e-5 of one card's (int8: as far as int8 may be from float32, the
    flipped codes counted);
(f) (b) with a spatial axis: phase 11's config with R1 (gamma 10 every
    2nd step) at data N/2 x spatial 2 (each card half the rows of its data
    row's images), against one card with its kinks pinned (each rank its
    rows and band of every mask): a path + R1 step and another, the same
    limits, the ranks' states bitwise equal, two deterministic runs
    bitwise equal, and the split norm's launches (none of the whole-plane
    kernel);
(g) ``configs/tpu_v5e8_512.toml`` at data N/2 x spatial 2 with the global
    batch as written (``write_card_config(..., spatial=True)``: with N = 4
    only ``data_parallel`` 4 -> 2; ``native_loader`` false) beside data N
    x spatial 1 (c's config) in the same call, 18 bare steps each as (c)
    runs them (an R1 + path step at 0 and 16, path steps at 8): images/s,
    every card's peak memory and launches per phase, the halo exchanges of
    one step (pieces, bytes; their NCCL ``SendRecv`` kernels' ms in the
    profiled step), the instance norms' all-gathers (count, bytes, timed
    alone), the idle share per card; then its ``Trainer`` through the CLI
    under deterministic kernels on 512x512 folders: 8 steps, a resume to
    16, and 16 uninterrupted steps, the two ``16.tar`` bitwise equal.

``--checks`` runs only the lettered checks it names (all by default).
``nvidia-smi topo -m`` and every card's name and power limit are printed.
Any failed check raises and the script exits non-zero; every number goes
to ``chiprun_out/multi_card_smoke.json`` (``multi_card_smoke_<checks>.json``
for a part of them); the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import hashlib
import io
import json
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

OUT = ROOT / "chiprun_out" / "multi_card_smoke.json"
# chip_smoke.py phase 15's mean step of the production config on one card
# (PERF.md section 6; an H100 80GB HBM3 at 700 W): 8 images in 536.61 ms.
ONE_CARD_IMAGES_PER_S = 14.91
STEP_KINDS = ("r1_path", "path", "other")
SERVE_REPS = 5
# (c): steps after the 18 timed per phase, timed together as a training
# loop runs them (no synchronisation between phases or steps): steps 18-25
# hold one path step (24) and no R1 step.
LOOP_STEPS = 8
SERVE_TOL = 1e-5
# (e), int8: each card quantises its own rows with per-sample scales, so
# its codes are one card's wherever its float inputs are. The cards' float
# parts differ by up to SERVE_TOL, and a value within that of a rounding
# tie takes the neighbouring code, whose step then flips codes downstream
# (chip_smoke.py phase 18c): the images are held as int8 to float32, mean
# |delta| under chip_smoke.INT8_MEAN_LEVELS uint8 levels and a tanh PSNR
# above chip_smoke.INT8_PSNR_FLOOR, with the flipped codes counted.
# (b), with the one card's kinks pinned on the ranks: the ranks' gradients
# differ from one card's by float summation order only (each rank's convs
# at a quarter of the batch, the all-reduce's mean). Four H100s, pinned,
# read 2.193e-4 / 2.195e-4 of a leaf's largest entry (the first convs of
# the encoder, whose weight gradients sum over every pixel of the batch)
# and held 0.9969 / 0.9772 of the parameters on the path step / the other
# step, the same in two runs (PERF.md, section 6). Limits: PINNED_GRAD_RTOL
# (the step tolerance's 2e-4 is just below the readings; the unpinned
# limit was 2e-2) and MIN_HELD_PINNED (chip_smoke.held_mask; was 0.5).
PINNED_GRAD_RTOL = 4e-4
MIN_HELD_PINNED = 0.95
# (f) and (g)'s ranks: a collective that waits longer than this raises
# (the default, 1800 s, leaves room for an evaluation these ranks never run).
COLLECTIVE_TIMEOUT_S = 600.0


def log(msg: str) -> None:
    print(msg, flush=True)


def _digest(torch, tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().reshape(-1).contiguous().cpu().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def _state_digest(torch, state) -> str:
    from one_to_many_gan_torch.parallel.mesh import _state_tensors

    return _digest(torch, _state_tensors(state))


def _smi() -> list[str]:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()


def _topology() -> str:
    proc = subprocess.run(["nvidia-smi", "topo", "-m"], capture_output=True, text=True,
                          timeout=60, check=False)
    return proc.stdout.strip() or proc.stderr.strip()


def _free(torch) -> None:
    """Give this process's cached card memory back before other processes
    (the ranks) need it: the step's closures and state hold cycles."""
    gc.collect()
    torch.cuda.empty_cache()
    held = [torch.cuda.memory_reserved(d) / 2**30 for d in range(torch.cuda.device_count())]
    cs.check(max(held) < 1.0, f"this process still holds {held} GiB of the cards")


def _counters():
    from one_to_many_gan_torch.ops.cuda import fused_instance_norm, warp, warp_bwd

    return (warp, warp_bwd, fused_instance_norm)


def _split_counters():
    """The split instance norm's two kernels (the spatial axis)."""
    from one_to_many_gan_torch.ops.cuda import instance_norm as in_module

    return (in_module.instance_norm_partials, in_module.instance_norm_apply)


def _slice_kinks(masks, group) -> list:
    """A rank's part of one card's kink pattern: its data row's rows of each
    mask and, with a spatial axis, its band of a feature map's (NCHW)."""
    out = []
    for m in masks:
        m = group.shard(m)
        if group.spatial is not None and m.dim() == 4:
            lo, hi = group.spatial.band(m.shape[2])
            m = m[:, :, lo:hi]
        out.append(m)
    return out


# -------------------------------------------------------------------- (a)


def kernels_on_cards(torch, cards: int) -> list:
    """The four kernels on cards 1..N-1 against their plain versions."""
    from one_to_many_gan_torch.ops.cuda import (
        fused_instance_norm,
        instance_norm_plain,
        int8_prepass,
        warp,
        warp_bwd,
        warp_bwd_plain,
        warp_plain,
    )
    from one_to_many_gan_torch.ops.cuda.int8_conv import int8_prepass_plain

    cases = []
    for d in range(1, cards):
        with torch.cuda.device(d):
            gen = torch.Generator("cuda").manual_seed(d)
            worst = {}
            for dtype_name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
                err = 0.0
                for b, c, h, w, relu in sorted(set(cs.P_STEP_IN_SITES)):
                    x = (torch.randn((b, c, h, w), generator=gen, device="cuda") * 2 + 0.5)
                    x = x.to(dtype)
                    got = fused_instance_norm(x, relu=relu)
                    want = instance_norm_plain(x, relu=relu)
                    err = max(err, (got.float() - want.float()).abs().max().item())
                cs.check(err <= cs.IN_TOL[dtype_name],
                         f"cuda:{d}: instance norm {dtype_name} off its plain version by {err}")
                worst[f"instance_norm_{dtype_name}"] = err
                for aa in (False, True):
                    x, sx, sy, wx, wy = cs._warp_inputs(torch, gen, cs.P_BATCH, cs.P_SIZE,
                                                        cs.P_SIZE, dtype, aa)
                    got = warp(x, sx, sy, wx, wy, antialias=aa)
                    want = warp_plain(x, sx, sy, wx, wy, antialias=aa)
                    diff = (got.double() - want.double()).abs()
                    err = diff.max().item()
                    if dtype == torch.float32:
                        cs.check(err <= cs.WARP_TOL_F32, f"cuda:{d}: warp f32 aa={aa}: {err}")
                    else:
                        mag = torch.maximum(got.double().abs(), want.double().abs())
                        ulp = torch.exp2(torch.floor(torch.log2(mag.clamp_min(2.0**-126))) - 7)
                        bound = cs.WARP_TOL_BF16_SUM * x.abs().max().item()
                        excess = ((diff - ulp).clamp_min(0) / bound).max().item()
                        cs.check(excess <= 1.0 and err <= cs.WARP_TOL_BF16_ABS,
                                 f"cuda:{d}: warp bf16 aa={aa}: {err}, {excess} of the bound")
                    worst[f"warp_fwd_{dtype_name}_aa{int(aa)}"] = err
                    dout = torch.randn(x.shape, generator=gen, device="cuda").to(dtype)
                    coords = (sx, sy, wx, wy)
                    got = warp_bwd(dout, *coords, antialias=aa)
                    want = warp_bwd_plain(dout, *coords, antialias=aa)
                    torch.cuda.synchronize()
                    res = cs._check_bwd(torch, got, want, dout, coords, aa,
                                        f"cuda:{d} warp_bwd {dtype_name} aa={aa}")
                    worst[f"warp_bwd_{dtype_name}_aa{int(aa)}"] = res["max_abs_err"]
            for shape in cs.INT8_RAGGED + ((8, 256, 128, 64, 256),):
                for site in cs.random_sites(torch, gen, *shape):
                    x_scale = int8_prepass(site["x"], site["s"], site["dtype"])
                    cs.check(torch.equal(x_scale, int8_prepass_plain(site["x"], site["s"],
                                                                     site["dtype"]))
                             and torch.equal(cs.int8_run(site), cs.int8_run(site, plain=True)),
                             f"cuda:{d}: int8 kernels differ from their plain versions at "
                             f"{cs._site_label(site)}")
            worst["int8_prepass"] = worst["int8_conv"] = 0.0
            for dtype_name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
                err = 0.0
                for b, c, h, w, relu in sorted(set(cs.SP_IN_SITES)):
                    x = (torch.randn((b, c, h, w), generator=gen, device="cuda") * 2 + 0.5)
                    x = x.to(dtype)
                    whole = fused_instance_norm(x, relu=relu)
                    for spatial in cs.SP_SPLITS:
                        got, _ = cs._split_norm(torch, x, spatial, relu, kernel=True)
                        plain, _ = cs._split_norm(torch, x, spatial, relu, kernel=False)
                        err = max(err, (got.float() - plain.float()).abs().max().item(),
                                  (got.float() - whole.float()).abs().max().item())
                    del x, whole, got, plain
                cs.check(err <= cs.IN_TOL[dtype_name], f"cuda:{d}: split instance norm "
                         f"{dtype_name} off its plain version or the whole plane by {err}")
                worst[f"split_instance_norm_{dtype_name}"] = err
            torch.cuda.synchronize()
        log(f"(a) cuda:{d}: every kernel within its limit; largest errors "
            + ", ".join(f"{k} {v:.3g}" for k, v in worst.items()))
        cases.append({"device": d, "max_abs_err": worst})
        torch.cuda.empty_cache()
    return cases


# -------------------------------------------------------------------- (b)


def _step_snapshot(torch, state, metrics) -> dict:
    return cs._snapshot_step(torch, state, metrics, 1)


def _pack_kinks(masks) -> list:
    """A recorded kink pattern as (shape, packed bits) per activation call."""
    return [(tuple(m.shape), np.packbits(m.numpy().reshape(-1))) for m in masks]


def _unpack_kinks(torch, packed) -> list:
    return [torch.from_numpy(np.unpackbits(bits, count=int(np.prod(shape))).astype(bool)
                             .reshape(shape)) for shape, bits in packed]


def _rank_step_check(group, config, det_config, work: str, n_steps: int, det_steps: int):
    """(b) and (f) on one rank: the steps from the one card's states, then
    two deterministic runs from seed 0. Rank 0 writes its snapshots; every
    rank writes digests and launch counts (the whole-plane and the split
    instance norm's)."""
    import torch

    from one_to_many_gan_torch import train
    from one_to_many_gan_torch.core.state import Models, init_train_state
    from one_to_many_gan_torch.core.train_step import Batches, make_train_step
    from one_to_many_gan_torch.migrate import from_reference_checkpoint
    from one_to_many_gan_torch.ops import activations
    from one_to_many_gan_torch.parallel import replicate

    work = Path(work)
    counters = _counters() + _split_counters()
    dev = group.device
    models = Models(config, device=dev, seed=0)
    state = init_train_state(config, models, seed=0)
    step_fn = make_train_step(config, models, group)
    out = {"rank": group.rank, "digests": [], "launches": [], "det": [], "flips": []}
    for k in range(n_steps):
        data = torch.load(work / f"step{k}.pt", map_location="cpu", weights_only=False)
        state = from_reference_checkpoint(data["ckpt"], state, step=k)
        batches = Batches(*(group.shard(b).to(dev) for b in data["batches"]))
        masks = _unpack_kinks(torch, data["kinks"])
        c0 = [c.launches for c in counters]
        # the one card's kinks, this rank's rows (and band) of each
        # (tests/test_torch_parallel.py, tests/test_torch_spatial.py)
        with activations.pin(_slice_kinks(masks, group)) as pinned:
            state, metrics = step_fn(state, batches, cs._to(data["draws"], dev))
        torch.cuda.synchronize()
        cs.check(len(pinned.flips) == len(masks),
                 f"rank {group.rank} ran {len(pinned.flips)} activations, one card {len(masks)}")
        out["flips"].append([pinned.n_flips(), sum(m.numel() for m in masks) // group.world])
        del masks
        out["launches"].append(cs._phase_counts(counters, c0))
        out["digests"].append(_state_digest(torch, state))
        if group.is_main:
            torch.save(_step_snapshot(torch, state, metrics), work / f"ranks{k}.pt")
    del models, state, step_fn
    torch.cuda.empty_cache()
    for _ in range(2):
        models, state, gen = train.setup(det_config, seed=0, ada_p=cs.D_ADA_P, device=dev)
        replicate(group, state)
        step_fn = make_train_step(det_config, models, group)
        ms = []
        for _ in range(det_steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = train.run_step(det_config, models, state, step_fn, gen, group)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        out["det"].append({"digest": _state_digest(torch, state), "ms": ms,
                           "metrics": {k: v.item() for k, v in metrics.items()}})
        del models, state, step_fn
        torch.cuda.empty_cache()
    (work / f"rank{group.rank}.json").write_text(json.dumps(out))


def step_against_one_card(torch, cards: int, spatial: int = 1) -> dict:
    """(b), or with ``spatial`` 2 (f): the fused step on ``cards`` ranks
    against one card."""
    from one_to_many_gan_torch import train
    from one_to_many_gan_torch.core.train_step import Batches, draw_step, make_train_step
    from one_to_many_gan_torch.core.train_step import synthetic_batch
    from one_to_many_gan_torch.device import use_deterministic_kernels
    from one_to_many_gan_torch.migrate import to_reference_checkpoint
    from one_to_many_gan_torch.ops import activations
    from one_to_many_gan_torch.parallel import distributed

    config = cs.d_phase_config("float32", cs.D_BATCH, path_interval=cs.G_INTERVAL)
    config["training"]["deterministic_cuda_kernels"] = True
    det_config = cs.d_phase_config("bfloat16", cs.D_BATCH, path_interval=cs.G_INTERVAL)
    det_config["training"]["deterministic_cuda_kernels"] = True
    label = "(b)" if spatial == 1 else "(f)"
    for c in (config, det_config):
        c["tpu"]["spatial_parallel"] = spatial
        if spatial > 1:  # step 0 also an R1 step
            c["tpu"].update(r1_gamma=10.0, r1_interval=2)
    lr = config["optimisation"]["learning_rate"]
    use_deterministic_kernels()
    steps = 2  # a path (+ R1) step, then another
    with tempfile.TemporaryDirectory(dir=ROOT / "chiprun_out") as tmp:
        work = Path(tmp)
        models, state, gen = train.setup(config, seed=0, ada_p=cs.D_ADA_P, device="cuda")
        step_fn = make_train_step(config, models)
        one = []
        for k in range(steps):
            b = config["training"]["batch_size"]
            batches = [synthetic_batch(gen, b, models.image_size, models.channels)
                       for _ in range(4)]
            draws = draw_step(gen, config, models)
            ckpt = to_reference_checkpoint(state)
            with activations.record() as kinks:
                state, metrics = step_fn(state, Batches(*batches), draws)
            torch.save({"ckpt": ckpt, "batches": batches, "draws": draws,
                        "kinks": _pack_kinks(kinks.masks)}, work / f"step{k}.pt")
            one.append(_step_snapshot(torch, state, metrics))
            del ckpt, kinks
        del models, state, step_fn, batches, draws, metrics
        _free(torch)
        t0 = time.perf_counter()
        distributed.spawn(_rank_step_check, cards, "cuda",
                          (config, det_config, str(work), steps, cs.DP_STEPS), spatial=spatial,
                          timeout_s=COLLECTIVE_TIMEOUT_S)
        spawn_s = time.perf_counter() - t0
        ranks = [json.loads((work / f"rank{r}.json").read_text()) for r in range(cards)]
        got = [torch.load(work / f"ranks{k}.pt", weights_only=False) for k in range(steps)]
    # every step's readings first, then the limits on them
    errs = [cs.compare_steps(torch, got[k], one[k], lr, first=k == 0,
                             label=f"{cards} ranks against one card, step {k}",
                             grad_rtol=float("inf"), min_held=0.0) for k in range(steps)]
    readings = [{key: e[key] for key in ("grad_rel", "grad_worst", "held_share")} for e in errs]
    flips = [[r["flips"][k] for r in ranks] for k in range(steps)]
    log(f"{label} pinned readings per step: {readings}; flipped kinks, inputs per rank and step "
        f"{flips}")
    cs.check(all(e["grad_rel"] <= PINNED_GRAD_RTOL and e["held_share"] >= MIN_HELD_PINNED
                 for e in errs),
             f"{label} readings {readings} against gradients <= {PINNED_GRAD_RTOL} of a leaf's "
             f"largest entry and >= {MIN_HELD_PINNED} of the parameters held")
    for k in range(steps):
        cs.check(all(r["digests"][k] == ranks[0]["digests"][k] for r in ranks),
                 f"step {k}: the ranks' states differ")
    for k in range(steps):
        # (f): step 0 is an R1 step, whose D pass on the reals adds the trunk's 3
        n_in = cs.G_IN_PER_STEP + (3 if spatial > 1 and k == 0 else 0)
        want = [cs.G_WARPS_PER_STEP, cs.G_WARP_BWDS_PER_STEP]
        want += [n_in, 0, 0] if spatial == 1 else [0, n_in, n_in]
        cs.check(all(r["launches"][k] == want for r in ranks),
                 f"step {k}: launches per rank {[r['launches'][k] for r in ranks]} "
                 f"(want {want}: warp, warp_bwd, IN, split partials, split apply)")
    cs.check(all(r["det"][0]["digest"] == r["det"][1]["digest"] for r in ranks),
             "two deterministic runs on the ranks differ")
    cs.check(all(r["det"][0]["digest"] == ranks[0]["det"][0]["digest"] for r in ranks),
             "the ranks' states differ after the deterministic runs")
    log(f"{label} fused step ({cs.D_SIZE}x{cs.D_SIZE}, global batch {cs.D_BATCH}, float32, "
        f"data {cards // spatial} x spatial {spatial}), "
        f"{cards} ranks against one card, its kinks pinned (flips, inputs per rank and step "
        f"{flips}): "
        + "; ".join(f"step {k}: metrics {e['metric_rel']:.3g} relative, gradients "
                    f"{e['grad_rel']:.3g} of each leaf's largest entry, parameters "
                    f"{e['param_err_held']:.3g} where held ({e['held_share']:.4f}), "
                    f"{e['param_err']:.3g} anywhere" for k, e in enumerate(errs))
        + f"; ranks bitwise equal; two deterministic {cs.DP_STEPS}-step runs (bfloat16) "
        f"bitwise equal, step ms {[round(t, 1) for t in ranks[0]['det'][0]['ms']]}; "
        f"launches per card and step {ranks[0]['launches'][0]}; ranks' process {spawn_s:.1f} s")
    return {"errors": errs, "launches": {r["rank"]: r["launches"] for r in ranks},
            "flips": flips, "deterministic_ms": [r["det"][0]["ms"] for r in ranks],
            "spawn_s": spawn_s}


# -------------------------------------------------------------------- (c)


def _rank_production(group, config, work: str, plain: bool = False):
    """(c) on one rank: 18 bare steps, each phase synchronised and timed;
    LOOP_STEPS more synchronised only at their ends (as a training loop
    runs them); the all-reduce of each optimiser's buffer; one profiled
    step. ``plain``: the one-card step without a group (a world of one
    process), the baseline."""
    import torch
    import torch.distributed as dist

    from one_to_many_gan_torch import train
    from one_to_many_gan_torch.core.train_step import (
        Batches,
        draw_step,
        make_d_phase,
        make_g_phase,
        shard_draws,
        synthetic_batch,
    )
    from one_to_many_gan_torch.parallel import replicate

    counters = _counters() + _split_counters()
    b_global = config["training"]["batch_size"]
    models, state, gen = train.setup(config, seed=0, ada_p=cs.D_ADA_P, device=group.device)
    dp = None if plain else group
    replicate(dp, state)
    d_phase = make_d_phase(config, models, dp)
    g_phase = make_g_phase(config, models, dp)

    def inputs():
        batches = [synthetic_batch(gen, b_global, (cs.P_SIZE, cs.P_SIZE), 1) for _ in range(4)]
        draws = draw_step(gen, config, models)
        if dp is None:
            return Batches(*batches), draws
        return Batches(*map(dp.shard, batches)), shard_draws(draws, dp)

    for c in counters:
        c.launches = 0
    rows = []
    for step in range(cs.P_BARE_STEPS):
        b, draws = inputs()
        p_used = state.ada.p
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        c0 = [c.launches for c in counters]
        t0 = time.perf_counter()
        state, dm = d_phase(state, b.d_shoeprints, b.d_shoemarks, draws.d)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        d_peak = torch.cuda.max_memory_allocated()
        d_counts = cs._phase_counts(counters, c0)
        torch.cuda.reset_peak_memory_stats()
        c0 = [c.launches for c in counters]
        state, gm = g_phase(state, b, draws.g, p_used)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        rows.append({"step": step, "d_ms": (t1 - t0) * 1e3, "g_ms": (t2 - t1) * 1e3,
                     "ms": (t2 - t0) * 1e3, "d_peak": d_peak,
                     "g_peak": torch.cuda.max_memory_allocated(), "d_launches": d_counts,
                     "g_launches": cs._phase_counts(counters, c0),
                     **{k: v.item() for k, v in {**dm, **gm}.items()}})
    launches = [c.launches for c in counters]
    loop_inputs = [inputs() for _ in range(LOOP_STEPS)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b, draws in loop_inputs:
        p_used = state.ada.p
        state, _ = d_phase(state, b.d_shoeprints, b.d_shoemarks, draws.d)
        state, _ = g_phase(state, b, draws.g, p_used)
    torch.cuda.synchronize()
    loop_ms = (time.perf_counter() - t0) * 1e3 / LOOP_STEPS
    del loop_inputs
    flats = {k: torch.zeros(sum(p.numel() for p in m.parameters()), device=group.device)
             for k, m in (("d", state.discriminator), ("g", state.generator),
                          ("m", state.mapping), ("s", state.extractor))}
    allreduce = {k: {"bytes": f.numel() * 4,
                     "ms": cs._cuda_ms(torch, lambda f=f: dist.all_reduce(f), 20)}
                 for k, f in flats.items()}
    del flats

    def one_step():
        b, draws = inputs()
        p_used = state.ada.p
        d_phase(state, b.d_shoeprints, b.d_shoemarks, draws.d)
        g_phase(state, b, draws.g, p_used)

    state.step = 3 * cs.P_INTERVAL + 1  # another step
    sp = None if dp is None else dp.spatial
    exchanges = {}
    if sp is not None:  # what one other step exchanges over the spatial group
        sp.log = []
        one_step()
        torch.cuda.synchronize()
        for kind, shape, nbytes in sp.log:
            e = exchanges.setdefault(kind, {"count": 0, "bytes": 0, "shapes": {}})
            e["count"] += 1
            e["bytes"] += nbytes
            e["shapes"][str(shape)] = e["shapes"].get(str(shape), 0) + 1
        # the instance norms' all-gathers alone, each shape timed
        in_ms = 0.0
        for shape, n in exchanges.get("in_partials", {}).get("shapes", {}).items():
            size, planes = (int(v) for v in shape.strip("()").split(", ")[:2])
            part = torch.zeros((planes, 2), device=group.device)
            out = torch.empty((size * planes, 2), device=group.device)
            in_ms += n * cs._cuda_ms(torch, lambda o=out, q=part: dist.all_gather_into_tensor(
                o, q, group=sp.pg), 10)
        exchanges["in_partials_ms_alone"] = in_ms
        sp.log = None
    with contextlib.redirect_stdout(io.StringIO()):
        prof = cs.profile_call(torch, one_step, f"rank {group.rank}",
                               select=lambda n: "nccl" in n.lower())
    (Path(work) / f"rank{group.rank}.json").write_text(json.dumps({
        "rank": group.rank, "rows": rows, "launches": launches, "allreduce": allreduce,
        "loop_ms": loop_ms, "loop_first_step": cs.P_BARE_STEPS, "exchanges": exchanges,
        "profile": {k: prof[k] for k in ("wall_ms", "busy_ms", "idle_share")},
        "nccl": prof["selected"], "top": prof["kernels"][:8]}))


def _summary(ranks: list, b_global: int) -> dict:
    """Medians per step kind and the mean of the 16 timed steps (a step
    ends when its slowest card ends: the collectives wait for it), the
    loop's mean, images/s, per-card peaks."""
    timed = {r["rank"]: r["rows"][cs.P_BARE_WARMUP:] for r in ranks}

    def kind(step):
        if step % cs.P_R1_INTERVAL == 0:
            return "r1_path"
        return "path" if step % cs.P_INTERVAL == 0 else "other"

    steps = [{f: max(timed[r][i][f] for r in timed) for f in ("ms", "d_ms", "g_ms")}
             | {"step": timed[0][i]["step"]} for i in range(len(timed[0]))]
    med = {k: {f: statistics.median(s[f] for s in steps if kind(s["step"]) == k)
               for f in ("ms", "d_ms", "g_ms")} for k in STEP_KINDS}
    mean = statistics.fmean(s["ms"] for s in steps)
    loop = max(r["loop_ms"] for r in ranks)
    return {"steps": steps, "median": med, "mean_ms": mean,
            "images_per_s": b_global / mean * 1e3, "loop_ms": loop,
            "loop_images_per_s": b_global / loop * 1e3,
            "peak_gib": {r["rank"]: {"d_gib": max(x["d_peak"] for x in r["rows"]) / 2**30,
                                     "g_gib": max(x["g_peak"] for x in r["rows"]) / 2**30}
                         for r in ranks}}


def _line(label: str, s: dict) -> str:
    m = s["median"]
    return (f"{label}: median step ms R1 + path {m['r1_path']['ms']:.2f} (D "
            f"{m['r1_path']['d_ms']:.2f}, G {m['r1_path']['g_ms']:.2f}), path "
            f"{m['path']['ms']:.2f} (D {m['path']['d_ms']:.2f}, G {m['path']['g_ms']:.2f}), "
            f"other {m['other']['ms']:.2f} (D {m['other']['d_ms']:.2f}, G "
            f"{m['other']['g_ms']:.2f}); mean {s['mean_ms']:.2f} ms = "
            f"{s['images_per_s']:.2f} images/s; {LOOP_STEPS} steps as a loop "
            f"{s['loop_ms']:.2f} ms a step = {s['loop_images_per_s']:.2f} images/s")


def production_steps(torch, cards: int) -> dict:
    """(c), with one card's plain step (``presets.write_card_config``'s
    one replica, no group) in the same call as the baseline."""
    from one_to_many_gan_torch.config import load_config
    from one_to_many_gan_torch.parallel import distributed
    from one_to_many_gan_torch.presets import write_card_config

    with tempfile.TemporaryDirectory(dir=ROOT / "chiprun_out") as tmp:
        work = Path(tmp)
        changes = write_card_config(cs.PROD_CONFIG, work / "cards.toml", cards=cards,
                                    native_loader=False)
        config = load_config(work / "cards.toml")
        write_card_config(cs.PROD_CONFIG, work / "one.toml", native_loader=False)
        one_config = load_config(work / "one.toml")
        log(f"(c) {cs.PROD_CONFIG.name} on {cards} cards, overrides {changes}")
        _free(torch)
        (work / "one").mkdir()
        distributed.spawn(_rank_production, 1, "cuda", (one_config, str(work / "one"), True))
        distributed.spawn(_rank_production, cards, "cuda", (config, str(work)))
        base = json.loads((work / "one" / "rank0.json").read_text())
        ranks = [json.loads((work / f"rank{r}.json").read_text()) for r in range(cards)]
    b_global = config["training"]["batch_size"]
    one, many = _summary([base], one_config["training"]["batch_size"]), _summary(ranks, b_global)
    for r in [base, *ranks]:
        for row in r["rows"]:
            r1 = row["step"] % cs.P_R1_INTERVAL == 0
            want_d = [cs.P_D_WARPS, 0, len(cs.P_D_IN_SITES) + (len(cs.P_R1_IN_SITES) if r1 else 0),
                      0, 0]
            want_g = [cs.P_G_WARPS, cs.P_G_WARP_BWDS, len(cs.P_G_IN_SITES), 0, 0]
            cs.check(row["d_launches"] == want_d and row["g_launches"] == want_g,
                     f"rank {r['rank']} step {row['step']}: launches D {row['d_launches']} "
                     f"G {row['g_launches']} (want {want_d}, {want_g})")
            cs.check(all(np.isfinite(v) for k, v in row.items() if k.endswith("loss")),
                     f"rank {r['rank']} step {row['step']}: a loss is not finite")
    for r in ranks[1:]:
        cs.check(all(a[k] == b[k] for a, b in zip(r["rows"], ranks[0]["rows"], strict=True)
                     for k in a if k.endswith(("loss", "acc")) or k == "ada_p"),
                 f"rank {r['rank']}'s metrics differ from rank 0's")
    ar = ranks[0]["allreduce"]
    ar_ms = sum(v["ms"] for v in ar.values())
    ar_bytes = sum(v["bytes"] for v in ar.values())
    nccl_ms = {r["rank"]: sum(k["ms"] for k in r["nccl"] if k["name"].startswith("ncclDev"))
               for r in ranks}
    idle = {r["rank"]: r["profile"]["idle_share"] for r in ranks}
    ratio = many["images_per_s"] / one["images_per_s"]
    loop_ratio = many["loop_images_per_s"] / one["loop_images_per_s"]
    log("(c) " + _line("one card, no group, batch 8", one) + f"; idle share "
        f"{base['profile']['idle_share']:.3f}")
    log("(c) " + _line(f"{cards} cards, global batch {b_global}", many))
    log(f"  {cards} cards against one card in this call: {ratio:.3f}x (phases synchronised), "
        f"{loop_ratio:.3f}x (as a loop); against phase 15's {ONE_CARD_IMAGES_PER_S} images/s "
        f"{many['images_per_s'] / ONE_CARD_IMAGES_PER_S:.3f}x")
    log("  peak GiB per card: " + ", ".join(
        f"cuda:{k} D {v['d_gib']:.2f} G {v['g_gib']:.2f}" for k, v in many["peak_gib"].items())
        + f" (one card: D {one['peak_gib'][0]['d_gib']:.2f} G {one['peak_gib'][0]['g_gib']:.2f})")
    log(f"  all-reduce per step (D, then G, mapping, extractor): {ar_bytes / 2**20:.2f} MiB in "
        f"{ar_ms:.3f} ms (" + ", ".join(f"{k} {v['bytes'] / 2**20:.2f} MiB {v['ms']:.3f} ms"
                                        for k, v in ar.items())
        + f"); NCCL kernels in one other step's profile, ms per card {nccl_ms}; idle share "
        f"per card {idle}")
    log(f"  launches per card over {cs.P_BARE_STEPS} steps (warp, warp_bwd, IN, split "
        "partials, split apply): "
        + ", ".join(f"cuda:{r['rank']} {r['launches']}" for r in ranks))
    return {"overrides": changes, "one_card": one, **many, "ratio_in_call": ratio,
            "loop_ratio_in_call": loop_ratio,
            "ratio_to_phase15": many["images_per_s"] / ONE_CARD_IMAGES_PER_S,
            "allreduce": ar, "allreduce_ms": ar_ms, "allreduce_bytes": ar_bytes,
            "nccl_ms": nccl_ms, "idle_share": idle,
            "one_card_idle_share": base["profile"]["idle_share"],
            "launches": {r["rank"]: r["launches"] for r in ranks},
            "profiles": {r["rank"]: {"profile": r["profile"], "top": r["top"],
                                     "nccl": r["nccl"]} for r in [*ranks]},
            "one_card_profile": {"profile": base["profile"], "top": base["top"]}}


# -------------------------------------------------------------------- (g)


def _nccl_by_kind(kernels: list) -> dict:
    """The ms of a profiled step's NCCL kernels by collective."""
    out: dict[str, float] = {}
    for k in kernels:
        name = k["name"]
        if not name.startswith("ncclDev"):
            continue
        kind = next((c for c in ("SendRecv", "AllGather", "AllReduce", "Broadcast")
                     if c in name), "other")
        out[kind] = out.get(kind, 0.0) + k["ms"]
    return out


def _spatial_trainer(torch, cards: int, root: Path) -> dict:
    """(g)'s Trainer at data N/2 x spatial 2 through the CLI, deterministic:
    8 steps, a resume to 16, and 16 uninterrupted; the two 16.tar."""
    from one_to_many_gan_torch.data import write_synthetic_dataset_dirs
    from one_to_many_gan_torch.presets import write_card_config

    for domain, seed in (("prints", 0), ("marks", 9)):
        write_synthetic_dataset_dirs(root / domain, n_train=cs.T_TRAIN_IMAGES,
                                     n_test=cs.T_TEST_IMAGES,
                                     image_size=(cs.P_SIZE, cs.P_SIZE), seed=seed)
    half, whole = cs.P_CKPT // 2, cs.P_CKPT

    def config(run: str, steps: int) -> Path:
        path = root / f"{run}_{steps}.toml"
        write_card_config(
            cs.PROD_CONFIG, path, cards=cards, spatial=True, native_loader=False,
            deterministic_cuda_kernels=True, shoeprint_data_dir=str(root / "prints"),
            shoemark_data_dir=str(root / "marks"), checkpoint_directory=str(root),
            training_run=run, training_steps=steps, log_interval=half,
            checkpoint_interval=half, n_evaluation_images=cs.T_EVAL_IMAGES)
        return path

    _free(torch)
    t0 = time.perf_counter()
    _train_cli(config("a", half), f"{half} steps at spatial 2")
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    second = _train_cli(config("a", whole), f"the resume to {whole} at spatial 2")
    second_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    _train_cli(config("b", whole), f"{whole} uninterrupted steps at spatial 2")
    whole_s = time.perf_counter() - t0
    models = sorted(p.name for p in (root / "a" / "models").iterdir())
    diffs, n_tensors, n_elems = cs._ckpt_differences(
        torch, cs._load_ckpt(torch, root / "a" / "models" / f"{whole}.tar"),
        cs._load_ckpt(torch, root / "b" / "models" / f"{whole}.tar"))
    cs.check(f"Resumed from checkpoint at step {half}" in second.splitlines(),
             f"the resumed run did not print 'Resumed from checkpoint at step {half}'")
    cs.check(not diffs, f"{whole}.tar of {half} + a resume differs from {whole} uninterrupted "
             f"steps at {diffs[:5]}")
    log(f"(g) the training CLI at data {cards // 2} x spatial 2 (deterministic): {half} steps "
        f"in {first_s:.1f} s, the resume to {whole} in {second_s:.1f} s, {whole} uninterrupted "
        f"in {whole_s:.1f} s (each with the ranks' start, {cs.T_EVAL_IMAGES} validation images "
        f"a checkpoint and the saves); checkpoints {models}; {whole}.tar bitwise the "
        f"uninterrupted run's ({n_tensors} tensors, {n_elems} elements)")
    return {"first_s": first_s, "second_s": second_s, "whole_s": whole_s,
            "checkpoints": models, "tensors_compared": n_tensors}


def spatial_production(torch, cards: int) -> dict:
    """(g): the production config at data N/2 x spatial 2 beside data N x
    spatial 1, then its Trainer's resume."""
    from one_to_many_gan_torch.config import load_config
    from one_to_many_gan_torch.parallel import distributed
    from one_to_many_gan_torch.presets import write_card_config

    with tempfile.TemporaryDirectory(dir=ROOT / "chiprun_out") as tmp:
        work = Path(tmp)
        changes = write_card_config(cs.PROD_CONFIG, work / "sp.toml", cards=cards, spatial=True,
                                    native_loader=False)
        config = load_config(work / "sp.toml")
        write_card_config(cs.PROD_CONFIG, work / "dp.toml", cards=cards, native_loader=False)
        dp_config = load_config(work / "dp.toml")
        log(f"(g) {cs.PROD_CONFIG.name} on {cards} cards keeping its spatial axis, overrides "
            f"{changes}")
        _free(torch)
        (work / "dp").mkdir()
        distributed.spawn(_rank_production, cards, "cuda", (dp_config, str(work / "dp")),
                          timeout_s=COLLECTIVE_TIMEOUT_S)
        distributed.spawn(_rank_production, cards, "cuda", (config, str(work)),
                          spatial=config["tpu"]["spatial_parallel"],
                          timeout_s=COLLECTIVE_TIMEOUT_S)
        dp_ranks = [json.loads((work / "dp" / f"rank{r}.json").read_text())
                    for r in range(cards)]
        ranks = [json.loads((work / f"rank{r}.json").read_text()) for r in range(cards)]
        trainer = _spatial_trainer(torch, cards, work / "trainer")
    b_global = config["training"]["batch_size"]
    dp, sp = _summary(dp_ranks, b_global), _summary(ranks, b_global)
    for r in ranks:
        for row in r["rows"]:
            r1 = row["step"] % cs.P_R1_INTERVAL == 0
            n_d = len(cs.P_D_IN_SITES) + (len(cs.P_R1_IN_SITES) if r1 else 0)
            want_d = [cs.P_D_WARPS, 0, 0, n_d, n_d]
            n_g = len(cs.P_G_IN_SITES)
            want_g = [cs.P_G_WARPS, cs.P_G_WARP_BWDS, 0, n_g, n_g]
            cs.check(row["d_launches"] == want_d and row["g_launches"] == want_g,
                     f"rank {r['rank']} step {row['step']}: launches D {row['d_launches']} "
                     f"G {row['g_launches']} (want {want_d}, {want_g})")
            cs.check(all(np.isfinite(v) for k, v in row.items() if k.endswith("loss")),
                     f"rank {r['rank']} step {row['step']}: a loss is not finite")
    for r in ranks[1:]:
        cs.check(all(a[k] == b[k] for a, b in zip(r["rows"], ranks[0]["rows"], strict=True)
                     for k in a if k.endswith(("loss", "acc")) or k == "ada_p"),
                 f"rank {r['rank']}'s metrics differ from rank 0's")
    nccl = {r["rank"]: _nccl_by_kind(r["nccl"]) for r in ranks}
    idle = {r["rank"]: r["profile"]["idle_share"] for r in ranks}
    ex = ranks[0]["exchanges"]
    halo = {k: ex[k] for k in ("halo", "halo_t") if k in ex}
    log("(g) " + _line(f"data {cards} x spatial 1, global batch {b_global}", dp)
        + f"; idle share per card {[r['profile']['idle_share'] for r in dp_ranks]}")
    log("(g) " + _line(f"data {cards // 2} x spatial 2, global batch {b_global}", sp))
    log(f"  spatial 2 against spatial 1 in this call: "
        f"{sp['images_per_s'] / dp['images_per_s']:.3f}x (phases synchronised), "
        f"{sp['loop_images_per_s'] / dp['loop_images_per_s']:.3f}x (as a loop)")
    log("  peak GiB per card, spatial 2: " + ", ".join(
        f"cuda:{k} D {v['d_gib']:.2f} G {v['g_gib']:.2f}" for k, v in sp["peak_gib"].items())
        + "; spatial 1: " + ", ".join(
        f"cuda:{k} D {v['d_gib']:.2f} G {v['g_gib']:.2f}" for k, v in dp["peak_gib"].items()))
    log("  one other step's exchanges on cuda:0: " + ", ".join(
        f"{k} {v['count']} pieces {v['bytes'] / 2**20:.2f} MiB" for k, v in ex.items()
        if isinstance(v, dict)) + f"; the IN all-gathers alone {ex['in_partials_ms_alone']:.3f} "
        f"ms; NCCL kernel ms per card in the profiled step {nccl}; idle share per card {idle}")
    log(f"  launches per card over {cs.P_BARE_STEPS} steps (warp, warp_bwd, IN, split "
        "partials, split apply): " + ", ".join(f"cuda:{r['rank']} {r['launches']}"
                                               for r in ranks))
    return {"overrides": changes, "data_only": dp, **sp,
            "ratio_to_data_only": sp["images_per_s"] / dp["images_per_s"],
            "loop_ratio_to_data_only": sp["loop_images_per_s"] / dp["loop_images_per_s"],
            "exchanges": ex, "halo": halo, "nccl_ms_by_kind": nccl, "idle_share": idle,
            "data_only_idle_share": {r["rank"]: r["profile"]["idle_share"] for r in dp_ranks},
            "launches": {r["rank"]: r["launches"] for r in ranks},
            "data_only_launches": {r["rank"]: r["launches"] for r in dp_ranks},
            "profiles": {r["rank"]: {"profile": r["profile"], "top": r["top"],
                                     "nccl": r["nccl"]} for r in ranks},
            "trainer": trainer}


# -------------------------------------------------------------------- (d)


def _train_cli(config: Path, label: str) -> str:
    proc = subprocess.run([sys.executable, "-m", "one_to_many_gan_torch.train", str(config)],
                          cwd=ROOT, capture_output=True, text=True, timeout=900, check=False)
    cs.check(proc.returncode == 0, f"{label}: the training CLI exited {proc.returncode}:\n"
             f"{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
    return proc.stdout


def trainer_resume(torch, cards: int) -> dict:
    from one_to_many_gan_torch import serve
    from one_to_many_gan_torch.config import load_config
    from one_to_many_gan_torch.data import write_synthetic_dataset_dirs
    from one_to_many_gan_torch.presets import write_card_config

    with tempfile.TemporaryDirectory(dir=ROOT / "chiprun_out") as tmp:
        root = Path(tmp)
        for domain, seed in (("prints", 0), ("marks", 9)):
            write_synthetic_dataset_dirs(root / domain, n_train=cs.T_TRAIN_IMAGES,
                                         n_test=cs.T_TEST_IMAGES,
                                         image_size=(cs.P_SIZE, cs.P_SIZE), seed=seed)

        def config(run: str, steps: int) -> Path:
            path = root / f"{run}_{steps}.toml"
            write_card_config(
                cs.PROD_CONFIG, path, cards=cards, native_loader=False,
                deterministic_cuda_kernels=True, shoeprint_data_dir=str(root / "prints"),
                shoemark_data_dir=str(root / "marks"), checkpoint_directory=str(root),
                training_run=run, training_steps=steps, log_interval=cs.P_LOG,
                checkpoint_interval=cs.P_CKPT, n_evaluation_images=cs.P_EVAL_IMAGES)
            return path

        _free(torch)
        t0 = time.perf_counter()
        first = _train_cli(config("a", cs.P_CKPT), "16 steps")
        first_s = time.perf_counter() - t0
        engine = serve.InferenceEngine(load_config(config("a", cs.P_STEPS)),
                                       buckets=(cs.T_ENGINE_N,), device="cuda")
        cs.check(engine.step == cs.P_CKPT and engine.ema, f"the server restored step "
                 f"{engine.step}, EMA {engine.ema}")
        httpd = serve.make_server(engine, host="127.0.0.1", port=0)
        server = threading.Thread(target=httpd.serve_forever, daemon=True)
        server.start()
        try:
            t0 = time.perf_counter()
            second = _train_cli(config("a", cs.P_STEPS), "the resume to 32")
            second_s = time.perf_counter() - t0
            reload = cs._post_reload(httpd.server_address[1])
            health = cs._get(httpd.server_address[1], "/healthz")
        finally:
            httpd.shutdown()
            httpd.server_close()
            httpd.batcher.close()
            server.join(timeout=60)
        del engine
        _free(torch)
        t0 = time.perf_counter()
        _train_cli(config("b", cs.P_STEPS), "32 uninterrupted steps")
        whole_s = time.perf_counter() - t0
        run = root / "a"
        lines = (run / "log").read_text().splitlines()
        train_lines = [ln.split(",")[0] for ln in lines if ln.startswith("Step:")]
        fid_lines = [ln for ln in lines if ln.startswith("Step ")]
        models = sorted(p.name for p in (run / "models").iterdir())
        n_val = len(list((run / "val").glob("*.png")))
        diffs, n_tensors, n_elems = cs._ckpt_differences(
            torch, cs._load_ckpt(torch, run / "models" / f"{cs.P_STEPS}.tar"),
            cs._load_ckpt(torch, root / "b" / "models" / f"{cs.P_STEPS}.tar"))
    cs.check(f"Resumed from checkpoint at step {cs.P_CKPT}" in second.splitlines(),
             "the resumed run did not print 'Resumed from checkpoint at step 16'")
    cs.check(first.count("Step: ") == 2 and second.count("Step: ") == 2,
             "rank 0 alone prints the log lines")
    cs.check(train_lines == [f"Step: {s}/{cs.P_STEPS if s > cs.P_CKPT else cs.P_CKPT}"
                             for s in range(cs.P_LOG, cs.P_STEPS + 1, cs.P_LOG)],
             f"log lines {train_lines}")
    cs.check(len(fid_lines) == 2, f"FID lines {fid_lines}")
    cs.check(models == [f"{cs.P_CKPT}.tar", f"{cs.P_STEPS}.tar"], f"checkpoints {models}")
    cs.check(n_val == cs.P_EVAL_IMAGES, f"{n_val} validation images")
    cs.check(reload == {"status": "ok", "step": cs.P_STEPS}, f"/reload answered {reload}")
    cs.check(health.get("data_parallel") == 1 and health.get("ema") is True,
             f"/healthz {health}")
    cs.check(not diffs, f"32.tar of 16 + a resume differs from 32 uninterrupted steps at "
             f"{diffs[:5]}")
    log(f"(d) the training CLI on {cards} ranks (deterministic): 16 steps in {first_s:.1f} s, "
        f"the resume to 32 in {second_s:.1f} s, 32 uninterrupted in {whole_s:.1f} s (each with "
        f"the ranks' start, grids, {cs.P_EVAL_IMAGES} validation images per checkpoint and "
        f"the saves); one log line per log step, checkpoints {models}; a one-card server's "
        f"/reload answered {reload}; 32.tar bitwise the uninterrupted run's ({n_tensors} "
        f"tensors, {n_elems} elements)")
    return {"first_s": first_s, "second_s": second_s, "whole_s": whole_s, "reload": reload,
            "healthz": health, "checkpoints": models, "tensors_compared": n_tensors}


# -------------------------------------------------------------------- (e)


def _int8_flips(torch, one: list, parts: list, m: int) -> list:
    """Per int8 site, the activation codes in which the replicas' rows
    differ from one card's (``one``: the one card's site inputs; ``parts``:
    each replica's)."""
    from one_to_many_gan_torch.ops.quantize import quantize_activations

    flips = []
    for i, site in enumerate(one):
        codes = quantize_activations(cs.site_padded(site))[0]
        flips.append(sum(
            int((codes[r * m:(r + 1) * m]
                 != quantize_activations(cs.site_padded(p[i]))[0].to(codes.device)).sum())
            for r, p in enumerate(parts)))
    return flips


def _serve_pair(torch, config, cards: int, int8: bool) -> dict:
    """One card's engine and ``cards`` cards' (float or int8): the images of
    one n = 64 decode against each other, then n = 8, 32, 64 over HTTP."""
    from one_to_many_gan_torch import serve
    from one_to_many_gan_torch.ops.cuda import fused_instance_norm, fused_int8_conv, int8_prepass

    h, w = config["data"]["image_size"]
    source = cs._source_image(0, h, w)
    body = cs._png(source)
    out = {}
    engines = {}
    with tempfile.TemporaryDirectory(dir=ROOT / "chiprun_out") as tmp:
        config["training"]["checkpoint_directory"] = Path(tmp)  # no run: fresh weights
        with contextlib.redirect_stderr(io.StringIO()):
            engines[1] = serve.InferenceEngine(config, buckets=cs.BUCKETS, device="cuda",
                                               int8=int8)
            engines[cards] = serve.InferenceEngine(config, buckets=cs.BUCKETS, device="cuda",
                                                   data_parallel=cards, int8=int8)
    one, many = engines[1], engines[cards]
    img = torch.from_numpy(np.stack([source]).astype(np.float32) / 127.5 - 1.0)
    gen = torch.Generator("cuda").manual_seed(3)
    n = cs.BUCKETS[-1]
    z = torch.randn((1, n, one.models.w_dim), generator=gen, device="cuda")
    thetas = torch.ones(1)
    m = n // cards
    one_sites, part_sites = [], [[] for _ in range(cards)]
    with cs.int8_sites(one_sites):
        want = one._fns[0](img, z, thetas)
    parts = []
    for i, fn in enumerate(many._fns):
        with cs.int8_sites(part_sites[i]):
            parts.append(fn(img, z, thetas, rows=slice(i * m, (i + 1) * m)))
    got = torch.cat([p.to("cuda:0") for p in parts])
    diff = (got.float() - want.float()).abs()
    err, mean = diff.max().item(), diff.mean().item()
    levels = (serve._to_u8(got).int() - serve._to_u8(want).int()).abs().float()
    levels = levels.mean().item()
    psnr = cs._psnr(got.float().cpu().numpy(), want.float().cpu().numpy())
    flips = _int8_flips(torch, one_sites, part_sites, m) if int8 else []
    del one_sites, part_sites, parts, got, want, diff
    torch.cuda.empty_cache()
    if int8:
        cs.check(len(flips) == cs.INT8_SITES_PER_DECODE, f"int8 sites {len(flips)}")
        cs.check(levels < cs.INT8_MEAN_LEVELS and psnr > cs.INT8_PSNR_FLOOR,
                 f"{cards} int8 replicas' images {levels} levels, {psnr} dB from one card's")
    else:
        cs.check(err <= SERVE_TOL, f"{cards} replicas' images {err} from one card's")
    for k, engine in engines.items():
        engine.warmup(batched=False)
        httpd = serve.make_server(engine, host="127.0.0.1", port=0, max_batch=1)
        server = threading.Thread(target=httpd.serve_forever, daemon=True)
        server.start()
        try:
            port = httpd.server_address[1]
            lat = {}
            for b in cs.BUCKETS:
                times = []
                for _ in range(SERVE_REPS):
                    payload, ms = cs._post(port, body, n=b, seed=0, format="npy")
                    times.append(ms)
                cs._check_out(cs._npy(payload), b, h, w)
                lat[b] = statistics.median(times)
            c0 = (fused_instance_norm.launches, fused_int8_conv.launches, int8_prepass.launches)
            cs._post(port, body, n=n, seed=0, format="npy")
            in_per_call = fused_instance_norm.launches - c0[0]
            int8_per_call = fused_int8_conv.launches - c0[1]
            prepass_per_call = int8_prepass.launches - c0[2]
            health = cs._get(port, "/healthz")
        finally:
            httpd.shutdown()
            httpd.server_close()
            server.join(timeout=60)
        cs.check(health.get("data_parallel") == k and health.get("int8") is int8,
                 f"/healthz {health}")
        for name, count in (("fused int8 conv", int8_per_call), ("pre-pass", prepass_per_call)):
            cs.check(count == (cs.INT8_SITES_PER_DECODE * k if int8 else 0),
                     f"{count} {name} launches in one n={n} call on {k} cards")
        out[k] = {"latency_ms": lat, "in_launches_per_call": in_per_call,
                  "int8_launches_per_call": int8_per_call}
    label = "int8" if int8 else "float32"
    log(f"(e) serving {cs.CONFIG.name} ({label}): median latency ms, one card "
        f"{out[1]['latency_ms']}, {cards} cards {out[cards]['latency_ms']}; images within "
        f"{err:.3g} (mean {mean:.3g}, {levels:.4f} uint8 levels, tanh PSNR {psnr:.2f} dB) of "
        "one card's" + (f", flipped codes per int8 site {flips}" if int8 else "")
        + f"; IN launches per n={n} call {out[1]['in_launches_per_call']} / "
        f"{out[cards]['in_launches_per_call']}"
        + (f"; int8 launches {out[1]['int8_launches_per_call']} / "
           f"{out[cards]['int8_launches_per_call']}" if int8 else ""))
    return {"max_abs_err": err, "mean_abs_err": mean, "mean_levels": levels, "psnr": psnr,
            "flipped_codes": flips, "by_cards": out}


def serve_data_parallel(torch, cards: int) -> dict:
    from one_to_many_gan_torch.config import load_config

    return {("int8" if int8 else "float32"): _serve_pair(torch, load_config(cs.CONFIG), cards, int8)
            for int8 in (False, True)}


# ------------------------------------------------------------------- main


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--cards", type=int, default=4)
    ap.add_argument("--checks", default="abcdefg",
                    help="the lettered checks to run, e.g. 'e' (default: all)")
    args = ap.parse_args(argv)
    checks = {"a": ("kernels", kernels_on_cards), "b": ("step", step_against_one_card),
              "c": ("production", production_steps), "d": ("trainer", trainer_resume),
              "e": ("serve", serve_data_parallel),
              "f": ("spatial_step", lambda torch, cards: step_against_one_card(torch, cards, 2)),
              "g": ("spatial_production", spatial_production)}
    unknown = set(args.checks) - set(checks)
    if unknown or not args.checks:
        ap.error(f"--checks takes letters of {''.join(checks)}, got {args.checks!r}")
    import torch

    if not torch.cuda.is_available():
        print("multi_card_smoke: no CUDA device; this script runs only on GPUs", file=sys.stderr)
        return 1
    cs.check(torch.cuda.device_count() >= args.cards,
             f"{args.cards} cards asked for, {torch.cuda.device_count()} visible")
    from one_to_many_gan_torch.device import set_cublas_workspace
    from one_to_many_gan_torch.ops.cuda import build

    set_cublas_workspace()  # before cuBLAS starts; the ranks inherit it
    t_start = time.perf_counter()
    smi, topo = _smi(), _topology()
    for line in smi:
        log(line)
    log(topo)
    t0 = time.perf_counter()
    build.build_kernels()
    log(f"kernels built in {time.perf_counter() - t0:.1f} s")
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    report = {"nvidia_smi": smi, "topology": topo, "cards": args.cards,
              "torch": torch.__version__, "cuda": torch.version.cuda}
    for letter, (key, check) in checks.items():
        if letter in args.checks:
            report[key] = check(torch, args.cards)
    report["wall_s"] = time.perf_counter() - t_start
    log(f"multi_card_smoke wall time {report['wall_s']:.1f} s")
    out = OUT if set(args.checks) == set(checks) else OUT.with_stem(f"{OUT.stem}_{args.checks}")
    out.write_text(json.dumps(report, indent=1, default=str))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
