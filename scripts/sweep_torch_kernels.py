"""Sweep the design choices of the port's redesigned CUDA kernels on one
GPU, each alternative timed against the others in one run, cold L2.

    python3 scripts/sweep_torch_kernels.py in-plans
    python3 scripts/sweep_torch_kernels.py warp-variants
    python3 scripts/sweep_torch_kernels.py gather-variants
    python3 scripts/sweep_torch_kernels.py int8-variants
    python3 scripts/sweep_torch_kernels.py up-plans

``in-plans``: the instance norm at the serving, D-step and fused-step sites
under every block layout the kernel's entry takes (planes per block,
cluster size, threads), beside ``F.instance_norm`` and the plan that
``ops/cuda/instance_norm.py::plan`` picks; every layout is first held to the
plain version.

``warp-variants``: copies of ``csrc/warp.cu`` with one choice changed each
(registers uncapped, 256-thread blocks, 4 pixels per thread, IEEE divisions
in place of the corrected reciprocal), built in parallel with the port's
nvcc flags and timed against the source as it is; every variant's output is
held bitwise to the source's.

``gather-variants``: copies of ``csrc/warp.cu`` with one choice of the
warp backward's gather changed each (the tile's shape, blocks per SM, the
staging buffer's size), built in parallel and timed
against the source on ADA draws at p = 0.9; every variant is held to the
plain version (a variant may chunk a region elsewhere, so its sums may
be ordered otherwise). Variants named ``x_*`` leave out one part of the
work (the summing loop, the tap arithmetic of the staged pixels, every
tile), compute wrong results and are timed only, to show where the
gather's time goes.

``int8-variants``: copies of ``csrc/int8_conv.cu`` with one choice of the
fused conv changed each (every code from the IEEE division, the quantiser's
item loop unrolled twice), built in parallel and timed (the conv alone,
its pre-pass's scale given) against the source at the three site types of
an n = 64 decode of ``configs/default.toml``, float32 and bfloat16; each
is first held bitwise to the plain version there and at phase 18's ragged
sites. Variants named ``x_*`` leave out one part of the work (the
quantisation, the products, the weight copies, the raw input copies, the
output stores), compute wrong results and are timed only, to show where
the conv's time goes.

``up-plans``: the 2x upsample kernel at the serving decode's two sites
(``chip_smoke.UP_SITES``), bfloat16 and float32, under strip heights
(input rows a thread walks) and block sizes, beside the pair that
``ops/cuda/upsample.py`` picks (``ROWS``, ``THREADS``); the default is
first held to the plain version, and every pair to the default bitwise.

Builds go to ``build/sweep/``; results to ``chiprun_out/sweep_<what>.json``.
Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

OUT = ROOT / "chiprun_out"
BUILD = ROOT / "build" / "sweep"
IN_SITES = [  # (B, C, H, W, dtype name): one of each plane size on the paths
    (1, 64, 512, 256, "float32"), (1, 128, 512, 256, "float32"), (1, 256, 256, 128, "float32"),
    (1, 256, 128, 64, "float32"), (4, 256, 128, 64, "float32"), (1, 64, 512, 256, "bfloat16"),
    (1, 256, 256, 128, "bfloat16"), (1, 256, 128, 64, "bfloat16"), (16, 64, 256, 256, "bfloat16"),
    (16, 256, 128, 128, "bfloat16"), (16, 256, 64, 64, "bfloat16"), (32, 128, 126, 126, "bfloat16"),
    (32, 256, 62, 62, "bfloat16"), (32, 512, 30, 30, "bfloat16"), (16, 512, 30, 30, "bfloat16"),
]
# The int8 sites of an n = 64 decode of configs/default.toml: (B, C, H, W, O,
# pad mode), unpadded (chip_smoke.INT8_SITE_TYPES).
INT8_SITES = {"resnet": (64, 256, 128, 64, 256, "reflect"),
              "up1": (64, 256, 256, 128, 128, "zero"), "up2": (64, 128, 512, 256, 64, "zero")}
WARP_CASES = [((16, 256, 256), "bfloat16", True), ((16, 256, 256), "float32", True),
              ((16, 256, 256), "float32", False), ((4, 512, 256), "bfloat16", True),
              ((4, 512, 256), "float32", False)]


def in_plans(torch) -> list:
    import torch.nn.functional as F

    from one_to_many_gan_torch.ops.cuda import instance_norm as m

    gen = torch.Generator("cuda").manual_seed(0)
    flush = torch.zeros(128 * 2**20, dtype=torch.uint8, device="cuda")
    results = []
    for b, c, h, w, dtype_name in IN_SITES:
        dtype = getattr(torch, dtype_name)
        x = (torch.randn((b, c, h, w), generator=gen, device="cuda") * 2 + 0.5).to(dtype)
        planes, hw, esize = b * c, h * w, x.element_size()
        layouts = {"plan": m.plan(planes, hw, dtype)}
        for ppb in (1, 2, 4, 8):
            for threads in (128, 256, 512):
                smem = m._range_smem(ppb * hw, esize)
                if threads // ppb >= 32 and smem <= m.MAX_DYNAMIC_SMEM:
                    layouts[f"planes{ppb}_t{threads}"] = m.Plan(
                        "packed" if ppb > 1 else "resident", ppb, 1, threads, smem,
                        -(-planes // ppb))
        for cluster in (2, 4, 8):
            for threads in (256, 512):
                smem = m._range_smem(-(-hw // cluster), esize)
                if smem <= m.MAX_DYNAMIC_SMEM:
                    layouts[f"cluster{cluster}_t{threads}"] = m.Plan(
                        "cluster", 1, cluster, threads, smem, planes * cluster)
        want = m.instance_norm_plain(x)
        for name, layout in layouts.items():
            err = (m._launch(x, False, 1e-5, layout).float() - want.float()).abs().max().item()
            cs.check(err <= cs.IN_TOL[dtype_name], f"IN layout {name} off by {err}")
        fns = {name: (lambda t, lay=layout: m._launch(t, False, 1e-5, lay))
               for name, layout in layouts.items()}
        fns["F.instance_norm"] = F.instance_norm
        times = cs.time_cold_ms(torch, fns, x, flush, reps=15)
        bound = 2 * x.numel() * esize / cs.HBM_BYTES_PER_S * 1e3
        chosen = layouts["plan"]
        cs.log(f"IN B={b} [{c},{h},{w}] {dtype_name}: bound {bound:.4f} ms, plan "
               f"{chosen.variant}/{chosen.planes_per_block}/{chosen.cluster}/{chosen.threads} "
               + " ".join(f"{k}={v:.4f}" for k, v in sorted(times.items(), key=lambda kv: kv[1])))
        results.append({"site": [b, c, h, w, dtype_name], "bound_ms": bound, "ms": times,
                        "plan": chosen.__dict__})
        del x, want
    return results


def up_plans(torch) -> list:
    from one_to_many_gan_torch.ops.cuda import upsample as up

    gen = torch.Generator("cuda").manual_seed(0)
    flush = torch.zeros(128 * 2**20, dtype=torch.uint8, device="cuda")
    results = []
    for dtype_name in ("bfloat16", "float32"):
        for site, shape in cs.UP_SITES.items():
            x = (torch.randn(shape, generator=gen, device="cuda") * 2 + 0.5).to(
                getattr(torch, dtype_name))
            pairs = [(rows, threads) for rows in (1, 2, 3, 4, 6, 8, 16)
                     for threads in (128, 256, 512, 1024)]
            first = up.upsample2x(x)
            errs = cs.up_errors(torch, first, x)
            cs.check(errs["max_abs_err"] <= errs["tol"] and errs["excess_vs_float32"] <= 0,
                     f"upsample {site} {dtype_name}: {errs}")
            for rows, threads in pairs:  # every pair computes the same expressions
                cs.check(torch.equal(up.upsample2x(x, rows=rows, threads=threads), first),
                         f"upsample rows {rows} threads {threads} differs from the default")
            del first
            fns = {f"r{rows}_t{threads}": (lambda t, r=rows, n=threads:
                                           up.upsample2x(t, rows=r, threads=n))
                   for rows, threads in pairs}
            times = cs.time_cold_ms(torch, fns, x, flush, reps=7)
            bound = up.bound_bytes(shape, x.element_size()) / cs.HBM_BYTES_PER_S * 1e3
            chosen = f"r{up.ROWS[x.dtype]}_t{up.THREADS}"
            ranked = sorted(times.items(), key=lambda kv: kv[1])
            cs.log(f"upsample {site} {list(shape)} {dtype_name}: bound {bound:.4f} ms, chosen "
                   f"{chosen} {times[chosen]:.4f} ({bound / times[chosen]:.1%}); "
                   + " ".join(f"{k}={v:.4f}" for k, v in ranked[:8]) + " ... "
                   + " ".join(f"{k}={v:.4f}" for k, v in ranked[-3:]))
            results.append({"site": site, "shape": list(shape), "dtype": dtype_name,
                            "bound_ms": bound, "ms": times, "chosen": chosen})
            del x
    return results


def _warp_sources(src: str) -> dict:
    """The source and one copy per alternative, each differing in one choice."""

    def swap(text: str, old: str, new: str) -> str:
        cs.check(old in text, f"warp variant: {old[:60]!r} not in the source")
        return text.replace(old, new)

    cap = "__launch_bounds__(kFwdThreads, kFwdBlocksPerSM)"
    consts = "constexpr int kFwdThreads = 128;\nconstexpr int kFwdBlocksPerSM = 16;"
    head = "  const int p = blockIdx.x * kFwdThreads + threadIdx.x;\n  if (p >= hw) return;\n"
    body_start = src.index(head)
    body_end = src.index("  dispatch(nx > ny ? nx : ny, f);\n}\n", body_start)
    body = src[body_start + len(head):body_end] + "  dispatch(nx > ny ? nx : ny, f);\n"
    four = ("  for (int q = 0; q < 4; ++q) {\n"
            "  const int p = (blockIdx.x * kFwdThreads + threadIdx.x) * 4 + q;\n"
            "  if (p >= hw) return;\n"
            + body.replace("    return;\n", "    continue;\n") + "  }\n")
    grid = "(static_cast<int64_t>(h) * w + kFwdThreads - 1) / kFwdThreads"
    div = ("  float q = __fmul_rn(a, y);\n  q = __fmaf_rn(__fmaf_rn(-b, q, a), y, q);\n"
           "  return __fmaf_rn(__fmaf_rn(-b, q, a), y, q);\n")
    return {
        "source": src,
        "registers_uncapped": swap(src, cap, "__launch_bounds__(kFwdThreads)"),
        "threads256_cap8": swap(src, consts,
                                "constexpr int kFwdThreads = 256;\nconstexpr int kFwdBlocksPerSM = 8;"),
        "pixels4_per_thread": swap(src[:body_start] + four + src[body_end + len(
            "  dispatch(nx > ny ? nx : ny, f);\n"):], grid,
            "(static_cast<int64_t>(h) * w + 4 * kFwdThreads - 1) / (4 * kFwdThreads)"),
        "ieee_divisions": swap(src, div, "  (void)y;\n  return a / b;\n"),
    }


def _gather_sources(src: str) -> dict:
    """The source and one copy per alternative of the gather's constants."""

    def swap(text: str, old: str, new: str) -> str:
        cs.check(old in text, f"gather variant: {old!r} not in the source")
        return text.replace(old, new)

    taps = ("          const int x0 = axis_taps<NT, kAA>(__ldg(sx + p), wdx, rwdx, w, r, wx);\n"
            "          const int y0 = axis_taps<NT, kAA>(__ldg(sy + p), wdy, rwdy, h, r, wy);\n")
    loop = "        for (int py = ya; py <= yb; ++py) {\n"
    return {
        "source": src,
        "tile32x16": swap(src, "constexpr int kTileY = 32;", "constexpr int kTileY = 16;"),
        "blocks_per_sm3": swap(src, "kGatherBlocksPerSM = 4;", "kGatherBlocksPerSM = 3;"),
        "stage40k_5_per_sm": swap(swap(src, "kStageBytes = 47104;", "kStageBytes = 40960;"),
                                  "kGatherBlocksPerSM = 4;", "kGatherBlocksPerSM = 5;"),
        "hint_unroll8": swap(src, "kHintUnroll = 4;", "kHintUnroll = 8;"),
        # timing only (wrong results): where the gather's time goes
        "x_no_sum_loop": swap(src, loop, "        for (int py = ya; py <= yb && false; ++py) {\n"),
        "x_no_tap_math": swap(src, taps, "          const int x0 = px - 1, y0 = py - 1;\n"
                              "#pragma unroll\n          for (int t = 0; t < NT; ++t) "
                              "wx[t] = wy[t] = __ldg(sx + p) + __ldg(sy + p);\n"),
        "x_no_tiles": swap(src, "      dispatch(nx > ny ? nx : ny, g);", "      (void)g;"),
    }


def _int8_sources(src: str) -> dict:
    """The source and one copy per alternative of the fused conv."""

    def swap(text: str, old: str, new: str) -> str:
        cs.check(old in text, f"int8 variant: {old[:60]!r} not in the source")
        return text.replace(old, new)

    items = "#pragma unroll 1\n    for (int i = tid; i < kItems; i += kThreads) {"
    weights = ("    mbar_expect_tx(&full[st], T::kBStage);\n"
               "    bulk_load(sb + st * T::kBStage, wtile + static_cast<long long>(kt) * T::kBStage,\n"
               "              T::kBStage, &full[st]);\n")
    return {
        "source": src,
        "division_codes": swap(src, "  if (near_tie) {", "  if (true) {"),
        "items_unroll2": swap(src, items, items.replace("unroll 1", "unroll 2")),
        # timing only (wrong results): where the conv's time goes
        "x_no_quantise": swap(src, "      if (item >> 16) {", "      if (false) {"),
        "x_no_products": swap(src, "        wgmma_s8(acc[r], smem_desc(a, T::kPix * 16, 128), "
                              "smem_desc(bw, N * 16, 128));", ""),
        "x_no_weight_copies": swap(swap(src, weights, ""),
                                   "    mbar_wait(&full[st], (kt >> 1) & 1);\n", ""),
        "x_no_raw_copies": swap(src, "      load_raw(kt + 2);\n", ""),
        "x_no_stores": swap(src, "    if (oy >= Ho || o >= O || ox >= Wo) continue;",
                            "    if (oy >= 0) continue;"),
    }


def _build_all(sources: dict, prefix: str = "warp") -> dict:
    from one_to_many_gan_torch.ops.cuda import build

    BUILD.mkdir(parents=True, exist_ok=True)

    def one(item):
        name, text = item
        path = BUILD / f"{prefix}_{name}.cu"
        path.write_text(text)
        lib = BUILD / f"lib{prefix}_{name}.so"
        t0 = time.perf_counter()
        proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib), str(path)],
                              capture_output=True, text=True, check=False)
        cs.check(proc.returncode == 0, f"nvcc failed for {name}:\n{proc.stdout}{proc.stderr}")
        regs = [line.strip() for line in (proc.stdout + proc.stderr).splitlines()
                if "registers" in line or "spill stores" in line]
        return name, {"lib": lib, "build_s": time.perf_counter() - t0, "ptxas": regs}

    with ThreadPoolExecutor(len(sources)) as pool:
        return dict(pool.map(one, sources.items()))


def warp_variants(torch) -> list:
    from one_to_many_gan_torch.ops.cuda.warp import RADIUS, warp_plain

    built = _build_all(_warp_sources((ROOT / "one_to_many_gan_torch/csrc/warp.cu").read_text()))
    for name, info in built.items():
        cs.log(f"built {name} in {info['build_s']:.1f} s; " + "; ".join(info["ptxas"][-6:]))
    libs = {}
    for name, info in built.items():
        lib = ctypes.CDLL(str(info["lib"]))
        lib.otm_warp_fwd.argtypes = [*[ctypes.c_void_p] * 6, ctypes.c_longlong,
                                     ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
                                     ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        lib.otm_warp_fwd.restype = ctypes.c_int
        libs[name] = lib
    gen = torch.Generator("cuda").manual_seed(7)
    flush = torch.zeros(128 * 2**20, dtype=torch.uint8, device="cuda")
    results = []
    for (b, h, w), dtype_name, aa in WARP_CASES:
        dtype = getattr(torch, dtype_name)
        x, sx, sy, wx, wy = cs._warp_inputs(torch, gen, b, h, w, dtype, aa)

        def call(t, lib, sx=sx, sy=sy, wx=wx, wy=wy, dims=(b, h, w), aa=aa):
            out = torch.empty_like(t)
            err = lib.otm_warp_fwd(t.data_ptr(), sx.data_ptr(), sy.data_ptr(), wx.data_ptr(),
                                   wy.data_ptr(), out.data_ptr(), *dims,
                                   0 if t.dtype == torch.float32 else 1, int(aa), RADIUS,
                                   torch.cuda.current_stream().cuda_stream)
            cs.check(err == 0, f"warp variant launch failed: {err}")
            return out

        want = call(x, libs["source"])
        plain = warp_plain(x, sx, sy, wx, wy, antialias=aa)
        torch.cuda.synchronize()
        cs.check((want.double() - plain.double()).abs().max().item() <= cs.WARP_TOL_BF16_ABS,
                 "the warp source disagrees with its plain version")
        for name, lib in libs.items():
            cs.check(torch.equal(call(x, lib), want), f"warp variant {name} is not bitwise equal")
        fns = {name: (lambda t, lib=lib: call(t, lib)) for name, lib in libs.items()}
        if not aa and dtype == torch.float32:
            grid = torch.stack([sx / (w - 1) * 2 - 1, sy / (h - 1) * 2 - 1], dim=-1)
            fns["F.grid_sample"] = lambda t, grid=grid: torch.nn.functional.grid_sample(
                t[:, None], grid, mode="bilinear", padding_mode="zeros", align_corners=True)[:, 0]
        times = cs.time_cold_ms(torch, fns, x, flush, reps=30)
        cs.log(f"warp [{b},{h},{w}] {dtype_name} aa={int(aa)}: " + " ".join(
            f"{k}={v:.4f}" for k, v in sorted(times.items(), key=lambda kv: kv[1])))
        results.append({"case": [b, h, w, dtype_name, aa], "ms": times})
    return [{name: {"build_s": i["build_s"], "ptxas": i["ptxas"]} for name, i in built.items()},
            *results]


def gather_variants(torch) -> list:
    from one_to_many_gan_torch.ops.cuda.warp import RADIUS, hint_blocks, warp_bwd_plain

    built = _build_all(_gather_sources((ROOT / "one_to_many_gan_torch/csrc/warp.cu").read_text()))
    for name, info in built.items():
        cs.log(f"built {name} in {info['build_s']:.1f} s; " + "; ".join(info["ptxas"][-8:]))
    libs = {}
    for name, info in built.items():
        lib = ctypes.CDLL(str(info["lib"]))
        lib.otm_warp_bwd.argtypes = [*[ctypes.c_void_p] * 7, ctypes.c_longlong,
                                     ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
                                     ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        lib.otm_warp_bwd.restype = ctypes.c_int
        libs[name] = lib
    gen = torch.Generator("cuda").manual_seed(7)
    flush = torch.zeros(128 * 2**20, dtype=torch.uint8, device="cuda")
    results = []
    for (b, h, w), dtype_name, aa in WARP_CASES:
        dtype = getattr(torch, dtype_name)
        _, sx, sy, wx, wy = cs._warp_inputs(torch, gen, b, h, w, dtype, aa)
        dout = torch.randn((b, h, w), generator=gen, device="cuda").to(dtype)
        blocks = hint_blocks(h, w)

        def call(t, lib, sx=sx, sy=sy, wx=wx, wy=wy, dims=(b, h, w), aa=aa, blocks=blocks):
            rec = torch.empty((dims[0], 12 + 3 * blocks), dtype=torch.float64, device="cuda")
            out = torch.empty_like(t)
            err = lib.otm_warp_bwd(t.data_ptr(), sx.data_ptr(), sy.data_ptr(), wx.data_ptr(),
                                   wy.data_ptr(), rec.data_ptr(), out.data_ptr(), *dims,
                                   0 if t.dtype == torch.float32 else 1, int(aa), RADIUS,
                                   blocks, torch.cuda.current_stream().cuda_stream)
            cs.check(err == 0, f"gather variant launch failed: {err}")
            return out

        want = warp_bwd_plain(dout, sx, sy, wx, wy, antialias=aa)
        errs = {}
        for name, lib in libs.items():
            if name.startswith("x_"):
                continue
            got = call(dout, lib)
            torch.cuda.synchronize()
            errs[name] = cs._check_bwd(torch, got, want, dout, (sx, sy, wx, wy), aa,
                                       f"gather variant {name}")["max_abs_err"]
        fns = {name: (lambda t, lib=lib: call(t, lib)) for name, lib in libs.items()}
        times = cs.time_cold_ms(torch, fns, dout, flush, reps=30)
        cs.log(f"warp_bwd [{b},{h},{w}] {dtype_name} aa={int(aa)}: " + " ".join(
            f"{k}={v:.4f}" for k, v in sorted(times.items(), key=lambda kv: kv[1])))
        results.append({"case": [b, h, w, dtype_name, aa], "ms": times, "max_abs_err": errs})
    return [{name: {"build_s": i["build_s"], "ptxas": i["ptxas"]} for name, i in built.items()},
            *results]


def int8_variants(torch) -> list:
    from one_to_many_gan_torch.ops.cuda import build
    from one_to_many_gan_torch.ops.cuda import int8_conv as k
    from one_to_many_gan_torch.ops.quantize import quantize_weight

    built = _build_all(_int8_sources((ROOT / "one_to_many_gan_torch/csrc/int8_conv.cu")
                                     .read_text()), "int8_conv")
    for name, info in built.items():
        cs.log(f"built {name} in {info['build_s']:.1f} s; " + "; ".join(info["ptxas"][-4:]))
    gen = torch.Generator("cuda").manual_seed(12)
    flush = torch.zeros(128 * 2**20, dtype=torch.uint8, device="cuda")
    sites = {}
    for kind, (b, c, h, w, o, pad_mode) in INT8_SITES.items():
        x = torch.randn((b, c, h, w), generator=gen, device="cuda")
        s = torch.randn((b, c), generator=gen, device="cuda")
        d = torch.rand((b, o), generator=gen, device="cuda") + 0.5
        w_q, w_scale = quantize_weight(torch.randn((o, c, 3, 3), generator=gen, device="cuda")
                                       * 0.05)
        for dtype in (torch.float32, torch.bfloat16):
            sites[(kind, str(dtype)[6:])] = {"x": x.to(dtype), "s": s, "w_q": w_q,
                                             "w_scale": w_scale, "d": d, "padding": 1,
                                             "pad_mode": pad_mode, "dtype": dtype}
        del x
    ragged = [site for shape in cs.INT8_RAGGED for site in cs.random_sites(torch, gen, *shape)]
    x_scales = {key: k.int8_prepass(site["x"], site["s"], site["dtype"])
                for key, site in sites.items()}
    results = []
    try:
        for name, info in built.items():
            build._loaded["int8_conv"] = ctypes.CDLL(str(info["lib"]))  # the wrapper's library

            def conv(site, x_scale):
                return k.fused_int8_conv(site["x"], site["s"], x_scale, site["w_q"],
                                         site["w_scale"], site["d"], padding=site["padding"],
                                         pad_mode=site["pad_mode"], dtype=site["dtype"])

            if not name.startswith("x_"):
                for site in ragged + list(sites.values()):
                    cs.check(torch.equal(cs.int8_run(site), cs.int8_run(site, plain=True)),
                             f"int8 variant {name} differs from the plain version at "
                             f"{cs._site_label(site)}")
            ms = {}
            for key, site in sites.items():
                ms["/".join(key)] = cs.time_cold_ms(
                    torch, {name: lambda a, xs=x_scales[key]: conv(a, xs)}, site, flush,
                    reps=10)[name]
            cs.log(f"int8 {name}: " + " ".join(f"{k2}={v:.4f}" for k2, v in ms.items()))
            results.append({"variant": name, "ms": ms})
    finally:
        build._loaded.pop("int8_conv", None)
    return [{name: {"build_s": i["build_s"], "ptxas": i["ptxas"]} for name, i in built.items()},
            *results]


def main() -> int:
    import torch

    what = sys.argv[1] if len(sys.argv) > 1 else ""
    sweeps = {"in-plans": in_plans, "warp-variants": warp_variants,
              "gather-variants": gather_variants, "int8-variants": int8_variants,
              "up-plans": up_plans}
    if what not in sweeps:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("sweep_torch_kernels: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    cs.log(smi)
    results = sweeps[what](torch)
    OUT.mkdir(exist_ok=True)
    (OUT / f"sweep_{what}.json").write_text(
        json.dumps({"nvidia_smi": smi, "results": results}, indent=1, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
