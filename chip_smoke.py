"""Drive the PyTorch port on one NVIDIA GPU, end to end: the 1->N serving
path and the discriminator phase of training.

    python3 chip_smoke.py

Run it from the repository root on a host with one CUDA card (an H100:
the kernels are built for sm_90a). It builds every CUDA kernel of the
port from ``one_to_many_gan_torch/csrc/`` (one nvcc per source, all
started together), then runs, in order:

1. environment: the card's name and power limit, torch and CUDA
   versions, the kernel build time;
2. the instance-norm kernel against its plain PyTorch version at the
   serving shapes and at the 12 shapes of one D phase (phase 8), float32
   and bfloat16, with the kernel's, the plain version's, the library
   call's and the memory bound's times;
3. the HTTP server of ``configs/default.toml`` at full width (512x256,
   float32, fresh weights from seed 0): ``/generate`` at n = 8, 32, 64,
   zip and npy, a concurrent burst, ``/healthz`` and ``/stats``, with the
   launch count of every kernel read around it;
4. the card against the CPU on the same weights and draws;
5. the same path in bfloat16;
6. where the time goes: one n=64 request of each precision under
   ``torch.profiler``, its kernels ranked by device time and the share
   of the request's wall time the device was busy;
7. the warp kernel against its plain version at the D phase's
   [16, 256, 256] and the default config's [4, 512, 256], float32 and
   bfloat16, antialias on and off, on the coordinates and widths of
   ADA draws at p = 0.9, with the kernel's, the plain version's,
   ``F.grid_sample``'s (antialias off, float32) and the bound's times;
8. the D phase of training at the bench config (256x256, batch 16,
   bfloat16, 7 resnet blocks, buffer 8, fresh weights from seed 0, ADA p
   set to 0.6, synthetic batches): 3 warm-up and 20 timed steps, with the
   launch counts per step (2 warps, 12 instance norms), the checks that
   the losses are finite, the discriminator moved, the buffer filled and
   the ADA window advanced, and one step under ``torch.profiler``;
9. the card against the CPU: the discriminator's inputs, loss, scores
   and gradients of one float32 D phase (TF32 off) at 256x256, batch 4, on
   the same weights, batches and draws; the CPU's gradients on the card's
   inputs; and, on the CPU's inputs, the card's gradients (as configured,
   with cuDNN deterministic, without cuDNN, with TF32 on) and the CPU's
   against a float64 pass on the CPU.

Any failed check raises, and the script exits non-zero. Before its last
line it prints one JSON line ``{"kernels": [...]}``; its last line is
``{"ok": true, "device": {...}}``. Every number it prints is measured in
this run; a copy of them goes to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import contextlib
import copy
import io
import json
import statistics
import subprocess
import sys
import threading
import time
import urllib.request
import zipfile
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
CONFIG = ROOT / "configs" / "default.toml"
OUT = ROOT / "chiprun_out" / "chip_smoke.json"

# H100 SXM device memory rate (NVIDIA data sheet), for the bytes bound.
HBM_BYTES_PER_S = 3.35e12
# The JAX package's own instance-norm tolerances (tests/test_pallas_kernels.py).
IN_TOL = {"float32": 2e-5, "bfloat16": 0.05}
# Card against CPU, float32 with TF32 off, on the tanh output in [-1, 1]:
# cuDNN and oneDNN pick different convolution algorithms and summation
# orders. 1e-3 is an eighth of one uint8 output level (2 / 255).
CARD_VS_CPU_TOL = 1e-3
# bfloat16 against float32: mean abs error on the tanh output, the JAX
# package's own bound (tests/test_bf16.py).
BF16_MEAN_TOL = 0.05
BUCKETS = (8, 32, 64)
REPS = 3  # timed requests per bucket
# The instance norms of one encode at the shipped config, per source
# image: (C, H, W, relu). Stem, 2 down convs, 3 resnet blocks x 2.
ENCODE_SITES = (
    [(64, 512, 256, True), (128, 512, 256, True), (256, 256, 128, True)]
    + [(256, 128, 64, True), (256, 128, 64, False)] * 3
)
IN_SHAPES = sorted({site[:3] for site in ENCODE_SITES})
# The TPU kernel it replaces, in the JAX package: its pl.pallas_call.
IN_REPLACES = "ops/pallas/instance_norm.py:72"
WARP_REPLACES = "ops/pallas/warp.py:177"
KERNEL_SOURCES = ("instance_norm", "warp")  # csrc/<name>.cu
# The warp's plain version in float32: the JAX package's warp tolerance
# (tests/test_pallas_kernels.py). bfloat16: one bf16 ulp of the output plus
# 2^-19 of the largest |image| value, under the JAX package's 0.05. Both
# sides use the same weights and form the same exact products (bf16 weight
# times bf16 pixel). The plain version sums them in float64 and rounds once
# to bf16, so no GEMM's summation order enters it; the kernel sums in
# float32, which errs by at most (nx + ny) * 2^-24 * max|x| * 1.03 for
# nx, ny <= 12 taps per axis whose weights sum to at most 1.03:
# 25 * 2^-24 < 2^-19. Where the taps cancel to an output near 0 that
# term is more than a bf16 ulp.
WARP_TOL_F32 = 2e-6
WARP_TOL_BF16_SUM = 2.0**-19
WARP_TOL_BF16_ABS = 0.05
# The warp's shapes: the D phase's (bench config) and the default config's.
WARP_SHAPES = ((16, 256, 256), (4, 512, 256))
# H100 SXM float32 rate outside the tensor cores (NVIDIA data sheet), for
# the warp's operations bound.
F32_FLOP_PER_S = 67e12
# The D phase: the bench config of the JAX package (256x256, batch 16,
# bf16, min_latent 64, 7 resnet blocks, w_dim 6, buffer 8, antialiased
# ADA), ADA p set to 0.6 so that transforms and wide tents occur.
D_SIZE, D_BATCH, D_ADA_P = 256, 16, 0.6
D_WARMUP, D_STEPS = 3, 20
D_WARPS_PER_STEP = 2
# The instance norms of one D phase, (B, C, H, W, relu): the generator's
# encode at B = 16 (its 9 sites at 256x256) and the discriminator's trunk
# on the packed batch of 32 (no ReLU: a LeakyReLU follows). The trunk's
# planes (126^2, 62^2, 30^2) are no multiple of 8, so in bfloat16 the
# kernel takes its scalar path there.
D_IN_SITES = (
    [(D_BATCH, c, h, w, relu) for c, h, w, relu in
     [(64, 256, 256, True), (128, 256, 256, True), (256, 128, 128, True)]
     + [(256, 64, 64, True), (256, 64, 64, False)] * 3]
    + [(2 * D_BATCH, c, h, w, False) for c, h, w in
       [(128, 126, 126), (256, 62, 62), (512, 30, 30)]]
)
D_IN_PER_STEP = len(D_IN_SITES)  # 12
# Card against CPU, one float32 D phase with TF32 off (phase 9). Readings
# on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md, PR 3). cuDNN and oneDNN
# pick different algorithms and summation orders through the generator,
# the warp and the discriminator:
# - the discriminator's inputs: 6.0e-5 apart; limit CARD_VS_CPU_TOL.
# - loss: 9.3e-8 relative; limit 1e-4. Scores: 4.2e-5; limit 1e-3.
# - gradients on the same inputs, against a float64 pass, per leaf
#   relative to its norm: card 1.9e-7 (head) to 1.06e-4, CPU 1.2e-6 to
#   6.2e-5; with TF32 on the card reads 2.2e-4 (head) and 4.3e-3 to 6.0e-3
#   (trunk). Limit 5e-4: 4.7x the card's reading, 8.6x below TF32's trunk.
# - gradients end to end, each side on its own inputs: 1.6e-4 to 5.2e-4
#   (6.1e-4 in an earlier run). The inputs' 6e-5 difference moves them
#   more than either side's rounding does. Limit 2e-3: 3.3x the largest
#   reading, below TF32's.
# The biases of the convs an instance norm follows have gradient 0 in
# exact arithmetic: those are held below 1e-4 of the whole gradient's norm.
D_CPU_BATCH = 4
D_LOSS_RTOL = 1e-4
D_SCORE_ATOL = 1e-3
D_GRAD_RTOL = 2e-3
D_GRAD_F64_RTOL = 5e-4


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


# ---------------------------------------------------------------- phase 1


def phase_environment(torch, build) -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
        f"cuda {torch.version.cuda}  device {torch.cuda.get_device_name(0)}  "
        f"count {torch.cuda.device_count()}")
    from concurrent.futures import ThreadPoolExecutor

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNEL_SOURCES)) as pool:
        infos = dict(zip(KERNEL_SOURCES, pool.map(build.build, KERNEL_SOURCES), strict=True))
    seconds = time.perf_counter() - t0
    for name, info in infos.items():
        log(f"built {name}.cu in {info['seconds']:.2f} s")
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas: {line.strip()}")
    log(f"phase 1 ok: kernels built in {seconds:.2f} s")
    return {"nvidia_smi": smi, "torch": torch.__version__, "cuda": torch.version.cuda,
            "build_s": seconds}


# ---------------------------------------------------------------- phase 2


def time_cold_ms(torch, fns: dict, x, flush, reps: int = 30) -> dict:
    """Median device time of each ``fns[name](x)`` over ``reps`` rounds.
    A round launches every function once, in turns, each launch after a
    read of ``flush`` that evicts ``x`` from the 50 MB L2. A read, not a
    write: a written flush leaves the L2 full of dirty lines, whose
    write-back would be charged to the timed launch."""
    for fn in fns.values():
        fn(x)
        fn(x)
    times: dict[str, list[float]] = {name: [] for name in fns}
    for _ in range(reps):
        for name, fn in fns.items():
            flush.sum()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn(x)
            end.record()
            end.synchronize()
            times[name].append(start.elapsed_time(end))
    return {name: statistics.median(t) for name, t in times.items()}


def phase_kernels(torch) -> dict:
    import torch.nn.functional as F

    from one_to_many_gan_torch.ops.cuda import fused_instance_norm, instance_norm_plain

    gen = torch.Generator("cuda").manual_seed(0)
    flush = torch.zeros(128 * 2**20, dtype=torch.uint8, device="cuda")
    serve_sites = [(b, c, h, w, relu) for b in (1, 4) for c, h, w in IN_SHAPES
                   for relu in (False, True)]
    sites = serve_sites + sorted(set(D_IN_SITES) - set(serve_sites))
    cases = []
    for dtype_name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        for b, c, h, w, relu in sites:
            x = torch.randn((b, c, h, w), generator=gen, device="cuda") * 2 + 0.5
            x = x.to(dtype)
            nbytes = 2 * x.numel() * x.element_size()
            got = fused_instance_norm(x, relu=relu)
            want = instance_norm_plain(x, relu=relu)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            tol = IN_TOL[dtype_name]
            case = {
                "dtype": dtype_name, "b": b, "c": c, "h": h, "w": w, "relu": relu,
                "max_abs_err": err, "tol": tol,
                **time_cold_ms(torch, {
                    "kernel_ms": lambda t, r=relu: fused_instance_norm(t, relu=r),
                    "plain_ms": lambda t, r=relu: instance_norm_plain(t, relu=r),
                    "library_ms": F.instance_norm,
                }, x, flush),
                "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            }
            cases.append(case)
            log(f"IN {dtype_name:8s} B={b} [{c},{h},{w}] relu={int(relu)}: "
                f"max_abs_err {err:.3g} (tol {tol}) kernel {case['kernel_ms']:.4f} ms "
                f"plain {case['plain_ms']:.4f} ms library {case['library_ms']:.4f} ms "
                f"bound {case['bound_ms']:.4f} ms")
            check(err <= tol, f"IN kernel disagrees with its plain version: {case}")
            del x, got, want
    del flush
    torch.cuda.empty_cache()
    keys = ("kernel_ms", "plain_ms", "library_ms", "bound_ms")

    def per_sites(dtype_name: str, sites: list, label: str) -> dict:
        table = {(k["b"], k["c"], k["h"], k["w"], k["relu"]): k for k in cases
                 if k["dtype"] == dtype_name}
        sums = {key: sum(table[site][key] for site in sites) for key in keys}
        log(f"IN per {label} ({dtype_name}, {len(sites)} sites): " + ", ".join(
            f"{k} {v:.4f}" for k, v in sums.items()))
        return sums

    encode = {f"{dtype_name}_b{b}": per_sites(
        dtype_name, [(b, *site) for site in ENCODE_SITES], f"encode at B={b}")
        for dtype_name in IN_TOL for b in (1, 4)}
    d_step = {dtype_name: per_sites(dtype_name, D_IN_SITES, "D step")
              for dtype_name in IN_TOL}
    log(f"phase 2 ok: {len(cases)} kernel cases within tolerance")
    return {"cases": cases, "per_encode": encode, "per_d_step": d_step}


# ---------------------------------------------------------------- phase 3


def _png(image_u8: np.ndarray) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(image_u8.squeeze(-1)).save(buf, format="PNG")
    return buf.getvalue()


def _source_image(seed: int, h: int, w: int) -> np.ndarray:
    """A smooth random grey image [H, W, 1] uint8 (low-frequency noise)."""
    rng = np.random.default_rng(seed)
    coarse = rng.uniform(0, 255, (h // 16 + 1, w // 16 + 1))
    img = np.kron(coarse, np.ones((16, 16)))[:h, :w]
    return img.astype(np.uint8)[:, :, None]


def _post(port: int, body: bytes, **query) -> tuple[bytes, float]:
    url = f"http://127.0.0.1:{port}/generate?" + "&".join(f"{k}={v}" for k, v in query.items())
    req = urllib.request.Request(url, data=body, method="POST",
                                 headers={"Content-Type": "image/png"})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=300) as resp:
        payload = resp.read()
    return payload, (time.perf_counter() - t0) * 1e3


def _get(port: int, path: str) -> dict:
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=60) as resp:
        return json.loads(resp.read())


def _npy(payload: bytes) -> np.ndarray:
    return np.load(io.BytesIO(payload))


def _check_out(out: np.ndarray, n: int, h: int, w: int) -> None:
    check(out.shape == (n, h, w, 1), f"output shape {out.shape}, want {(n, h, w, 1)}")
    check(out.dtype == np.uint8, f"output dtype {out.dtype}")
    if n > 1:
        check(not np.array_equal(out[0], out[1]), "styles do not differ within a request")


def phase_serve(torch, config, source: np.ndarray) -> tuple[dict, object]:
    from one_to_many_gan_torch.ops.cuda import fused_instance_norm
    from one_to_many_gan_torch.serve import InferenceEngine, make_server

    h, w = config["data"]["image_size"]
    engine = InferenceEngine(config, buckets=BUCKETS)
    check(engine.device.type == "cuda", f"engine on {engine.device}")
    warm_s = engine.warmup()
    log(f"engine warm in {warm_s:.2f} s on {engine.device}")
    server = make_server(engine, "127.0.0.1", 0, max_batch=4)
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    body = _png(source)
    result = {"warmup_s": warm_s, "buckets": {}}
    try:
        fused_instance_norm.launches = 0
        engine.device_calls = 0
        # the main path: HTTP requests through the batcher to the card
        for n in BUCKETS:
            npy_ms, zip_ms = [], []
            for rep in range(REPS):
                payload, ms = _post(port, body, n=n, seed=rep, format="npy")
                _check_out(_npy(payload), n, h, w)
                npy_ms.append(ms)
                payload, ms = _post(port, body, n=n, seed=rep)
                with zipfile.ZipFile(io.BytesIO(payload)) as zf:
                    names = zf.namelist()
                check(len(names) == n and names[0] == "shoemark_0000.png", f"zip {names[:3]}")
                zip_ms.append(ms)
            med = statistics.median(npy_ms)
            result["buckets"][n] = {"npy_ms": npy_ms, "zip_ms": zip_ms,
                                    "npy_images_per_s": n / med * 1e3}
            log(f"n={n}: npy latency median {med:.2f} ms ({n / med * 1e3:.1f} images/s), "
                f"zip median {statistics.median(zip_ms):.2f} ms")
        same_a = _npy(_post(port, body, n=8, seed=7, theta=1.0, format="npy")[0])
        same_b = _npy(_post(port, body, n=8, seed=7, theta=1.0, format="npy")[0])
        theta0 = _npy(_post(port, body, n=8, seed=7, theta=0.0, format="npy")[0])
        check(np.array_equal(same_a, same_b), "the same seed gave different outputs")
        check(not np.array_equal(same_a, theta0), "theta=0 equals theta=1")
        # a concurrent burst of 4 for the batcher
        burst: dict[int, np.ndarray] = {}
        barrier = threading.Barrier(4)

        def client(i: int) -> None:
            barrier.wait()
            burst[i] = _npy(_post(port, body, n=8, seed=100 + i, format="npy")[0])

        clients = [threading.Thread(target=client, args=(i,)) for i in range(4)]
        for t in clients:
            t.start()
        for t in clients:
            t.join(timeout=300)
        check(sorted(burst) == [0, 1, 2, 3], f"burst answered {sorted(burst)}")
        for out in burst.values():
            _check_out(out, 8, h, w)
        health = _get(port, "/healthz")
        stats = _get(port, "/stats")
        launches, calls = fused_instance_norm.launches, engine.device_calls
    finally:
        server.shutdown()
        server.server_close()
        server.batcher.close()
        thread.join(timeout=30)
    log(f"/healthz {json.dumps(health)}")
    log(f"/stats {json.dumps(stats)}")
    check(health["status"] == "ok" and health["device"].startswith("cuda"), "healthz")
    check(stats["errors"] == 0, f"server errors: {stats}")
    check(calls > 0 and launches == 9 * calls,
          f"IN launches {launches} for {calls} device calls (want 9 per call)")
    log(f"IN kernel launches on the main path: {launches} for {calls} device calls "
        f"({launches // calls} per call)")
    # batch equals solo on the card: one coalesced call against solo calls
    imgs = [_source_image(10 + i, h, w) for i in range(3)]
    batched = engine.generate_batch(imgs, [8, 8, 8], [1, 2, 3], [1.0, 0.5, 1.0])
    for i in range(3):
        solo = engine.generate(imgs[i], 8, seed=i + 1, theta=[1.0, 0.5, 1.0][i])
        diff = np.abs(batched[i].astype(int) - solo.astype(int)).max()
        check(diff <= 1, f"coalesced request {i} differs from solo by {diff} levels")
    result.update({"launches": launches, "device_calls": calls, "stats": stats,
                   "coalesced_requests": stats["batching"]["coalesced_requests"]})
    log("phase 3 ok: server answered every request; batch equals solo")
    return result, engine


# ---------------------------------------------------------------- phase 4/5


def _fixed_inputs(torch, source: np.ndarray, w_dim: int):
    from one_to_many_gan_torch.data.pipeline import normalize_u8

    image = torch.from_numpy(normalize_u8(source[None]))
    z = torch.from_numpy(np.random.default_rng(5).standard_normal((1, 2, w_dim)).astype(np.float32))
    return image, z, torch.ones(1)


def phase_card_vs_cpu(torch, config, engine, source: np.ndarray) -> tuple[dict, np.ndarray]:
    from one_to_many_gan_torch.core import Models, make_inference_fns

    args = _fixed_inputs(torch, source, engine.models.w_dim)
    card = make_inference_fns(engine.models)[2](*args).float().cpu().numpy()
    cpu_models = Models(config, device="cpu", seed=0)
    t0 = time.perf_counter()
    cpu = make_inference_fns(cpu_models)[2](*args).float().numpy()
    cpu_s = time.perf_counter() - t0
    err = float(np.abs(card - cpu).max())
    log(f"card vs CPU (B=1, n=2, float32, TF32 off): max_abs_err {err:.3g} "
        f"(tol {CARD_VS_CPU_TOL}); CPU pass {cpu_s:.1f} s")
    check(np.isfinite(card).all() and card.shape == (1, 2, *config["data"]["image_size"], 1),
          f"card output {card.shape}")
    check(err <= CARD_VS_CPU_TOL, f"card disagrees with the CPU: {err}")
    log("phase 4 ok")
    return {"max_abs_err": err, "tol": CARD_VS_CPU_TOL}, card


def phase_bf16(torch, config, source: np.ndarray, card_f32: np.ndarray):
    from one_to_many_gan_torch.core import make_inference_fns
    from one_to_many_gan_torch.ops.cuda import fused_instance_norm
    from one_to_many_gan_torch.serve import InferenceEngine

    cfg = copy.deepcopy(config)
    cfg["tpu"]["precision"] = "bfloat16"
    engine = InferenceEngine(cfg, buckets=BUCKETS)
    warm_s = engine.warmup(batched=False)
    out = make_inference_fns(engine.models)[2](*_fixed_inputs(torch, source, engine.models.w_dim))
    check(out.dtype == torch.bfloat16, f"bf16 output dtype {out.dtype}")
    diff = np.abs(out.float().cpu().numpy() - card_f32)
    log(f"bf16 vs f32 on the card: mean abs {diff.mean():.4g} (tol {BF16_MEAN_TOL}), "
        f"max abs {diff.max():.4g}; warm in {warm_s:.2f} s")
    check(np.isfinite(diff).all() and diff.mean() < BF16_MEAN_TOL, "bf16 drifted from f32")
    h, w = cfg["data"]["image_size"]
    latency = {}
    fused_instance_norm.launches = 0
    engine.device_calls = 0
    for n in BUCKETS:
        times = []
        for rep in range(REPS):
            t0 = time.perf_counter()
            res = engine.generate(source, n, seed=rep)
            times.append((time.perf_counter() - t0) * 1e3)
            _check_out(res, n, h, w)
        med = statistics.median(times)
        latency[n] = {"engine_ms": times, "images_per_s": n / med * 1e3}
        log(f"bf16 n={n}: engine.generate median {med:.2f} ms ({n / med * 1e3:.1f} images/s)")
    check(fused_instance_norm.launches == 9 * engine.device_calls,
          f"bf16 IN launches {fused_instance_norm.launches} for {engine.device_calls} calls")
    log("phase 5 ok")
    return {"mean_abs_vs_f32": float(diff.mean()), "max_abs_vs_f32": float(diff.max()),
            "latency": latency}, engine


# ---------------------------------------------------------------- phase 6


def profile_call(torch, fn, label: str) -> dict:
    """Kernels of one ``fn()`` ranked by device time, and the device's busy
    share of its wall time (``fn`` ends in a host read or a sync)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = []
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        kernels.append({"name": evt.key, "calls": evt.count, "ms": us / 1e3})
    kernels.sort(key=lambda k: -k["ms"])
    busy_ms = sum(k["ms"] for k in kernels)
    check(busy_ms > 0, f"the profiler saw no device time in {label}")
    log(f"profile {label}: wall {wall_ms:.2f} ms, device busy {busy_ms:.2f} ms "
        f"({busy_ms / wall_ms:.1%}; idle {1 - busy_ms / wall_ms:.1%}), "
        f"{len(kernels)} kernel names")
    for k in kernels[:12]:
        log(f"  {k['ms']:9.3f} ms {k['ms'] / busy_ms:6.1%} x{k['calls']:<4d} {k['name'][:110]}")
    return {"wall_ms": wall_ms, "busy_ms": busy_ms, "idle_share": 1 - busy_ms / wall_ms,
            "kernels": kernels[:40]}


def phase_profile(torch, engine, source: np.ndarray, label: str, n: int = 64) -> dict:
    """Kernels of one ``engine.generate`` at ``n`` ranked by device time,
    and the device's busy share of the request's wall time."""
    return profile_call(torch, lambda: engine.generate(source, n, seed=0), f"{label} n={n}")


# ---------------------------------------------------------------- phase 7


def _warp_inputs(torch, gen, b: int, h: int, w: int, dtype, antialias: bool):
    """Images and the coordinates and widths of ADA draws at p = 0.9."""
    from one_to_many_gan_torch.augment.pipeline import (
        draw_augment,
        geometric_matrix,
        source_coords,
        tent_widths,
    )

    draws = draw_augment(gen, b, "cuda")
    g = geometric_matrix(draws.geom, h, w, torch.tensor(0.9, device="cuda"))
    sx, sy = source_coords(g, h, w)
    wx, wy = tent_widths(g, antialias=antialias)
    x = (torch.rand((b, h, w), generator=gen, device="cuda") * 2 - 1).to(dtype)
    return x, sx.contiguous(), sy.contiguous(), wx, wy


def _taps(torch, c, width, n: int, antialias: bool):
    """In-frame taps per output pixel on one axis: the integer positions
    within (c - width, c + width) of [0, n) (width 1 without antialias)."""
    wd = width[:, None, None] if antialias else 1.0
    lo = torch.clamp(torch.floor(c - wd) + 1, min=0)
    hi = torch.clamp(torch.ceil(c + wd) - 1, max=n - 1)
    return torch.clamp(hi - lo + 1, min=0)


def phase_warp(torch) -> dict:
    import torch.nn.functional as F

    from one_to_many_gan_torch.ops.cuda import warp, warp_plain

    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 matmul is on: the plain warp needs f32")
    gen = torch.Generator("cuda").manual_seed(7)
    flush = torch.zeros(128 * 2**20, dtype=torch.uint8, device="cuda")
    cases = []
    for b, h, w in WARP_SHAPES:
        for dtype_name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
            for aa in (False, True):
                x, sx, sy, wx, wy = _warp_inputs(torch, gen, b, h, w, dtype, aa)
                got = warp(x, sx, sy, wx, wy, antialias=aa)
                want = warp_plain(x, sx, sy, wx, wy, antialias=aa)
                torch.cuda.synchronize()
                diff = (got.double() - want.double()).abs()
                err = diff.max().item()
                mag = torch.maximum(got.double().abs(), want.double().abs()).clamp_min(2.0**-126)
                ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
                ulps = (diff / ulp).max().item()
                # bf16: one ulp is the two roundings; what exceeds it is the
                # kernel's float32 summation error, held to its bound
                sum_bound = WARP_TOL_BF16_SUM * x.abs().max().item()
                excess = ((diff - ulp).clamp_min(0) / sum_bound).max().item()
                fns = {
                    "kernel_ms": lambda t, a=(sx, sy, wx, wy, aa): warp(t, *a[:4], antialias=a[4]),
                    "plain_ms": lambda t, a=(sx, sy, wx, wy, aa): warp_plain(
                        t, *a[:4], antialias=a[4]),
                }
                lib_err = None
                if not aa and dtype == torch.float32:
                    # grid_sample, align_corners=True: pixel = (g + 1) / 2 * (n - 1)
                    grid = torch.stack([sx / (w - 1) * 2 - 1, sy / (h - 1) * 2 - 1], dim=-1)

                    def lib(t, grid=grid):
                        return F.grid_sample(t[:, None], grid, mode="bilinear",
                                             padding_mode="zeros", align_corners=True)[:, 0]

                    fns["library_ms"] = lib
                    lib_err = (lib(x) - want).abs().max().item()
                times = time_cold_ms(torch, fns, x, flush)
                px = b * h * w
                nbytes = px * (2 * x.element_size() + 8) + 2 * b * 4
                taps = (_taps(torch, sx, wx, w, aa) * _taps(torch, sy, wy, h, aa)).sum().item()
                ops_ms = 2 * taps / F32_FLOP_PER_S * 1e3
                case = {
                    "b": b, "h": h, "w": w, "dtype": dtype_name, "antialias": aa,
                    "max_abs_err": err, "max_bf16_ulps": ulps, "bf16_excess_of_sum_bound": excess,
                    "grid_sample_err": lib_err,
                    "widths": [wx.min().item(), wx.max().item(), wy.min().item(), wy.max().item()],
                    "taps_per_pixel": taps / px, "bytes_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                    "ops_ms": ops_ms, **times, "library_ms": times.get("library_ms"),
                }
                case["bound_ms"] = max(case["bytes_ms"], ops_ms)
                case["bound_by"] = "bytes" if case["bytes_ms"] >= ops_ms else "operations"
                cases.append(case)
                lib_txt = (f"grid_sample {case['library_ms']:.4f} ms (err {lib_err:.3g})"
                           if lib_err is not None else "grid_sample none" if aa else
                           "grid_sample n/a (a bf16 grid cannot hold pixel coordinates)")
                log(f"warp [{b},{h},{w}] {dtype_name:8s} aa={int(aa)}: max_abs_err {err:.3g} "
                    f"(bf16: {ulps:.2f} ulps, beyond one ulp {excess:.3f} of the sum bound) kernel {case['kernel_ms']:.4f} ms plain "
                    f"{case['plain_ms']:.4f} ms {lib_txt} bound {case['bound_ms']:.4f} ms "
                    f"({case['bound_by']}); {case['taps_per_pixel']:.1f} taps/pixel, widths "
                    + "/".join(f"{v:.2f}" for v in case["widths"]))
                check(torch.isfinite(got).all().item(), f"warp output not finite: {case}")
                if dtype == torch.float32:
                    check(err <= WARP_TOL_F32, f"warp kernel disagrees with its plain version: {case}")
                else:
                    check(excess <= 1.0 and err <= WARP_TOL_BF16_ABS,
                          f"bf16 warp kernel disagrees with its plain version: {case}")
                if lib_err is not None:
                    # grid_sample's normalised grid re-derives each coordinate
                    # (a few ulps of 255: ~1e-4 px), times the image's step
                    # between neighbours (up to 2 here)
                    check(lib_err <= 1e-3, f"grid_sample is not the same function: {case}")
    del flush
    torch.cuda.empty_cache()
    log(f"phase 7 ok: {len(cases)} warp cases within tolerance")
    return {"cases": cases}


# ---------------------------------------------------------------- phase 8


def d_phase_config(precision: str, batch: int):
    from one_to_many_gan_torch.presets import tiny_config

    return tiny_config(
        (D_SIZE, D_SIZE), batch, min_latent=64, w_dim=6, n_resnet_blocks=7, buffer_size=8,
        tpu={"precision": precision, "ada_pallas": True, "ada_antialias": True},
    )


def phase_d_phase(torch) -> dict:
    from one_to_many_gan_torch import train_d
    from one_to_many_gan_torch.ops.cuda import fused_instance_norm, warp

    config = d_phase_config("bfloat16", D_BATCH)
    models, state, d_phase, gen = train_d.setup(config, seed=0, ada_p=D_ADA_P, device="cuda")
    check(models.device.type == "cuda", f"models on {models.device}")
    d0 = [p.detach().clone() for p in state.discriminator.parameters()]
    warp.launches = 0
    fused_instance_norm.launches = 0
    # the main path: D phases through the entry points a trainer calls
    step_ms, metrics_log, counts = [], [], []
    for step in range(D_WARMUP + D_STEPS):
        w0, i0 = warp.launches, fused_instance_norm.launches
        t0 = time.perf_counter()
        state, metrics = train_d.run_step(config, models, state, d_phase, gen)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        m = {k: v.item() for k, v in metrics.items()}
        counts.append((warp.launches - w0, fused_instance_norm.launches - i0))
        metrics_log.append({**m, "buffer_count": state.buffer.count.item(),
                            "ada_count": state.ada.count.item(), "ms": ms})
        if step >= D_WARMUP:
            step_ms.append(ms)
    warps, ins = warp.launches, fused_instance_norm.launches
    n = D_WARMUP + D_STEPS
    for k, (nw, ni) in enumerate(counts):
        check(nw == D_WARPS_PER_STEP and ni == D_IN_PER_STEP,
              f"step {k}: {nw} warp and {ni} IN launches (want {D_WARPS_PER_STEP}, {D_IN_PER_STEP})")
    check(all(np.isfinite(m["disc_loss"]) for m in metrics_log), "a D loss is not finite")
    moved = max((p.detach() - q).abs().max().item()
                for p, q in zip(state.discriminator.parameters(), d0, strict=True))
    check(moved > 0, "the discriminator's parameters did not change")
    fill = [m["buffer_count"] for m in metrics_log]
    size = config["training"]["image_buffer_size"]
    check(fill == [min(size, D_BATCH * (k + 1)) for k in range(n)], f"buffer counts {fill}")
    ada_counts = [m["ada_count"] for m in metrics_log]
    check(all(a != b for a, b in zip(ada_counts, ada_counts[1:])), f"ADA window {ada_counts}")
    med = statistics.median(step_ms)
    log(f"D phase ({D_SIZE}x{D_SIZE}, batch {D_BATCH}, bf16): median step {med:.2f} ms over {D_STEPS} "
        f"(min {min(step_ms):.2f}, max {max(step_ms):.2f}) = {D_BATCH / med * 1e3:.1f} images/s")
    log(f"  launches on the main path: {warps} warp, {ins} IN over {n} steps "
        f"({warps // n} and {ins // n} per step); losses {metrics_log[0]['disc_loss']:.4f} -> "
        f"{metrics_log[-1]['disc_loss']:.4f}; ADA p {metrics_log[-1]['ada_p']:.4f}, window "
        f"counts {ada_counts[:8]}...; D moved by up to {moved:.3g}")
    profile = profile_call(
        torch, lambda: train_d.run_step(config, models, state, d_phase, gen),
        f"D phase step ({D_SIZE}x{D_SIZE}, batch {D_BATCH}, bf16)")
    log("phase 8 ok")
    return {"step_ms": step_ms, "median_step_ms": med, "images_per_s": D_BATCH / med * 1e3,
            "warp_launches": warps, "in_launches": ins, "steps": n, "metrics": metrics_log,
            "profile": profile, "max_abs_move": moved}


# ---------------------------------------------------------------- phase 9


def _to(tree, device):
    """Move every tensor of nested NamedTuples to ``device``."""
    if isinstance(tree, tuple):
        return type(tree)(*(_to(t, device) for t in tree))
    return tree.to(device)


@contextlib.contextmanager
def _cudnn_flags(torch, **flags):
    """``torch.backends.cudnn`` flags set inside the block, restored after."""
    cudnn = torch.backends.cudnn
    old = {k: getattr(cudnn, k) for k in flags}
    for k, v in flags.items():
        setattr(cudnn, k, v)
    try:
        yield
    finally:
        for k, v in old.items():
            setattr(cudnn, k, v)


def _d_grads(disc) -> dict:
    return {n: p.grad.double().cpu() for n, p in disc.named_parameters()}


def _zero_grad_leaf(name: str) -> bool:
    """The biases of the convs an instance norm follows: gradient 0 in exact
    arithmetic, so rounding noise on every side."""
    return name.endswith("bias") and name.startswith(("trunk.1", "trunk.2", "trunk.3"))


def _grad_rel(grads: dict, ref: dict) -> dict:
    """Per leaf: |grads - ref| / |ref| (Frobenius norms)."""
    return {n: ((g - ref[n]).norm() / ref[n].norm().clamp_min(1e-30)).item()
            for n, g in grads.items()}


def _exact_zeros(torch, disc, inputs) -> list:
    """Share of each trunk conv's outputs that is exactly 0 in one forward
    pass, where LeakyReLU's derivative jumps (1 at 0, 0.2 below)."""
    shares = []
    hooks = [conv.register_forward_hook(
        lambda _m, _i, out: shares.append((out == 0).double().mean().item()))
        for conv in disc.trunk]
    try:
        with torch.no_grad():
            disc(inputs)
    finally:
        for h in hooks:
            h.remove()
    return shares


def phase_d_card_vs_cpu(torch) -> dict:
    from one_to_many_gan_torch.core import train_step
    from one_to_many_gan_torch.core.state import Models, init_train_state
    from one_to_many_gan_torch.models import Discriminator

    config = d_phase_config("float32", D_CPU_BATCH)
    cpu_gen = torch.Generator().manual_seed(3)
    draws = train_step.draw_d_phase(cpu_gen, config, Models(config, device="cpu"))
    prints = train_step.synthetic_batch(cpu_gen, D_CPU_BATCH, (D_SIZE, D_SIZE), 1)
    marks = train_step.synthetic_batch(cpu_gen, D_CPU_BATCH, (D_SIZE, D_SIZE), 1)
    # The D pass of one phase, as d_phase runs it: its inputs (generator,
    # buffer, augment), then the loss and gradients on the packed batch.
    runs = {}
    for device in ("cuda", "cpu"):
        models = Models(config, device=device, seed=0)  # float32 on CUDA: TF32 off
        state = init_train_state(config, models, seed=0)
        state.ada = state.ada._replace(p=torch.tensor(D_ADA_P, device=device))
        t0 = time.perf_counter()
        aug_fake, aug_real, _ = train_step.make_d_inputs(config, models)(
            state, prints, marks, _to(draws, device))
        loss, real, fake = train_step.d_loss_and_grad(state.discriminator, aug_fake, aug_real)
        runs[device] = {
            "seconds": time.perf_counter() - t0, "loss": loss.item(),
            "scores": (real.cpu(), fake.cpu()), "inputs": (aug_fake.cpu(), aug_real.cpu()),
            "grads": _d_grads(state.discriminator), "disc": state.discriminator,
        }
    check(not torch.backends.cudnn.allow_tf32, "TF32 is on for the float32 card run")
    card, cpu = runs["cuda"], runs["cpu"]
    loss_rel = abs(card["loss"] - cpu["loss"]) / abs(cpu["loss"])
    input_err = max((a - b).abs().max().item()
                    for a, b in zip(card["inputs"], cpu["inputs"], strict=True))
    score_err = max((a - b).abs().max().item()
                    for a, b in zip(card["scores"], cpu["scores"], strict=True))
    total = torch.sqrt(sum(g.square().sum() for g in cpu["grads"].values())).item()
    card_vs_cpu = _grad_rel(card["grads"], cpu["grads"])

    # Where the card's gradient error comes from: one float64 pass on the
    # CPU (plain ops, the same weights) on the CPU's inputs, against the
    # CPU's float32 gradients and the card's, on the same inputs, as
    # configured, with cuDNN restricted to deterministic algorithms,
    # without cuDNN (PyTorch's own CUDA convolutions) and with TF32 on.
    packed = train_step.batch_pack(list(cpu["inputs"])).permute(0, 3, 1, 2)
    disc64 = Discriminator(1, dtype=torch.float64)
    disc64.load_state_dict(cpu["disc"].state_dict())
    t0 = time.perf_counter()
    train_step.d_loss_and_grad(disc64, *(t.double() for t in cpu["inputs"]))
    f64_s = time.perf_counter() - t0
    ref = _d_grads(disc64)
    vs_f64 = {"cpu": _grad_rel(cpu["grads"], ref)}
    # how far the inputs' difference alone moves the CPU's gradients
    train_step.d_loss_and_grad(cpu["disc"], *card["inputs"])
    input_effect = _grad_rel(_d_grads(cpu["disc"]), cpu["grads"])
    zeros = {"float64, CPU": _exact_zeros(torch, disc64, packed.double()),
             "cpu": _exact_zeros(torch, cpu["disc"], packed)}
    inputs = [t.cuda() for t in cpu["inputs"]]
    modes = {"card": {}, "card, cuDNN deterministic": {"deterministic": True},
             "card, no cuDNN": {"enabled": False}, "card, TF32 on": {"allow_tf32": True}}
    for label, flags in modes.items():
        with _cudnn_flags(torch, **flags):
            train_step.d_loss_and_grad(card["disc"], *inputs)
            vs_f64[label] = _grad_rel(_d_grads(card["disc"]), ref)
            zeros[label] = _exact_zeros(torch, card["disc"], packed.cuda())
    check(not torch.backends.cudnn.allow_tf32 and torch.backends.cudnn.enabled,
          "cuDNN flags were not restored")
    precision = {name: getattr(obj, "fp32_precision", None) for name, obj in (
        ("cudnn.conv", getattr(torch.backends.cudnn, "conv", None)),
        ("cuda.matmul", torch.backends.cuda.matmul))}

    names = list(ref)
    log(f"D phase card vs CPU ({D_SIZE}x{D_SIZE}, batch {D_CPU_BATCH}, float32, TF32 off; "
        f"fp32_precision {precision}): inputs max abs {input_err:.3g}; loss {card['loss']:.6f} "
        f"vs {cpu['loss']:.6f} (rel {loss_rel:.3g}, tol {D_LOSS_RTOL}); scores max abs "
        f"{score_err:.3g} (tol {D_SCORE_ATOL}); CPU pass {cpu['seconds']:.1f} s, float64 "
        f"pass {f64_s:.1f} s")
    log("  gradient error per leaf, relative to its norm (leaves with gradient 0 in exact "
        "arithmetic: absolute, relative to the whole gradient's norm):")
    log(f"  {'':38s}" + "".join(f"{n:>15s}" for n in names))
    rows = {"card vs CPU (own inputs)": card_vs_cpu,
            "CPU on the card's inputs vs CPU": input_effect,
            **{f"{k} vs float64": v for k, v in vs_f64.items()}}
    for label, rel in rows.items():
        log(f"  {label:38s}" + "".join(
            f"{rel[n] * ref[n].norm().item() / total if _zero_grad_leaf(n) else rel[n]:15.3g}"
            for n in names))
    log("  share of exact zeros at the trunk convs' outputs: " + "; ".join(
        f"{k} " + "/".join(f"{z:.4f}" for z in v) for k, v in zeros.items()))

    check(input_err <= CARD_VS_CPU_TOL, f"D inputs: card disagrees with CPU by {input_err}")
    check(np.isfinite(card["loss"]) and loss_rel <= D_LOSS_RTOL, "D loss: card disagrees with CPU")
    check(score_err <= D_SCORE_ATOL, f"D scores: card disagrees with CPU by {score_err}")
    for n in names:
        if _zero_grad_leaf(n):
            worst = max(card["grads"][n].norm().item(), cpu["grads"][n].norm().item())
            check(worst <= 1e-4 * total, f"{n}: gradient {worst:.3g} is not ~0")
            continue
        check(card_vs_cpu[n] <= D_GRAD_RTOL,
              f"{n}: card gradient off the CPU's by {card_vs_cpu[n]:.3g} of its norm")
        for label in ("cpu", "card"):
            check(vs_f64[label][n] <= D_GRAD_F64_RTOL,
                  f"{n}: {label} gradient off float64 by {vs_f64[label][n]:.3g} of its norm")
    log("phase 9 ok")
    return {"loss_card": card["loss"], "loss_cpu": cpu["loss"], "loss_rel": loss_rel,
            "input_max_abs": input_err, "score_max_abs": score_err,
            "grad_rel_card_vs_cpu": card_vs_cpu, "grad_rel_input_effect": input_effect,
            "grad_rel_vs_float64": vs_f64,
            "grad_norm_total": total, "exact_zero_shares": zeros, "fp32_precision": precision,
            "cpu_s": cpu["seconds"], "float64_s": f64_s}


# ------------------------------------------------------------------- main


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU", file=sys.stderr)
        return 1
    from one_to_many_gan_torch.config import load_config
    from one_to_many_gan_torch.ops.cuda import build

    report = {"environment": phase_environment(torch, build)}
    report["kernels"] = phase_kernels(torch)
    config = load_config(CONFIG)
    h, w = config["data"]["image_size"]
    source = _source_image(0, h, w)
    report["serve"], engine = phase_serve(torch, config, source)
    report["card_vs_cpu"], card = phase_card_vs_cpu(torch, config, engine, source)
    report["profile_f32"] = phase_profile(torch, engine, source, "float32")
    del engine
    torch.cuda.empty_cache()
    report["bf16"], engine = phase_bf16(torch, config, source, card)
    report["profile_bf16"] = phase_profile(torch, engine, source, "bfloat16")
    del engine
    torch.cuda.empty_cache()
    report["warp"] = phase_warp(torch)
    report["d_phase"] = phase_d_phase(torch)
    torch.cuda.empty_cache()
    report["d_card_vs_cpu"] = phase_d_card_vs_cpu(torch)

    enc = report["kernels"]["per_encode"]["float32_b1"]
    f32_cases = [k for k in report["kernels"]["cases"] if k["dtype"] == "float32"]
    kernels = [{
        "name": "instance_norm",
        "route": "cuda",
        "source": "one_to_many_gan_torch/csrc/instance_norm.cu",
        "replaces": IN_REPLACES,
        "launches": report["serve"]["launches"] + report["d_phase"]["in_launches"],
        "max_abs_err": max(k["max_abs_err"] for k in f32_cases),
        "ms": enc["kernel_ms"],
        "plain_ms": enc["plain_ms"],
        "bound_ms": enc["bound_ms"],
        "bound_by": "bytes",
        "library_ms": enc["library_ms"],
        "per": "the 9 instance norms of one encode at B=1, float32, cold L2",
        "per_d_step_bfloat16": report["kernels"]["per_d_step"]["bfloat16"],
        "launches_by_phase": {"serve (phase 3)": report["serve"]["launches"],
                              "D phase (phase 8)": report["d_phase"]["in_launches"]},
        "checked_in": "phase 2",
    }]
    d_case = next(c for c in report["warp"]["cases"] if (c["b"], c["h"], c["w"]) == WARP_SHAPES[0]
                  and c["dtype"] == "bfloat16" and c["antialias"])
    off_case = next(c for c in report["warp"]["cases"] if (c["b"], c["h"], c["w"]) ==
                    WARP_SHAPES[0] and c["dtype"] == "float32" and not c["antialias"])
    kernels.append({
        "name": "warp_fwd",
        "route": "cuda",
        "source": "one_to_many_gan_torch/csrc/warp.cu",
        "replaces": WARP_REPLACES,
        "launches": report["d_phase"]["warp_launches"],
        "max_abs_err": max(c["max_abs_err"] for c in report["warp"]["cases"]
                           if c["dtype"] == "float32"),
        "ms": d_case["kernel_ms"],
        "plain_ms": d_case["plain_ms"],
        "bound_ms": d_case["bound_ms"],
        "bound_by": d_case["bound_by"],
        "library_ms": None,
        "per": "one call at the D phase's [16,256,256], bfloat16, antialias on, cold L2; "
               "no single PyTorch call computes the antialiased warp",
        "grid_sample_ms_antialias_off_f32": off_case["library_ms"],
        "kernel_ms_antialias_off_f32": off_case["kernel_ms"],
        "checked_in": "phase 7",
    })
    OUT.parent.mkdir(parents=True, exist_ok=True)
    OUT.write_text(json.dumps(report, indent=1, default=str))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
