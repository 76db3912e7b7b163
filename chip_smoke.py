"""Drive the PyTorch port's 1->N serving path on one NVIDIA GPU, end to end.

    python3 chip_smoke.py

Run it from the repository root on a host with one CUDA card (an H100:
the kernels are built for sm_90a). It builds every CUDA kernel of the
path from ``one_to_many_gan_torch/csrc/``, then runs, in order:

1. environment: the card's name and power limit, torch and CUDA
   versions, the kernel build time;
2. each kernel against its plain PyTorch version at the serving shapes,
   with the kernel's, the plain version's, the library call's and the
   memory bound's times;
3. the HTTP server of ``configs/default.toml`` at full width (512x256,
   float32, fresh weights from seed 0): ``/generate`` at n = 8, 32, 64,
   zip and npy, a concurrent burst, ``/healthz`` and ``/stats``, with the
   launch count of every kernel read around it;
4. the card against the CPU on the same weights and draws;
5. the same path in bfloat16;
6. where the time goes: one n=64 request of each precision under
   ``torch.profiler``, its kernels ranked by device time and the share
   of the request's wall time the device was busy.

Any failed check raises, and the script exits non-zero. Before its last
line it prints one JSON line ``{"kernels": [...]}``; its last line is
``{"ok": true, "device": {...}}``. Every number it prints is measured in
this run; a copy of them goes to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

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
    t0 = time.perf_counter()
    info = build.build("instance_norm")
    seconds = time.perf_counter() - t0
    log(f"built instance_norm.cu in {info['seconds']:.2f} s")
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
    cases = []
    for dtype_name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        for b in (1, 4):
            for c, h, w in IN_SHAPES:
                x = torch.randn((b, c, h, w), generator=gen, device="cuda") * 2 + 0.5
                x = x.to(dtype)
                nbytes = 2 * x.numel() * x.element_size()
                for relu in (False, True):
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
    del flush
    torch.cuda.empty_cache()

    def per_encode(dtype_name: str, b: int, key: str) -> float:
        table = {(k["c"], k["h"], k["w"], k["relu"]): k[key] for k in cases
                 if k["dtype"] == dtype_name and k["b"] == b}
        return sum(table[site] for site in ENCODE_SITES)

    encode = {
        f"{dtype_name}_b{b}": {
            key: per_encode(dtype_name, b, key)
            for key in ("kernel_ms", "plain_ms", "library_ms", "bound_ms")
        }
        for dtype_name in IN_TOL for b in (1, 4)
    }
    for name, sums in encode.items():
        log(f"IN per encode ({name}, 9 sites): " + ", ".join(
            f"{k} {v:.4f}" for k, v in sums.items()))
    log(f"phase 2 ok: {len(cases)} kernel cases within tolerance")
    return {"cases": cases, "per_encode": encode}


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


def phase_profile(torch, engine, source: np.ndarray, label: str, n: int = 64) -> dict:
    """Kernels of one ``engine.generate`` at ``n`` ranked by device time,
    and the device's busy share of the request's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    engine.generate(source, n, seed=0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.generate(source, n, seed=0)
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
    check(busy_ms > 0, f"the profiler saw no device time in the {label} request")
    log(f"profile {label} n={n}: wall {wall_ms:.2f} ms, device busy {busy_ms:.2f} ms "
        f"({busy_ms / wall_ms:.1%}), {len(kernels)} kernel names")
    for k in kernels[:12]:
        log(f"  {k['ms']:9.3f} ms {k['ms'] / busy_ms:6.1%} x{k['calls']:<4d} {k['name'][:110]}")
    return {"wall_ms": wall_ms, "busy_ms": busy_ms, "kernels": kernels[:40]}


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

    enc = report["kernels"]["per_encode"]["float32_b1"]
    f32_cases = [k for k in report["kernels"]["cases"] if k["dtype"] == "float32"]
    kernels = [{
        "name": "instance_norm",
        "route": "cuda",
        "source": "one_to_many_gan_torch/csrc/instance_norm.cu",
        "replaces": IN_REPLACES,
        "launches": report["serve"]["launches"],
        "max_abs_err": max(k["max_abs_err"] for k in f32_cases),
        "ms": enc["kernel_ms"],
        "plain_ms": enc["plain_ms"],
        "bound_ms": enc["bound_ms"],
        "bound_by": "bytes",
        "library_ms": enc["library_ms"],
        "per": "the 9 instance norms of one encode at B=1, float32, cold L2",
        "checked_in": "phase 2",
    }]
    OUT.parent.mkdir(parents=True, exist_ok=True)
    OUT.write_text(json.dumps(report, indent=1, default=str))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
