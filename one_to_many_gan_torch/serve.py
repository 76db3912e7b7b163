"""Persistent 1->N inference server on the GPU.

The JAX package's serving layer (its ``serve.py``) pointed
at a PyTorch engine: the same HTTP API, N buckets, batch buckets, dynamic
request batching and watchdogs. Steady-state request latency is the
device encode + decode plus the PNG or npy encode on the host.

One encode + one batched decode per device call: a request's N rounds UP
to the nearest bucket and the output is sliced on the host. Concurrent
requests sharing an n bucket coalesce through ``_Batcher`` into ONE
``many_to_many`` call (sources on the batch axis, styles on the style
axis). Request i draws its styles from its own
``torch.Generator(device).manual_seed(seed_i)``, so a coalesced request
equals the solo one. The same seed gives different shoemarks than the JAX
server (``core/inference.py``).

Data parallelism (``InferenceEngine(data_parallel=k)``, ``--data-parallel
k``; the JAX engine's, its ``serve.py``): one process holds k replicas of
the generator and mapping network, on ``cuda:0`` .. ``cuda:k-1`` (k CPU
replicas with ``--device cpu``); each device call splits the flattened
B*n style batch into k equal parts, each replica encodes the sources and
decodes its part on its card from a host thread of its own, and the parts
are joined on the host. -1 means every visible card; every n bucket must
divide by k. The draws are made on the first replica's device, so the
images equal one card's. Every replica encodes the sources again, so a
small n can take longer on k cards than on one.

Int8 serving (``InferenceEngine(int8=True)``, ``--int8``; the JAX
engine's): every replica's decoder runs its modulated convs on int8 codes
(``ops/quantize.py``: per-sample activation scales, per-output-channel
weight scales; each site an amax pre-pass and one fused modulated conv
on the card's int8 tensor cores, ``csrc/int8_conv.cu``). The same
checkpoints and artifacts load. With ``data_parallel = k`` each card
quantises its own slice of the style batch; the scales are per sample,
so its codes are one card's.

API (stdlib ``http.server``):

- ``GET /healthz`` -> ``{"status": "ok", "step": N, "ema": bool,
  "data_parallel": k, "int8": bool, ...}``
- ``GET /stats``   -> ``requests``, ``errors`` and ``latency_ms``
  (``p50``, ``p95``, ``max``: ``do_POST`` entry to the reply ready to send,
  counted before it is sent); ``spans``: ``count``, ``p50``, ``p95`` and
  ``max`` (ms) of ``otm.http.request`` (the same), ``otm.batcher.queue``
  (``submit`` to the request's group taken), ``otm.engine.call`` (one
  ``generate_batch``, warm-up left out) and ``otm.http.reply`` (images in
  hand to the body written); and ``batching`` (with the batcher):
  ``device_calls``, ``coalesced_requests``, ``hangs``,
  ``queue_depth_max`` (the deepest queue seen when a group was taken)
  and ``padded_rows`` (batch bucket minus group size, summed)
- ``POST /generate?n=8&seed=0&theta=1.0`` with a PNG/JPEG body ->
  ``application/zip`` of ``n`` PNG shoemarks (``shoemark_0000.png``...)
- ``POST /generate?...&format=npy`` -> one ``[n, H, W, C]`` uint8
  ``.npy`` payload
- ``POST /reload`` -> ``{"status": "ok", "step": N}``: re-reads the
  configured run's newest checkpoint (``<run>/models/<step>.tar``), so a
  server follows a training run; 400 for an engine that serves an
  artifact (immutable)

Spans (``utils.profiling.span``: a ``torch.profiler`` range while a
profiler runs, on its clock beside the kernels; otherwise a flag check):
the handler's ``otm.http.request``, ``.decode``, ``.wait`` and ``.reply``;
the dispatcher's ``otm.batcher.collect`` (the window), ``.launch`` (the
group taken to the watchdog thread started) and ``.deliver``; the
engine's ``otm.engine.call``, ``.prepare``, ``.draws``, ``.encode``,
``.styles``, ``.decode`` (a chunk), ``.readback`` and ``.gather``.

CLI:
    python -m one_to_many_gan_torch.serve config.toml [--artifact model.npz] \
        [--host 0.0.0.0] [--port 8000] [--buckets 8,32,64] [--device cpu] \
        [--data-parallel k] [--int8]

Without ``--artifact`` it serves the configured run's latest checkpoint
(its EMA generator when it has one: ``/healthz`` then says ``"ema":
true``), or, when the run has none, fresh weights from seed 0 with a
warning.
``--device`` defaults to ``cuda`` and raises without a GPU.
"""

from __future__ import annotations

import argparse
import io
import json
import threading
import time
import warnings
import zipfile
from concurrent.futures import ThreadPoolExecutor, wait
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from one_to_many_gan_torch.convert import from_jax_params
from one_to_many_gan_torch.core.inference import make_inference_fns
from one_to_many_gan_torch.core.state import Models
from one_to_many_gan_torch.data.datasets import _load_image
from one_to_many_gan_torch.data.pipeline import normalize_u8
from one_to_many_gan_torch.device import select_device
from one_to_many_gan_torch.export import load_inference_artifact
from one_to_many_gan_torch.migrate import checkpoint_manager, load_inference_weights
from one_to_many_gan_torch.utils.profiling import SpanStats, span


def _decode_image_bytes(data: bytes, image_size, channels: int) -> np.ndarray:
    """PNG/JPEG bytes -> [H, W, C] uint8 through the dataset loader's
    convert/resize contract (``data.datasets._load_image``)."""
    try:
        return _load_image(io.BytesIO(data), image_size, channels)
    except OSError as exc:  # undecodable body is a CLIENT error (400)
        msg = f"request body is not a decodable image: {exc}"
        raise ValueError(msg) from exc


def _encode_png(arr_u8: np.ndarray) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    img = arr_u8.squeeze(-1) if arr_u8.shape[-1] == 1 else arr_u8
    # compress_level=1: PNG encode dominates the zip route's host time;
    # level 1 halves it for a modest size increase over PIL's default 6
    Image.fromarray(img).save(buf, format="PNG", compress_level=1)
    return buf.getvalue()


class InferenceEngine:
    """1->N sampler on one device with N buckets and batch buckets.

    Args:
        config: full framework config (``load_config`` / ``tiny_config``).
        buckets: ascending N values; a request's ``n`` rounds up to the
            first bucket >= n (hard cap = max bucket).
        artifact: path to an inference artifact (``export.py``, or the
            JAX package's), loaded through ``convert.from_jax_params``.
            Without it the engine serves the configured run's latest
            checkpoint, and ``reload()`` follows the run; with none,
            fresh weights from ``seed``, with a warning.
        batch_buckets: ascending source-batch sizes for the coalesced
            path; a request group rounds up to the first bucket >= its
            size (padded rows are zeros and discarded).
        device: ``"cuda"`` (the default; raises without a GPU) or
            ``"cpu"``.
        data_parallel: replicas that split each decode's style batch
            (-1: every visible card; the CPU has one unless asked for
            more). Every n bucket must divide by it; more replicas than
            cards raise.
        int8: decode with the modulated convs on int8 codes (module
            docstring); inference only, the same weights.
    """

    def __init__(
        self,
        config,
        buckets=(8, 32, 64),
        *,
        artifact=None,
        batch_buckets=(1, 2, 4),
        device=None,
        seed: int = 0,
        data_parallel: int = 1,
        int8: bool = False,
    ):
        if not buckets or list(buckets) != sorted(set(buckets)):
            msg = f"buckets must be ascending and unique, got {buckets!r}"
            raise ValueError(msg)
        if not batch_buckets or list(batch_buckets) != sorted(set(batch_buckets)):
            msg = f"batch_buckets must be ascending and unique, got {batch_buckets!r}"
            raise ValueError(msg)
        self.buckets = tuple(int(b) for b in buckets)
        self.batch_buckets = tuple(int(b) for b in batch_buckets)
        self.step, self.ema = 0, False
        dev = select_device(device)
        self.data_parallel = self._resolve_data_parallel(int(data_parallel), dev)
        if dev.type == "cuda" and self.data_parallel > 1:
            devices = [torch.device("cuda", i) for i in range(self.data_parallel)]
        else:
            devices = [dev] * self.data_parallel
        self.int8 = bool(int8)
        self.replicas = [Models(config, device=d, seed=seed, int8_decode=self.int8)
                         for d in devices]
        models = self.models = self.replicas[0]
        # one request on the device at a time; the HTTP layer is threaded
        self._lock = threading.Lock()
        # one /reload at a time (the threaded server allows concurrent ones)
        self._reload_lock = threading.Lock()
        self._mgr = None
        if artifact is not None:
            params_g, params_m, self.step, self.ema = load_inference_artifact(artifact)
            for replica in self.replicas:
                from_jax_params(replica, params_g, params_m)
        else:
            self._mgr = checkpoint_manager(config)
            if self.reload() == 0:
                warnings.warn(
                    f"no inference artifact given and no checkpoint of run "
                    f"{config['training']['training_run']!r}; serving fresh weights "
                    f"from seed {seed}",
                    stacklevel=2,
                )
        self.device = models.device
        self.precision = config["tpu"]["precision"]
        self.image_size = tuple(config["data"]["image_size"])
        self.channels = config["data"]["image_channels"]
        self._fns = [make_inference_fns(replica)[2] for replica in self.replicas]
        self._pool = ThreadPoolExecutor(max(1, self.data_parallel - 1),
                                        thread_name_prefix="replica")
        self.device_calls = 0
        self.stats = SpanStats()  # otm.engine.call, for the server's /stats

    def _resolve_data_parallel(self, k: int, dev: torch.device) -> int:
        """-1 -> every visible card (one on the CPU); checks that the
        replicas exist and that every n bucket divides by them."""
        n_cards = torch.cuda.device_count() if dev.type == "cuda" else None
        if k == -1:
            k = n_cards or 1
        if k < 1:
            msg = f"data_parallel must be -1 or >= 1, got {k}"
            raise ValueError(msg)
        if n_cards is not None and k > n_cards:
            msg = f"data_parallel={k} needs {k} cards, have {n_cards}"
            raise ValueError(msg)
        bad = [b for b in self.buckets if b % k]
        if bad:
            msg = f"data_parallel={k} must divide every n bucket; offending buckets: {bad}"
            raise ValueError(msg)
        return k

    def reload(self) -> int:
        """Load the configured run's newest checkpoint when it is newer
        than the served step (the generator, its EMA weights when the
        checkpoint has them, and the mapping network, swapped between
        requests); -> the served step. ``ValueError`` for an engine that
        serves an artifact."""
        if self._mgr is None:
            msg = "reload unavailable: engine is backed by an immutable artifact"
            raise ValueError(msg)
        with self._reload_lock:
            latest = self._mgr.latest_step()
            if latest is not None and latest != self.step:
                ckpt = self._mgr.load(latest)
                with self._lock:
                    for replica in self.replicas:
                        self.ema = load_inference_weights(ckpt, replica)
                    self.step = latest
            return self.step

    def bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        msg = f"n={n} exceeds the largest compiled bucket {self.buckets[-1]}"
        raise ValueError(msg)

    def batch_bucket_for(self, b: int) -> int:
        for bb in self.batch_buckets:
            if b <= bb:
                return bb
        msg = f"batch {b} exceeds the largest batch bucket {self.batch_buckets[-1]}"
        raise ValueError(msg)

    def warmup(self, *, batched: bool = True, max_batch: int | None = None) -> float:
        """Run every serving shape once (zeros input); returns seconds.

        Every n bucket at batch bucket 1 and, when ``batched``, at every
        batch bucket up to ``max_batch`` (no cap when None): builds the
        CUDA kernel and sets up cuDNN and the allocator before the first
        request.
        """
        t0 = time.perf_counter()
        zero = np.zeros((*self.image_size, self.channels), np.uint8)
        cap = float("inf") if max_batch is None else max(1, int(max_batch))
        for b in self.buckets:
            self.generate(zero, b, seed=0, theta=1.0)
            if not batched:
                continue
            for bb in self.batch_buckets:
                if bb == 1 or bb > cap:
                    continue
                self.generate_batch([zero] * bb, [b] * bb, [0] * bb, [1.0] * bb)
        self.stats = SpanStats()  # /stats times served calls, not these
        return time.perf_counter() - t0

    def generate(
        self, image_u8: np.ndarray, n: int, seed: int = 0, theta: float = 1.0
    ) -> np.ndarray:
        """[H,W,C] uint8 source -> [n,H,W,C] uint8 shoemarks (one device call)."""
        return self.generate_batch([image_u8], [n], [seed], [theta])[0]

    def _draws(self, seeds: np.ndarray, n: int) -> torch.Tensor:
        """[len(seeds), n, w_dim] normals, row i from its own generator."""
        w_dim = self.models.w_dim
        rows = []
        for seed in seeds:
            gen = torch.Generator(self.device).manual_seed(int(seed))
            rows.append(torch.randn((n, w_dim), generator=gen, device=self.device))
        return torch.stack(rows)

    def generate_batch(self, images_u8, ns, seeds, thetas) -> list[np.ndarray]:
        """B sources -> B outputs, ONE device call (the coalesced path).

        ``images_u8`` is a list of [H,W,C] uint8 arrays; ``ns``/``seeds``/
        ``thetas`` are per-request. The group runs at the max n bucket of
        the group and the batch rounds up to a batch bucket (padded rows
        are zeros and discarded). Request i's output depends only on its
        own (image, seed, theta) and the n bucket.
        """
        with span("otm.engine.call", self.stats):
            return self._generate_batch(images_u8, ns, seeds, thetas)

    def _generate_batch(self, images_u8, ns, seeds, thetas) -> list[np.ndarray]:
        with span("otm.engine.prepare"):
            b = len(images_u8)
            n_bucket = max(self.bucket_for(n) for n in ns)
            bb = self.batch_bucket_for(b)
            src = np.zeros((bb, *self.image_size, self.channels), np.uint8)
            for i, im in enumerate(images_u8):
                src[i] = im
            # two's-complement wrap: negative / >= 2^32 seeds keep working, and
            # a bad seed never fails the other requests coalesced into the group
            seed_arr = np.zeros((bb,), np.int64)
            seed_arr[:b] = [int(s) & 0xFFFFFFFF for s in seeds]
            theta_arr = np.zeros((bb,), np.float32)
            theta_arr[:b] = np.asarray(thetas, np.float32)
            imgs = torch.from_numpy(normalize_u8(src))
            thetas_t = torch.from_numpy(theta_arr)
        with self._lock:
            with span("otm.engine.draws"):
                z = self._draws(seed_arr, n_bucket)
                # the draws reach every card before any decode is queued (a
                # copy queued after a card's decode would wait for it)
                zs = [z.to(replica.device) for replica in self.replicas]
            m = bb * n_bucket // self.data_parallel

            def part(i: int) -> np.ndarray:
                """Replica i's rows, decoded and read back."""
                rows = slice(i * m, (i + 1) * m)
                images = self._fns[i](imgs, zs[i], thetas_t, rows=rows)
                with span("otm.engine.readback"):
                    return _to_u8(images).cpu().numpy()

            # replicas 1.. from threads of their own, the first from this
            # one, so that the cards' launches are queued at once
            others = [self._pool.submit(part, i) for i in range(1, self.data_parallel)]
            try:
                first = part(0)
            finally:
                wait(others)  # none outlives the lock
            with span("otm.engine.gather"):
                flat = np.concatenate([first] + [f.result() for f in others])
                u8 = flat.reshape(bb, n_bucket, *flat.shape[1:])
                outs = [u8[i, : ns[i]] for i in range(b)]
            self.device_calls += 1
        return outs


def _to_u8(images: torch.Tensor) -> torch.Tensor:
    """[-1, 1] images -> uint8, on their device."""
    return ((images.float() + 1.0) * 127.5).clamp(0, 255).to(torch.uint8)


class RequestTimeoutError(RuntimeError):
    """A queued request exceeded its end-to-end deadline (HTTP 503)."""


class DeviceHangError(RuntimeError):
    """A device call exceeded the watchdog deadline (HTTP 503)."""


def _call_with_watchdog(fn, timeout_s: float, label: str):
    """Run ``fn()`` under a deadline; raise ``DeviceHangError`` on expiry.

    ``timeout_s <= 0`` disables the watchdog (direct call). Otherwise the
    call runs in a one-shot daemon worker thread and the caller joins with
    a timeout: a wedged device call cannot be cancelled, so on expiry the
    worker is ABANDONED (one leaked daemon thread per hang, counted in
    /stats) while the caller fails the request with 503 and serves the
    next one.
    """
    if timeout_s <= 0:
        return fn()
    return _await_call(*_start_call(fn, label), timeout_s, label)


def _start_call(fn, label: str) -> tuple[dict, threading.Event]:
    """Start ``fn()`` in a one-shot daemon worker thread; -> (box, done):
    ``done`` is set once ``box`` holds its ``result`` or ``error``."""
    box: dict = {}
    done = threading.Event()

    def worker():
        try:
            box["result"] = fn()
        except Exception as exc:  # noqa: BLE001 — relayed to the caller
            box["error"] = exc
        finally:
            done.set()

    threading.Thread(target=worker, name=f"otm-watchdog-{label}", daemon=True).start()
    return box, done


def _await_call(box: dict, done: threading.Event, timeout_s: float, label: str):
    """Wait up to ``timeout_s`` for a ``_start_call``; its result, or raise
    its error or ``DeviceHangError``."""
    if not done.wait(timeout_s):
        msg = (
            f"device call '{label}' exceeded the {timeout_s:.0f}s watchdog "
            "deadline (backend hang?); the call was abandoned"
        )
        raise DeviceHangError(msg)
    if "error" in box:
        raise box["error"]
    return box["result"]


class _Batcher:
    """Coalesce concurrent ``generate`` calls into one device call.

    Request threads enqueue and block; one dispatcher thread drains the
    queue, waits ``window_ms`` for a burst to land (skipped when a full
    batch is already waiting), groups requests that share an n bucket (so
    coalescing never changes a request's style draws), and runs the group
    as ONE ``generate_batch`` call. ``max_batch=1`` disables coalescing.

    ``device_timeout_s`` bounds each device call with a watchdog so a
    wedged device fails the GROUP with ``DeviceHangError`` (503) while the
    dispatcher survives; ``request_timeout_s`` bounds each client's total
    wait in ``submit``. Either knob <= 0 disables that bound.

    Counters: ``batches`` (device calls), ``coalesced`` (requests beyond
    the first of each), ``hangs``, ``queue_depth_max`` (the deepest queue
    seen when a group was taken) and ``padded_rows`` (batch bucket minus
    group size, summed); each request's wait from ``submit`` to its group
    being taken goes to ``stats`` as ``otm.batcher.queue``.
    """

    def __init__(self, engine: InferenceEngine, max_batch: int = 4,
                 window_ms: float = 3.0, device_timeout_s: float = 60.0,
                 request_timeout_s: float = 120.0, stats: SpanStats | None = None):
        self.engine = engine
        self.stats = SpanStats() if stats is None else stats
        if int(max_batch) > engine.batch_buckets[-1]:
            warnings.warn(
                f"max_batch={max_batch} exceeds the largest compiled batch "
                f"bucket {engine.batch_buckets[-1]}; coalescing is capped "
                f"there (grow InferenceEngine(batch_buckets=...) to raise it)",
                stacklevel=2,
            )
        self.max_batch = max(1, min(int(max_batch), engine.batch_buckets[-1]))
        self.window_s = max(0.0, float(window_ms)) / 1e3
        self.device_timeout_s = float(device_timeout_s)
        self.request_timeout_s = float(request_timeout_s)
        self.hangs = 0  # abandoned device calls (watchdog expiries)
        self._cv = threading.Condition()
        self._queue: list[tuple] = []  # (n_bucket, src, n, seed, theta, box)
        self._shutdown = False
        self.batches = 0
        self.coalesced = 0
        self.queue_depth_max = 0
        self.padded_rows = 0
        self._thread = threading.Thread(
            target=self._loop, name="otm-batcher", daemon=True
        )
        self._thread.start()

    def submit(self, src: np.ndarray, n: int, seed: int, theta: float):
        """Enqueue one request and block until its result (or raise)."""
        entered = time.perf_counter()
        bucket = self.engine.bucket_for(n)  # invalid n fails fast, unqueued
        box: dict = {"event": threading.Event(), "entered": entered}
        with self._cv:
            if self._shutdown:
                msg = "server is shutting down"
                raise RuntimeError(msg)
            self._queue.append((bucket, src, n, seed, theta, box))
            self._cv.notify_all()
        timeout = self.request_timeout_s if self.request_timeout_s > 0 else None
        if not box["event"].wait(timeout):
            # the dispatcher sets the abandoned box eventually (harmless);
            # THIS client gets a 503 now instead of blocking forever
            msg = (
                f"request timed out after {self.request_timeout_s:.0f}s "
                "waiting for the device (queue backlog or backend hang)"
            )
            raise RequestTimeoutError(msg)
        if "error" in box:
            raise box["error"]
        return box["result"]

    def _take_group(self) -> list[tuple]:
        """Pop up to max_batch queued requests sharing the head's n bucket."""
        head_bucket = self._queue[0][0]
        group, rest = [], []
        for item in self._queue:
            if item[0] == head_bucket and len(group) < self.max_batch:
                group.append(item)
            else:
                rest.append(item)
        self._queue = rest
        return group

    def _loop(self) -> None:
        while True:
            with self._cv:
                while not self._queue and not self._shutdown:
                    self._cv.wait()
                if self._shutdown:
                    for *_, box in self._queue:
                        box["error"] = RuntimeError("server is shutting down")
                        box["event"].set()
                    self._queue = []
                    return
                with span("otm.batcher.collect"):
                    # each enqueue notifies, so wait() can return after part
                    # of a burst: keep waiting until the batch is full or the
                    # window expires
                    deadline = time.monotonic() + self.window_s
                    while (
                        len(self._queue) < self.max_batch
                        and not self._shutdown
                        and (remaining := deadline - time.monotonic()) > 0
                    ):
                        self._cv.wait(remaining)
                    depth = len(self._queue)
                    group = self._take_group()
            taken = time.perf_counter()
            with span("otm.batcher.launch"):
                for *_, box in group:
                    self.stats.record("otm.batcher.queue", (taken - box["entered"]) * 1e3)
                self.queue_depth_max = max(self.queue_depth_max, depth)
                self.padded_rows += self.engine.batch_bucket_for(len(group)) - len(group)
                # bind the arg lists NOW: an abandoned watchdog worker must
                # not read `group` after the loop rebinds it for the next group
                srcs, ns, seeds, thetas = (
                    [g[1] for g in group],
                    [g[2] for g in group],
                    [g[3] for g in group],
                    [g[4] for g in group],
                )

                def call(srcs=srcs, ns=ns, seeds=seeds, thetas=thetas):
                    return self.engine.generate_batch(srcs, ns, seeds, thetas)

                started = (_start_call(call, "generate_batch")
                           if self.device_timeout_s > 0 else None)
            try:
                outs = (call() if started is None
                        else _await_call(*started, self.device_timeout_s, "generate_batch"))
            except Exception as exc:  # noqa: BLE001 — fail the group, not the loop
                with span("otm.batcher.deliver"):
                    if isinstance(exc, DeviceHangError):
                        self.hangs += 1
                    for *_, box in group:
                        box["error"] = exc
                        box["event"].set()
                continue
            with span("otm.batcher.deliver"):
                self.batches += 1
                self.coalesced += len(group) - 1
                for (*_, box), out in zip(group, outs):
                    box["result"] = out
                    box["event"].set()

    def close(self) -> None:
        with self._cv:
            self._shutdown = True
            self._cv.notify_all()
        self._thread.join(timeout=5)

    def snapshot(self) -> dict:
        return {
            "device_calls": self.batches,
            "coalesced_requests": self.coalesced,
            "hangs": self.hangs,
            "queue_depth_max": self.queue_depth_max,
            "padded_rows": self.padded_rows,
        }


def _stats_payload(stats: SpanStats, engine: InferenceEngine,
                  batcher: _Batcher | None = None) -> dict:
    """``GET /stats``: requests, errors and ``latency_ms`` from the
    ``otm.http.request`` span, ``spans`` (the server's and the engine's),
    and the batcher's counters as ``batching``."""
    spans = {**stats.snapshot(), **engine.stats.snapshot()}
    out = {"requests": 0, "errors": stats.errors}
    request = spans.get("otm.http.request")
    if request is not None:
        out["requests"] = request["count"]
        out["latency_ms"] = {k: request[k] for k in ("p50", "p95", "max")}
    out["spans"] = spans
    if batcher is not None:
        out["batching"] = batcher.snapshot()
    return out


def make_handler(engine: InferenceEngine, stats: SpanStats,
                 batcher: _Batcher | None = None,
                 device_timeout_s: float = 60.0):
    """Build the request-handler class bound to one engine instance."""

    def run_generate(src, n, seed, theta):
        if batcher is not None:
            return batcher.submit(src, n, seed, theta)
        # unbatched path: the handler thread calls the device directly,
        # bounded by the same watchdog
        return _call_with_watchdog(
            lambda: engine.generate(src, n, seed=seed, theta=theta),
            device_timeout_s,
            "generate",
        )

    class Handler(BaseHTTPRequestHandler):
        # quiet the default per-request stderr lines
        def log_message(self, fmt, *args):  # noqa: ARG002
            pass

        def _json(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):  # noqa: N802
            path = urlparse(self.path).path
            if path == "/healthz":
                self._json(
                    200,
                    {
                        "status": "ok",
                        "step": engine.step,
                        "ema": engine.ema,
                        "buckets": list(engine.buckets),
                        "image_size": list(engine.image_size),
                        "device": str(engine.device),
                        "precision": engine.precision,
                        "data_parallel": engine.data_parallel,
                        "int8": engine.int8,
                    },
                )
            elif path == "/stats":
                self._json(200, _stats_payload(stats, engine, batcher))
            else:
                self._json(404, {"error": f"unknown path {path}"})

        def do_POST(self):  # noqa: N802
            url = urlparse(self.path)
            if url.path == "/reload":
                try:
                    step = engine.reload()
                except ValueError as exc:
                    stats.error()
                    self._json(400, {"error": str(exc)})
                    return
                self._json(200, {"status": "ok", "step": step})
                return
            if url.path != "/generate":
                self._json(404, {"error": f"unknown path {url.path}"})
                return
            with span("otm.http.request"):
                self._generate(url)

        def _generate(self, url):
            t0 = time.perf_counter()
            try:
                q = parse_qs(url.query)
                n = int(q.get("n", ["8"])[0])
                seed = int(q.get("seed", ["0"])[0])
                theta = float(q.get("theta", ["1.0"])[0])
                fmt = q.get("format", ["zip"])[0]
                if n < 1:
                    raise ValueError(f"n must be >= 1, got {n}")
                length = int(self.headers.get("Content-Length", "0"))
                if length <= 0:
                    raise ValueError("request body (source image) required")
                if length > 64 * 1024 * 1024:
                    raise ValueError("request body exceeds 64MB limit")
                with span("otm.http.decode"):
                    src = _decode_image_bytes(
                        self.rfile.read(length), engine.image_size, engine.channels
                    )
                with span("otm.http.wait"):
                    outs = run_generate(src, n, seed, theta)
            except ValueError as exc:
                stats.error()
                self._json(400, {"error": str(exc)})
                return
            except (RequestTimeoutError, DeviceHangError) as exc:
                # overload/hang: the canonical retry-later status
                stats.error()
                self._json(503, {"error": f"{type(exc).__name__}: {exc}"})
                return
            except Exception as exc:  # noqa: BLE001 — surface, don't kill server
                stats.error()
                self._json(500, {"error": f"{type(exc).__name__}: {exc}"})
                return

            with span("otm.http.reply", stats):
                if fmt == "npy":
                    buf = io.BytesIO()
                    np.save(buf, outs)
                    body, ctype = buf.getvalue(), "application/octet-stream"
                else:
                    buf = io.BytesIO()
                    with zipfile.ZipFile(buf, "w", zipfile.ZIP_STORED) as zf:
                        for i, arr in enumerate(outs):
                            zf.writestr(f"shoemark_{i:04d}.png", _encode_png(arr))
                    body, ctype = buf.getvalue(), "application/zip"
                # counted before the reply is sent, so a client that has its
                # reply always finds the request in /stats
                stats.record("otm.http.request", (time.perf_counter() - t0) * 1e3)
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

    return Handler


def make_server(
    engine: InferenceEngine,
    host="0.0.0.0",
    port=8000,
    max_batch: int = 4,
    window_ms: float = 3.0,
    device_timeout_s: float = 60.0,
    request_timeout_s: float = 120.0,
) -> ThreadingHTTPServer:
    """Threaded HTTP server with dynamic request batching.

    ``max_batch`` 0 or 1 disables batching (handlers call the engine
    directly). The batcher is exposed as ``server.batcher``; close it when
    tearing the server down.
    """
    stats = SpanStats()
    batcher = (
        _Batcher(engine, max_batch, window_ms,
                 device_timeout_s=device_timeout_s,
                 request_timeout_s=request_timeout_s, stats=stats)
        if max_batch > 1
        else None
    )
    server = ThreadingHTTPServer(
        (host, port),
        make_handler(engine, stats, batcher, device_timeout_s=device_timeout_s),
    )
    server.batcher = batcher
    return server


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("config")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--buckets", default="8,32,64")
    ap.add_argument(
        "--artifact",
        default=None,
        help="serve an exported inference artifact (npz, this package's or the "
        "JAX package's); without it, the run's latest checkpoint (/reload "
        "follows the run), or fresh weights from seed 0 when it has none",
    )
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument(
        "--data-parallel",
        type=int,
        default=1,
        help="split each decode over this many cards, one generator replica "
        "each (-1: every visible card); every n bucket must divide by it. "
        "Each replica encodes the sources again, so a small n can take longer "
        "than on one card",
    )
    ap.add_argument(
        "--int8",
        action="store_true",
        help="run the decoder's modulated convs on int8 codes (the int8 conv "
        "kernel on the card's tensor cores); the same weights. One n=64 request of "
        "configs/default.toml on an H100 at 700 W: float32 269 ms against 359 ms "
        "without (1.33x); bfloat16 203 ms against 129 ms (0.64x, slower; PERF.md)",
    )
    ap.add_argument(
        "--max-batch",
        type=int,
        default=4,
        help="coalesce up to this many concurrent /generate requests into "
        "one device call (1 disables dynamic batching)",
    )
    ap.add_argument(
        "--batch-window-ms",
        type=float,
        default=3.0,
        help="how long the dispatcher waits for a burst to land before "
        "running a partial batch",
    )
    ap.add_argument(
        "--device-timeout",
        type=float,
        default=60.0,
        help="watchdog deadline (s) on each device call (0 disables)",
    )
    ap.add_argument(
        "--request-timeout",
        type=float,
        default=120.0,
        help="end-to-end deadline (s) a queued /generate request may wait "
        "before it gets 503 (0 disables)",
    )
    args = ap.parse_args(argv)

    from one_to_many_gan_torch.config import load_config

    config = load_config(args.config)
    engine = InferenceEngine(
        config,
        buckets=[int(b) for b in args.buckets.split(",")],
        artifact=args.artifact,
        device=args.device,
        data_parallel=args.data_parallel,
        int8=args.int8,
    )
    print(
        f"serving step {engine.step} ({'EMA' if engine.ema else 'raw'} generator"
        f"{', int8 decode' if engine.int8 else ''}) "
        f"on {engine.device} x {engine.data_parallel}; warming {len(engine.buckets)} buckets..."
    )
    warm_s = engine.warmup(batched=args.max_batch > 1, max_batch=args.max_batch)
    print(f"warm in {warm_s:.1f}s; serving on {args.host}:{args.port}")
    make_server(
        engine,
        args.host,
        args.port,
        max_batch=args.max_batch,
        window_ms=args.batch_window_ms,
        device_timeout_s=args.device_timeout,
        request_timeout_s=args.request_timeout,
    ).serve_forever()


if __name__ == "__main__":
    main()
