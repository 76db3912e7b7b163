"""Closed-loop HTTP clients, run as a child process of a serving run.

    python -m benchmark.clients <spec.json>

Each of ``clients`` threads sends ``POST /generate`` and sends its next
request only when the last reply has been read to its last byte. The
process prints ``ready``, reads the window's start (a ``time.monotonic``
reading, which the parent shares on Linux) from standard input, sends
from then until the window's end, and waits for the replies in flight.
It writes one record per request and keeps the replies of a sample:
the ``sample`` requests, finished inside the window, whose priority
(a hash of the run's seed, the client and the request's index) is
lowest, so that the sample is drawn from the seed and holds at most
``sample`` replies in memory. Imports no torch.
"""

from __future__ import annotations

import hashlib
import heapq
import http.client
import io
import json
import sys
import threading
import time
from pathlib import Path

import numpy as np


def request_params(seed: int, client: int, k: int, n_sources: int, thetas: list) -> dict:
    """The k-th request of ``client``: its seed, source and theta, and its
    sampling priority, all from the run's seed."""
    digest = hashlib.sha256(f"{seed}/{client}/{k}".encode()).digest()
    word = [int.from_bytes(digest[i : i + 8], "little") for i in range(0, 32, 8)]
    return {
        "client": client, "k": k, "seed": word[0] & 0xFFFFFFFF,
        "source": word[1] % n_sources, "theta": thetas[word[2] % len(thetas)],
        "priority": word[3],
    }


def _check_reply(body: bytes, shape: list) -> np.ndarray:
    arr = np.load(io.BytesIO(body), allow_pickle=False)
    if arr.dtype != np.uint8 or list(arr.shape) != shape:
        msg = f"reply of shape {arr.shape} {arr.dtype}, expected {shape} uint8"
        raise ValueError(msg)
    return arr


def main(spec_path: str) -> None:
    spec = json.loads(Path(spec_path).read_text())
    out_dir = Path(spec["out_dir"])
    bodies = [Path(p).read_bytes() for p in spec["sources"]]
    n, port, seconds = spec["n"], spec["port"], spec["seconds"]
    shape = [n, *spec["image_shape"]]
    records: list[dict] = []
    kept: list[tuple[int, int, dict, np.ndarray]] = []  # max-heap by -priority
    lock = threading.Lock()
    print("ready", flush=True)
    t0 = float(sys.stdin.readline())
    t_end = t0 + seconds
    time.sleep(max(0.0, t0 - time.monotonic()))

    def client(c: int) -> None:
        k = 0
        while time.monotonic() < t_end:
            req = request_params(spec["seed"], c, k, len(bodies), spec["thetas"])
            path = f"/generate?n={n}&theta={req['theta']}&seed={req['seed']}&format=npy"
            t_send = time.monotonic()
            status, error, arr = 0, "", None
            try:
                conn = http.client.HTTPConnection("127.0.0.1", port, timeout=spec["timeout_s"])
                try:
                    conn.request("POST", path, body=bodies[req["source"]],
                                 headers={"Content-Type": "image/png"})
                    resp = conn.getresponse()
                    body = resp.read()
                    status = resp.status
                finally:
                    conn.close()
                t_done = time.monotonic()
                if status == 200:
                    arr = _check_reply(body, shape)
                else:
                    error = body[:200].decode(errors="replace")
            except (OSError, ValueError, http.client.HTTPException) as exc:
                t_done = time.monotonic()
                error = f"{type(exc).__name__}: {exc}"
            rec = {**req, "t_send": t_send, "t_done": t_done, "status": status,
                   "ok": arr is not None, "error": error}
            with lock:
                records.append(rec)
                if arr is not None and t_done <= t_end:
                    item = (-req["priority"], c * 1_000_000 + k, rec, arr)
                    if len(kept) < spec["sample"]:
                        heapq.heappush(kept, item)
                    elif item > kept[0]:
                        heapq.heapreplace(kept, item)
            k += 1

    threads = [threading.Thread(target=client, args=(c,)) for c in range(spec["clients"])]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    sample = []
    for i, (_, _, rec, arr) in enumerate(sorted(kept, key=lambda x: x[1])):
        path = out_dir / f"reply_{i}.npy"
        np.save(path, arr)
        sample.append({**rec, "path": str(path)})
    (out_dir / "requests.json").write_text(json.dumps({"records": records, "sample": sample}))
    print("done", flush=True)


if __name__ == "__main__":
    main(sys.argv[1])
