"""Run one cell of the benchmark once and print its result line.

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the repository's root, on a host with the cards the cell asks for.
The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (with ``--trace 0`` the cell's
end-to-end metrics, with ``--trace 1`` its per-layer ones), ``device``,
with ``--trace 1`` ``breakdown``, and last ``checks``: each number the
comparison with the reference decided ``correct`` by, beside its limit.
The same numbers are the last lines of standard error. Without CUDA, with
fewer cards than the cell asks for, or with JAX loaded once the window
has closed, it prints no result and exits with a code other than 0.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()  # set-up is timed from here, before any import

import argparse  # noqa: E402
import json  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402


def log(msg: str) -> None:
    print(f"[benchmark] {msg}", file=sys.stderr, flush=True)


def _power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20, check=False)
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"nvidia-smi failed: {exc}"
    return out.stdout.strip().replace("\n", "; ")


def run_cell(cell: dict, *, seed: int, seconds: int, trace: bool, device,
             t_start: float, **options) -> dict:
    """One run of ``cell`` on ``device`` by its traffic's driver; ->
    the driver's result (``correct``, ``attempted``, ``failed``,
    ``checks``, ``end_to_end``, ``memory_peak_bytes``, and with ``trace``
    ``run`` for the per-layer readers and ``breakdown``). ``options``
    reach the driver (controls and faults)."""
    from benchmark import harness

    run_dir = Path(tempfile.mkdtemp(prefix="otm-bench-"))
    try:
        ctx = SimpleNamespace(cell=cell, seed=seed, seconds=seconds, trace=trace,
                              device=device, run_dir=run_dir, t_start=t_start, log=log,
                              **options)
        return harness.driver(cell["traffic_file"]["driver"]).run(ctx)
    finally:
        shutil.rmtree(run_dir, ignore_errors=True)


def result_line(cell: dict, result: dict, trace: bool, device_info: dict) -> dict:
    """The contract's JSON object for ``result``."""
    from benchmark import harness

    metrics = {}
    if trace:
        for m in cell["per_layer"]:
            value = harness.read_metric(m["name"], result["run"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in cell["end_to_end"]:
            metrics[m["name"]] = {"value": result["end_to_end"][m["name"]], "unit": m["unit"]}
    line = {"correct": bool(result["correct"]), "attempted": result["attempted"],
            "failed": result["failed"], "metrics": metrics, "device": device_info}
    if trace and "breakdown" in result:
        line["breakdown"] = result["breakdown"]
    line["checks"] = result["checks"]
    return line


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=int, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from benchmark import harness

    cell = harness.cell(args.workload)
    import torch

    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < cell["chips"]:
        log(f"{args.workload} needs {cell['chips']} CUDA card(s); this host has {found}")
        return 2
    result = run_cell(cell, seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
                      device=torch.device("cuda"), t_start=T_START)
    device_info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                   "count": cell["chips"], "memory_peak_bytes": result["memory_peak_bytes"]}
    if args.trace:
        tr = result["run"].trace
        if tr is None or tr.busy_s() <= 0:
            log("the traced slice holds no device operation")
            return 3
        device_info |= {"busy_s": tr.busy_s(), "window_s": tr.window_s}
    line = result_line(cell, result, bool(args.trace), device_info)
    log(f"card: {_power_limit()}")
    bad = harness.forbidden_modules()
    if bad:
        log(f"the process has loaded {bad}: the benchmark runs without JAX")
        return 4
    for name, check in line["checks"].items():
        log(f"check {name}: {check['value']!r} (limit {check['limit']!r})")
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
