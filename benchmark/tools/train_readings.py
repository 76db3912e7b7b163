"""The readings that a training cell's limits are set from, on the cards.

    python3 -m benchmark.tools.train_readings --workload otm_prod512.train_dp4 \\
        --seeds 1,2,3 --modes program,exchange,half,r1,path,p0 --out file.jsonl

One launch of the cell's ranks: for each mode and seed in turn, every
rank builds the Trainer on the seed's data and weights (with the mode's
fault planted under its step) and trains the cell's ``check_steps``
through the same wrapper as a benchmark run, without a window (the
readings need none). Then each rank takes a share of the seeds and, on
its own card, holds every mode of each to the plain reference, and
appends a line per (mode, seed) pair: every number the comparison
computes, each limit's check, and for ``program`` on the first
``--control-seeds`` seeds also ``control`` (the reference in float8, the
control, against the float32 reference on the same steps). The modes of
one seed share a reference run where they fed it the same rows and
draws, value for value. The faults run on the first ``--fault-seeds``
seeds. ``--modes``:

- ``program``: the program as the benchmark runs it (the lower reading),
  and the control on the first seeds;
- ``exchange``: the exchange left out (every rank keeps its own
  gradients);
- ``half``: each rank's second half of rows replaced by its first;
- ``r1``: the R1 term dropped; ``path``: the path term made 0 (its
  gradient with it); ``p0``: ADA at p = 0 where the state says
  ``ada_p``; ``unchanged``: the step's state restored after it; ``feed``:
  the fed images altered where the Trainer makes them (clipped to
  [-0.99, 0.99]).
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import tempfile
import time
from pathlib import Path

import torch

from benchmark import harness
from benchmark.drivers import train_data_parallel as drv
from benchmark.run import log


def rank_main(group, spec: dict) -> None:
    """Every (mode, seed) pair's program records, then this rank's share
    of the seeds' references."""
    run_dir = Path(spec["run_dir"])
    device = group.device
    for mode, seed in spec["items"]:
        item = {**spec, "seed": seed, "fault": None if mode == "program" else mode,
                "config_path": spec["config_paths"][seed]}
        trainer, step = drv.build(group, item)
        drv._no_pause_save()
        trainer.run(max_steps=spec["check_steps"])
        out = {"rank": group.rank, "rows": step.rows, "r1": step.r1,
               "ranks_max_abs_diff": drv.ranks_max_abs_diff(trainer)}
        if trainer.main:
            out |= {"draws": step.draws, "losses": step.losses, "grads": step.grads,
                    "changes": step.changes}
        step.undo()
        del trainer, step
        _free(device)
        torch.save(out, run_dir / f"{mode}.{seed}.rank{group.rank}.pt")
        group.barrier()
    seeds = list(dict.fromkeys(seed for _, seed in spec["items"]))
    for seed in seeds[group.rank::group.world]:
        cache = {}
        for mode in [m for m, s in spec["items"] if s == seed]:
            _row(spec, group.world, mode, seed, device, cache)
        del cache
        _free(device)


def _free(device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def _row(spec: dict, world: int, mode: str, seed: int, device, cache: dict) -> None:
    """One (mode, seed) pair's records against the reference (``cache``:
    the seed's reference runs); appends its line to ``spec["out"]``."""
    from one_to_many_gan_torch.config import load_config

    t = time.perf_counter()
    run_dir = Path(spec["run_dir"])
    ranks = [torch.load(run_dir / f"{mode}.{seed}.rank{r}.pt", weights_only=False)
             for r in range(world)]
    control = mode == "program" and seed in spec["control_seeds"]
    precisions = ("float32", "fp8") if control else ("float32",)
    config = load_config(spec["config_paths"][seed])
    values = drv.judge(config, spec["traffic"], seed, ranks, device, precisions, cache)
    checks = drv.check(values, spec["limits"])
    row = {"mode": mode, "seed": seed,
           "correct": all(c["value"] <= c["limit"] for c in checks.values()),
           "checks": checks, "readings": values, "reference_s": time.perf_counter() - t}
    if "control" in values:
        row["control_checks"] = drv.check(values["control"] | {
            "ranks_max_abs_diff": 0.0, "feed_rows_unmatched": 0}, spec["limits"])
    with open(spec["out"], "a") as f:
        f.write(json.dumps(row) + "\n")


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--modes", default="program")
    ap.add_argument("--control-seeds", type=int, default=3,
                    help="the control with the program on the first this many seeds")
    ap.add_argument("--fault-seeds", type=int, default=None,
                    help="the faults on the first this many seeds (default: all)")
    ap.add_argument("--out", required=True, help="a JSON-lines file the rows are appended to")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        log("no CUDA card")
        return 2
    cell = harness.cell(args.workload)
    seeds = [int(s) for s in args.seeds.split(",")]
    items = [(m, s) for m in args.modes.split(",")
             for s in (seeds if m == "program" else seeds[: args.fault_seeds])]
    out = Path(args.out).resolve()
    with tempfile.TemporaryDirectory(prefix="otm-readings-") as tmp:
        run_dir = Path(tmp)
        paths = {}
        for seed in seeds:
            (run_dir / str(seed)).mkdir()
            paths[seed] = str(drv.program_config_path(cell, run_dir / str(seed), seed))
        spec = {"config_paths": paths, "run_dir": str(run_dir),
                "traffic": cell["traffic_file"], "trace": False,
                "check_steps": cell["traffic_file"]["check_steps"], "time_from": 10**9,
                "items": items, "limits": cell["limits"]["limits"], "out": str(out),
                "control_seeds": seeds[: args.control_seeds]}
        drv.spawn_ranks_only(rank_main, cell, spec, torch.device("cuda"))
    for line in out.read_text().splitlines():
        print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
