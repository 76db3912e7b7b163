"""The readings that a cell's limits are set from, on the card.

    python3 -m benchmark.tools.readings --workload <name> --seeds 1,2,3 \\
        --seconds 8 --mode program|control|half|altered [--out file.jsonl]

Runs the cell once per seed in this one process (the kernels built and
the card's libraries loaded once), at the cell's own traffic and load
with a short window, and prints per seed every number the comparison
computes (``checks`` with each limit of ``limits/<workload>.json``, and
the log line with the others). ``--mode``:

- ``program``: the program as the benchmark runs it (the lower reading);
- ``control``: the program's own path one precision below the
  configuration's, switched on (the int8 decode, ``int8=True``);
- ``half``: a fault, half of each coalesced group's requests answered
  with another request's images;
- ``altered``: a fault, the last image of every reply replaced by its
  first, where the engine produces it.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from benchmark import harness
from benchmark.run import log, run_cell


def half_of_batch(engine) -> None:
    """Each group's second half answered with the first half's images."""
    generate = engine.generate_batch

    def wrapped(images, ns, seeds, thetas):
        outs = generate(images, ns, seeds, thetas)
        keep = (len(outs) + 1) // 2
        return [outs[i % keep] for i in range(len(outs))]

    engine.generate_batch = wrapped


def altered_answer(engine) -> None:
    """Every reply's last image replaced by its first."""
    generate = engine.generate_batch

    def wrapped(images, ns, seeds, thetas):
        outs = generate(images, ns, seeds, thetas)
        for out in outs:
            out[-1] = out[0]
        return outs

    engine.generate_batch = wrapped


MODES = {
    "program": {},
    "control": {"engine_options": {"int8": True}},
    "half": {"wrap_engine": half_of_batch},
    "altered": {"wrap_engine": altered_answer},
}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=int, default=8)
    ap.add_argument("--mode", choices=sorted(MODES), default="program")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        log("no CUDA card")
        return 2
    cell = harness.cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        result = run_cell(cell, seed=seed, seconds=args.seconds, trace=False,
                          device=torch.device("cuda"), t_start=time.perf_counter(),
                          **MODES[args.mode])
        row = {"workload": args.workload, "mode": args.mode, "seed": seed,
               "correct": result["correct"], "failed": result["failed"],
               "readings": result["readings"], **result["end_to_end"]}
        line = json.dumps(row)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
