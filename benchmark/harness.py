"""The benchmark's data-driven core: it finds a cell's parts by name.

``BENCHMARK.json`` names each cell's configuration and traffic mix, and
each metric. The harness reads

- ``configs/<config>.json``: the configuration as it is run (its
  ``config`` holds the program's TOML sections), its ``source``, what was
  changed and assumed, and the ``reference`` module it is held to;
- ``traffic/<traffic>.json``: the mix's parameters, and the ``driver``
  (``drivers/<driver>.py``) that generates it and runs the cell;
- ``limits/<workload>.json``: the limits of the comparison that decides
  ``correct``, with the readings each was set from;
- ``metrics/<metric>.py``: one reader per per-layer metric, ``read(run)``
  -> a number, or None where the run has nothing for it to read;
- ``peaks.json``: the card's published peaks.

A later cell or metric is added with files and entries of its own.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
REPO = ROOT.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "one_to_many_gan_tpu")


def load_json(path: Path) -> dict:
    return json.loads(path.read_text())


def manifest() -> dict:
    return load_json(REPO / "BENCHMARK.json")


def peaks() -> dict:
    return load_json(ROOT / "peaks.json")


def _load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def cell(workload: str) -> dict:
    """Everything one cell runs from: the manifest's entry, its
    configuration file, traffic, limits, and its metrics by kind."""
    bench = manifest()
    entry = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if entry is None:
        names = [w["name"] for w in bench["workloads"]]
        msg = f"unknown workload {workload!r}; the benchmark has {names}"
        raise KeyError(msg)
    config = next(c for c in bench["configs"] if c["name"] == entry["config"])

    def reports(metric: dict) -> bool:
        return workload in metric.get("workloads", [workload])

    return {
        **entry,
        "run_seconds": bench["run_seconds"],
        "config_file": load_json(REPO / config["file"]),
        "traffic_file": load_json(ROOT / "traffic" / f"{entry['traffic']}.json"),
        "limits": load_json(ROOT / "limits" / f"{workload}.json"),
        "end_to_end": [m for m in bench["end_to_end"] if reports(m)],
        "per_layer": [m for m in bench["per_layer"] if reports(m)],
    }


def driver(name: str):
    return importlib.import_module(f"benchmark.drivers.{name}")


def reference(name: str):
    return importlib.import_module(f"benchmark.reference.{name}")


def read_metric(name: str, run) -> float | None:
    """The reader ``metrics/<name>.py`` applied to ``run``; None when it
    finds nothing to read (the metric is then left out of the line)."""
    value = _load_module(ROOT / "metrics" / f"{name}.py", f"benchmark_metric_{name}").read(run)
    if value is None or not math.isfinite(value):
        return None
    return float(value)


def _toml(value) -> str:
    if isinstance(value, bool):
        return "true" if value else "false"
    if isinstance(value, (int, float)):
        return repr(value)
    if isinstance(value, str):
        return json.dumps(value)
    if isinstance(value, list):
        return "[" + ", ".join(_toml(v) for v in value) + "]"
    msg = f"cannot write {value!r} as TOML"
    raise TypeError(msg)


def write_program_config(sections: dict, path: Path, **overrides: dict) -> Path:
    """The configuration's sections, with ``overrides`` per section (the
    run's own directories), as a TOML file the program loads itself."""
    lines = []
    for section, values in sections.items():
        lines.append(f"[{section}]")
        merged = {**values, **overrides.get(section, {})}
        lines += [f"{key} = {_toml(v)}" for key, v in merged.items()]
        lines.append("")
    path.write_text("\n".join(lines))
    return path


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's (whole names compared)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
