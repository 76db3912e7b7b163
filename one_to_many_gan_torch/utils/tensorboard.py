"""Optional TensorBoard metric sink (``tpu.tensorboard``).

The JAX package's ``utils/tensorboard.py`` on the port. A run's canonical
sinks are the reference-format text ``log`` and ``metrics.jsonl`` (one
JSON object per log interval and per validation checkpoint); this module
writes the same numbers as TensorBoard scalars:

- ``TensorBoardWriter``: the live writer the ``Trainer`` drives when
  ``tpu.tensorboard = true``, at ``<run>/tensorboard``;
- ``export_jsonl``: converts an existing ``metrics.jsonl`` (training
  intervals and validation FID/KID records alike) offline.

Series are ``train/<key>``, and ``val/fid`` and ``val/kid``. It writes
through ``torch.utils.tensorboard``, which needs the ``tensorboard``
package; the import is lazy, so the default path never touches it, and
without the package ``require()`` raises an ``ImportError`` naming it.
"""

from __future__ import annotations

import json
from pathlib import Path


def require():
    """-> ``torch.utils.tensorboard.SummaryWriter``; raises ``ImportError``
    naming the ``tensorboard`` package where it is not installed."""
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError as e:
        msg = ("tpu.tensorboard = true needs the tensorboard package, which is not "
               f"installed ({e}); install it or set tpu.tensorboard = false")
        raise ImportError(msg) from e
    return SummaryWriter


def _scalars(record: dict) -> dict[str, float]:
    return {k: float(v) for k, v in record.items()
            if k != "step" and not isinstance(v, bool) and isinstance(v, (int, float))}


# validation-checkpoint series get the val/ namespace (TensorBoard's
# train/val split)
_VAL_KEYS = frozenset({"fid", "kid"})


class TensorBoardWriter:
    """A scalar writer bound to one event directory."""

    def __init__(self, logdir: Path | str):
        self._writer = require()(str(logdir))

    def write(self, step: int, scalars: dict) -> None:
        for k, v in _scalars(scalars).items():
            prefix = "val" if k in _VAL_KEYS else "train"
            self._writer.add_scalar(f"{prefix}/{k}", v, step)
        self._writer.flush()

    def close(self) -> None:
        self._writer.close()


def export_jsonl(jsonl_path: Path | str, logdir: Path | str) -> int:
    """Write every numeric field of every record of a run's
    ``metrics.jsonl`` as a scalar series under ``logdir``. -> the number
    of records."""
    writer = TensorBoardWriter(logdir)
    n = 0
    try:
        for line in Path(jsonl_path).read_text().splitlines():
            if line.strip():
                record = json.loads(line)
                writer.write(int(record.get("step", n)), record)
                n += 1
    finally:
        writer.close()
    return n


def main() -> None:
    import argparse

    ap = argparse.ArgumentParser(description=export_jsonl.__doc__)
    ap.add_argument("jsonl", help="path to a run's metrics.jsonl")
    ap.add_argument("logdir", help="TensorBoard event directory to write")
    args = ap.parse_args()
    print(f"exported {export_jsonl(args.jsonl, args.logdir)} records to {args.logdir}")


if __name__ == "__main__":
    main()
