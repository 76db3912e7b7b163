"""Write the copy of a config written for several devices that N cards run.

    python scripts/one_card_config.py configs/tpu_v5e8_512.toml one_card.toml \
        [--cards N] [--keep-spatial] [key=value ...]

The copy runs one data-parallel replica of the config on each of N cards
(default 1; ``one_to_many_gan_torch.presets.card_overrides``:
``data_parallel`` N, ``batch_size`` N replicas' share of the global batch,
``spatial_parallel`` 1; with N = 4 ``configs/tpu_v5e8_512.toml`` keeps its
``data_parallel = 4`` and ``batch_size = 32``). With ``--keep-spatial``
the config's spatial axis stays: ``data_parallel`` N // ``spatial_parallel``
and the global batch as written (with N = 4 the production config runs
data 2 x spatial 2 at batch 32). Each ``key=value`` (a TOML value, e.g.
``shoeprint_data_dir='"/data/prints"'``, or ``native_loader=false`` on a
host without the libjpeg and libpng headers) replaces another key's line.
Every key changed is printed with its old and new value. Then

    python -m one_to_many_gan_torch.train one_card.toml

trains it on the card (on N cards, one rank each).
"""

from __future__ import annotations

import sys
import tomllib
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from one_to_many_gan_torch.config import load_config  # noqa: E402
from one_to_many_gan_torch.presets import write_card_config  # noqa: E402


def main(argv: list[str]) -> None:
    if len(argv) < 2:
        sys.exit(__doc__)
    cards = 1
    spatial = "--keep-spatial" in argv
    argv = [a for a in argv if a != "--keep-spatial"]
    if "--cards" in argv:
        i = argv.index("--cards")
        cards = int(argv[i + 1])
        argv = argv[:i] + argv[i + 2 :]
    src, dst, *pairs = argv
    values = {}
    for pair in pairs:
        key, _, value = pair.partition("=")
        values[key] = tomllib.loads(f"v = {value}")["v"]
    before = load_config(src)
    flat = {k: v for section in before.values() if isinstance(section, dict)
            for k, v in section.items()}
    for key, value in write_card_config(src, dst, cards=cards, spatial=spatial,
                                              **values).items():
        print(f"override {key}: {flat.get(key)!r} -> {value!r}")
    print(f"wrote {dst}")


if __name__ == "__main__":
    main(sys.argv[1:])
