"""Write one card's copy of a config written for several devices.

    python scripts/one_card_config.py configs/tpu_v5e8_512.toml one_card.toml \
        [key=value ...]

The copy runs one data-parallel replica of the config on one card
(``one_to_many_gan_torch.presets.one_card_overrides``: ``data_parallel``
and ``spatial_parallel`` 1, ``batch_size`` the replica's share of the
global batch); each ``key=value`` (a TOML value, e.g.
``shoeprint_data_dir='"/data/prints"'``, or ``native_loader=false`` on a
host without the libjpeg and libpng headers) replaces another key's line.
Every key changed is printed with its old and new value. Then

    python -m one_to_many_gan_torch.train one_card.toml

trains it on the card.
"""

from __future__ import annotations

import sys
import tomllib
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from one_to_many_gan_torch.config import load_config  # noqa: E402
from one_to_many_gan_torch.presets import write_one_card_config  # noqa: E402


def main(argv: list[str]) -> None:
    if len(argv) < 2:
        sys.exit(__doc__)
    src, dst, *pairs = argv
    values = {}
    for pair in pairs:
        key, _, value = pair.partition("=")
        values[key] = tomllib.loads(f"v = {value}")["v"]
    before = load_config(src)
    flat = {k: v for section in before.values() if isinstance(section, dict)
            for k, v in section.items()}
    for key, value in write_one_card_config(src, dst, **values).items():
        print(f"override {key}: {flat.get(key)!r} -> {value!r}")
    print(f"wrote {dst}")


if __name__ == "__main__":
    main(sys.argv[1:])
