"""Where InceptionV3's weights are found, and the extractor they make.

The repository ships no InceptionV3 weights. The FID extractor becomes
InceptionV3's pool3 (``metrics/inception_v3.py``) only when weights in
torchvision's format are given:

- ``OTM_INCEPTION_WEIGHTS``: a ``.npz`` with torchvision's key names, or a
  torch checkpoint;
- else the first ``inception*`` or ``pt_inception*`` file in
  ``~/.cache/torch/hub/checkpoints``, where torchvision and clean-fid
  download theirs.

Without them ``metrics/fid.py`` falls back to ``random_projection_v1``,
or refuses under ``tpu.require_inception_fid``.
"""

from __future__ import annotations

import os
from pathlib import Path

from one_to_many_gan_torch.device import select_device
from one_to_many_gan_torch.metrics import inception_v3

WEIGHTS_ENV = "OTM_INCEPTION_WEIGHTS"


def _find_weights() -> Path | None:
    env = os.environ.get(WEIGHTS_ENV)
    if env and Path(env).exists():
        return Path(env)
    cache = Path.home() / ".cache/torch/hub/checkpoints"
    if cache.exists():
        for pattern in ("inception*", "pt_inception*"):
            hits = sorted(cache.glob(pattern))
            if hits:
                return hits[0]
    return None


def try_load_inception(device=None):
    """An InceptionV3 ``FeatureFn`` on ``device`` (None: ``cuda``, raising
    without a GPU) when weights are found, else None. A weights file that
    cannot be read or folded prints a line and gives None."""
    weights = _find_weights()
    if weights is None:
        return None
    device = select_device(device)
    try:
        model = inception_v3.from_torchvision_state(inception_v3.load_state_dict_file(weights))
    except inception_v3.UNUSABLE_WEIGHTS as exc:
        print(f"inception weights at {weights} unusable ({exc}); falling back")
        return None
    return inception_v3.make_extractor(model, device=device)
