"""FID / KID (the reference computes them with the external clean-fid).

The distances are the JAX package's ``metrics/fid.py``, copied (but for
``sqrtm``'s ``disp`` argument, which newer scipy releases refuse): the
Fréchet distance through a symmetric matrix square root (retried with
``eps * I`` on both covariances when it is not finite) and KID as the
unbiased cubic-kernel MMD^2 averaged over subsets (clean-fid's protocol:
subsets of 1000, 100 of them), all numpy and scipy.

Feature extraction: the canonical extractor is InceptionV3's pool3
(``metrics/inception_v3.py``), used whenever its weights are found
(``metrics/inception.py``); the repository ships none. Without them the
extractor is the JAX package's ``random_projection_v1``: three frozen
random stride-2 convs with LeakyReLU(0.2), global mean and max pooling
and a random projection to 256 features, on images resized bilinearly
to 64x64. Its weights were
drawn by JAX from one fixed key; torch cannot repeat those draws, so the
port reads them from ``random_projection_v1.npz`` beside this module
(written by ``scripts/export_fid_projection.py``). The same images then
give the same features, and the same FID, in both packages. Such a FID
tracks a run relative to itself; it is not comparable to Inception FID,
and every log line carries the extractor's name.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Callable
from pathlib import Path

import numpy as np
import scipy.linalg

PROJECTION_NAME = "random_projection_v1"
INCEPTION_NAME = "inception_v3_pool3"
PROJECTION_WEIGHTS = Path(__file__).with_name(f"{PROJECTION_NAME}.npz")


@dataclasses.dataclass
class FeatureStats:
    mu: np.ndarray  # [D]
    sigma: np.ndarray  # [D, D]
    features: np.ndarray  # [N, D]


def frechet_distance(
    stats1: FeatureStats, stats2: FeatureStats, eps: float = 1e-6
) -> float:
    """|mu1-mu2|^2 + tr(S1 + S2 - 2 sqrtm(S1 S2)).

    Near-singular covariances (few eval images) can make sqrtm non-finite;
    like clean-fid/pytorch-fid, retry with an ``eps * I`` offset on both
    covariances before giving up.
    """
    mu1, s1 = stats1.mu, stats1.sigma
    mu2, s2 = stats2.mu, stats2.sigma
    diff = mu1 - mu2
    # sqrtm's matrix alone: scipy releases differ on its ``disp`` argument
    covmean = scipy.linalg.sqrtm(s1 @ s2)
    if not np.isfinite(covmean).all():
        offset = np.eye(s1.shape[0]) * eps
        covmean = scipy.linalg.sqrtm((s1 + offset) @ (s2 + offset))
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(diff @ diff + np.trace(s1) + np.trace(s2) - 2.0 * np.trace(covmean))


def kernel_distance(
    feats1: np.ndarray,
    feats2: np.ndarray,
    subset_size: int = 1000,
    num_subsets: int = 100,
    seed: int = 0,
) -> float:
    """Unbiased MMD^2 with kernel (x.y/D + 1)^3, clean-fid subset protocol."""
    n = min(subset_size, feats1.shape[0], feats2.shape[0])
    d = feats1.shape[1]
    rng = np.random.default_rng(seed)
    total = 0.0
    for _ in range(num_subsets):
        x = feats1[rng.choice(feats1.shape[0], n, replace=False)].astype(np.float64)
        y = feats2[rng.choice(feats2.shape[0], n, replace=False)].astype(np.float64)
        kxx = (x @ x.T / d + 1.0) ** 3
        kyy = (y @ y.T / d + 1.0) ** 3
        kxy = (x @ y.T / d + 1.0) ** 3
        a = (kxx.sum() - np.trace(kxx) + kyy.sum() - np.trace(kyy)) / (n * (n - 1))
        b = 2.0 * kxy.mean()
        total += a - b
    return float(total / num_subsets)


def compute_stats(features: np.ndarray) -> FeatureStats:
    mu = features.mean(axis=0)
    sigma = np.cov(features, rowvar=False)
    return FeatureStats(mu=mu, sigma=np.atleast_2d(sigma), features=features)


# ------------------------------------------------------------ extractors

FeatureFn = Callable[[np.ndarray], np.ndarray]
"""[N,H,W,C] uint8 -> [N,D] float32 features."""


def _same_pad(n: int, k: int, stride: int) -> tuple[int, int]:
    """XLA's "SAME" padding of one axis: ceil(n / stride) outputs, the
    total padding split with the odd element after."""
    out = -(-n // stride)
    total = max((out - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


def random_projection_extractor(device=None, image_size: int = 64) -> FeatureFn:
    """The ``random_projection_v1`` extractor on ``device`` (None: ``cuda``,
    raising without a GPU; see ``device.select_device``).

    The convolutions run in float64 with the committed float32 weights
    (no TF32, no algorithm choice in the way of matching the JAX package's
    float32 features to ~1e-6), and the features come back as float32.
    Batches of 64 images, as the JAX package's.
    """
    import torch
    import torch.nn.functional as F

    from one_to_many_gan_torch.device import select_device
    from one_to_many_gan_torch.ops.resample import bilinear_resize

    device = select_device(device)
    with np.load(PROJECTION_WEIGHTS) as z:
        # HWIO -> OIHW for the convs; the projection stays [2 * c2, D]
        convs = [
            torch.from_numpy(z[name].transpose(3, 2, 0, 1).copy()).to(device, torch.float64)
            for name in ("w0", "w1", "w2")
        ]
        proj = torch.from_numpy(z["proj"]).to(device, torch.float64)

    def forward(x):
        for w in convs:
            k = w.shape[-1]
            top, bottom = _same_pad(x.shape[2], k, 2)
            left, right = _same_pad(x.shape[3], k, 2)
            x = F.conv2d(F.pad(x, (left, right, top, bottom)), w, stride=2)
            x = torch.where(x >= 0, x, 0.2 * x)
        pooled = torch.cat([x.mean(dim=(2, 3)), x.amax(dim=(2, 3))], dim=1)
        return pooled @ proj

    @torch.no_grad()
    def extract(images_u8: np.ndarray) -> np.ndarray:
        out = []
        batch = 64
        for i in range(0, images_u8.shape[0], batch):
            x = torch.from_numpy(np.ascontiguousarray(images_u8[i : i + batch])).to(device)
            x = x.to(torch.float32) / 127.5 - 1.0  # normalize_u8's op order
            if x.shape[-1] != 1:
                x = x.mean(dim=-1, keepdim=True)
            x = x.permute(0, 3, 1, 2).to(torch.float64)
            if x.shape[2] != image_size or x.shape[3] != image_size:
                x = bilinear_resize(x, image_size, image_size)
            out.append(forward(x).to(torch.float32).cpu().numpy())
        return np.concatenate(out)

    return extract


class InceptionUnavailableError(RuntimeError):
    """``require_inception=True`` (``tpu.require_inception_fid``) where no
    InceptionV3 is available: the run would otherwise log relative-only
    random-projection FIDs that are not comparable to the reference's
    clean-fid numbers."""


def default_extractor(
    *, require_inception: bool = False, device=None
) -> tuple[FeatureFn, str]:
    """The best extractor there is, on ``device`` (None: ``cuda``), and its
    name: InceptionV3's pool3 (``inception_v3_pool3``) when its weights are
    found (``metrics/inception.py``), else ``random_projection_v1``, or,
    under ``require_inception`` (``tpu.require_inception_fid``),
    ``InceptionUnavailableError``."""
    from one_to_many_gan_torch.metrics.inception import WEIGHTS_ENV, try_load_inception

    inception = try_load_inception(device)
    if inception is not None:
        return inception, INCEPTION_NAME
    if require_inception:
        msg = (
            "tpu.require_inception_fid=true but no InceptionV3 weights are available "
            f"(set {WEIGHTS_ENV} to torchvision-format weights, or place them in "
            "~/.cache/torch/hub/checkpoints: see metrics/inception.py); refusing to log "
            "a non-comparable random-projection FID"
        )
        raise InceptionUnavailableError(msg)
    return random_projection_extractor(device), PROJECTION_NAME


# ------------------------------------------------------------ entry points


def _load_dir(path: Path | str, limit: int | None = None) -> np.ndarray:
    from PIL import Image

    files = sorted(Path(path).rglob("*.png")) + sorted(Path(path).rglob("*.jpg"))
    if limit is not None:
        files = files[:limit]
    if not files:
        raise FileNotFoundError(f"no images under {path}")
    arrs = []
    for f in files:
        a = np.asarray(Image.open(f).convert("L"), dtype=np.uint8)
        arrs.append(a[:, :, None])
    return np.stack(arrs)


def _images(images: np.ndarray | str | Path) -> np.ndarray:
    return _load_dir(images) if isinstance(images, (str, Path)) else images


def compute_fid(
    images1: np.ndarray | str | Path,
    images2: np.ndarray | str | Path,
    extractor: FeatureFn | None = None,
    device=None,
) -> float:
    """FID between two image sets (uint8 arrays or directories of images).
    Without ``extractor``, the default one runs on ``device`` (None:
    ``cuda``)."""
    if extractor is None:
        extractor, _ = default_extractor(device=device)
    return frechet_distance(
        compute_stats(extractor(_images(images1))), compute_stats(extractor(_images(images2)))
    )


def compute_kid(
    images1: np.ndarray | str | Path,
    images2: np.ndarray | str | Path,
    extractor: FeatureFn | None = None,
    subset_size: int = 1000,
    num_subsets: int = 100,
    device=None,
) -> float:
    """KID between two image sets (clean-fid subset protocol). Without
    ``extractor``, the default one runs on ``device`` (None: ``cuda``)."""
    if extractor is None:
        extractor, _ = default_extractor(device=device)
    return kernel_distance(
        extractor(_images(images1)), extractor(_images(images2)),
        subset_size=subset_size, num_subsets=num_subsets,
    )
