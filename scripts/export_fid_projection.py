"""Write the weights of the ``random_projection_v1`` FID extractor for the
PyTorch port.

The JAX package's extractor (``metrics/fid.py::random_projection_extractor``)
draws its three conv kernels (HWIO) and its projection from
``jax.random.key(1234)``. torch cannot repeat those draws, so the port
reads them from a file; this script makes the file with the JAX
package's own draws, in float32:

    python scripts/export_fid_projection.py \
        [one_to_many_gan_torch/metrics/random_projection_v1.npz]

Run it where JAX is installed (not on the GPU host). 56,208 float32
values: w0 [5,5,1,16], w1 [3,3,16,32], w2 [3,3,32,64], proj [128,256].
"""

import sys
from pathlib import Path

import jax
import numpy as np

ROOT = Path(__file__).resolve().parent.parent
DEFAULT_OUT = ROOT / "one_to_many_gan_torch" / "metrics" / "random_projection_v1.npz"


def projection_weights(feature_dim: int = 256, seed: int = 1234) -> dict[str, np.ndarray]:
    """The extractor's weights, drawn as the JAX package draws them."""
    keys = jax.random.split(jax.random.key(seed), 4)
    c0, c1, c2 = 16, 32, 64
    weights = {
        "w0": jax.random.normal(keys[0], (5, 5, 1, c0)) / np.sqrt(25),
        "w1": jax.random.normal(keys[1], (3, 3, c0, c1)) / np.sqrt(9 * c0),
        "w2": jax.random.normal(keys[2], (3, 3, c1, c2)) / np.sqrt(9 * c1),
        "proj": jax.random.normal(keys[3], (2 * c2, feature_dim)) / np.sqrt(2 * c2),
    }
    return {k: np.asarray(v, np.float32) for k, v in weights.items()}


def main() -> None:
    jax.config.update("jax_platforms", "cpu")
    out = Path(sys.argv[1]) if len(sys.argv) > 1 else DEFAULT_OUT
    weights = projection_weights()
    np.savez(out, **weights)
    n = sum(v.size for v in weights.values())
    print(f"wrote {out}: {n} float32 values ({out.stat().st_size} bytes)")


if __name__ == "__main__":
    main()
