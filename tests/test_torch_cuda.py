"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and skips without one: a CUDA kernel
has no CPU mode. The file imports neither JAX nor the JAX package, so it
runs on a GPU host that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -m cuda

Tolerances are the JAX package's own for instance norm: 2e-5 in float32
and 0.05 in bfloat16 (tests/test_pallas_kernels.py).
"""

import pytest
import torch

from one_to_many_gan_torch.ops.cuda import fused_instance_norm, instance_norm_plain

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 2e-5, torch.bfloat16: 0.05}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.Generator("cuda").manual_seed(0)


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "shape",
    [
        (2, 64, 33, 17),  # H*W not a multiple of the vector width: scalar path
        (1, 8, 64, 32),  # vector path
        (3, 5, 128, 64),  # vector path, several unrolled steps per thread
        (1, 1, 1, 3),  # fewer elements than threads
    ],
)
def test_instance_norm_kernel_matches_plain(cuda, shape, dtype, relu):
    x = (torch.randn(shape, generator=cuda, device="cuda") * 2 + 0.5).to(dtype)
    before = fused_instance_norm.launches
    got = fused_instance_norm(x, relu=relu)
    assert fused_instance_norm.launches == before + 1
    want = instance_norm_plain(x, relu=relu)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == x.shape
    assert (got.float() - want.float()).abs().max().item() <= TOL[dtype]
    if relu:
        assert (got >= 0).all()


def test_instance_norm_kernel_raises_instead_of_falling_back(cuda):
    before = fused_instance_norm.launches
    x = torch.randn((1, 4, 8, 8), generator=cuda, device="cuda")
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fused_instance_norm(x.double())
    with pytest.raises(ValueError, match="contiguous"):
        fused_instance_norm(x.transpose(2, 3))
    with pytest.raises(ValueError, match="NCHW"):
        fused_instance_norm(x[0])
    assert fused_instance_norm.launches == before
