"""Device and numeric-mode selection for the port's entry points.

Every entry point runs on ``cuda`` unless the caller asks for the CPU.
Without a GPU and without that request it raises: it never drops to the
CPU silently.
"""

from __future__ import annotations

import os

import torch

# cuBLAS's workspace for reproducible results (NVIDIA's cuBLAS docs, "Results
# reproducibility"): PyTorch refuses cuBLAS under deterministic algorithms
# without it.
CUBLAS_WORKSPACE_CONFIG = ":4096:8"


def select_device(device: str | torch.device | None = None) -> torch.device:
    """-> the device to run on: ``cuda`` when ``device`` is None.

    Raises ``RuntimeError`` when CUDA is asked for (explicitly or by
    default) and none is available.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        msg = f"unsupported device {dev}; use 'cuda' or 'cpu'"
        raise ValueError(msg)
    if dev.type == "cuda" and not torch.cuda.is_available():
        msg = (
            "CUDA is not available on this host; pass device='cpu' "
            "(--device cpu) to run on the CPU"
        )
        raise RuntimeError(msg)
    return dev


def compute_dtype(config) -> torch.dtype:
    """Activation dtype of a config: ``[tpu] precision``."""
    return torch.bfloat16 if config["tpu"]["precision"] == "bfloat16" else torch.float32


def disable_tf32() -> None:
    """Turn TF32 off for the process: ``torch.backends.cuda.matmul.allow_tf32``
    and ``torch.backends.cudnn.allow_tf32`` both False. A float32 config on
    the card then computes its convolutions and matmuls in full float32
    (cuDNN's default would be TF32), so its output can be held to the CPU's.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def set_cublas_workspace() -> None:
    """Set ``CUBLAS_WORKSPACE_CONFIG`` to ``:4096:8`` unless it is set.
    PyTorch fixes cuBLAS's workspace when it first uses cuBLAS, so an entry
    point that will train deterministically calls this before it touches
    CUDA."""
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", CUBLAS_WORKSPACE_CONFIG)


def use_deterministic_kernels() -> None:
    """Make every kernel of the process deterministic, for
    ``training.deterministic_cuda_kernels = true``:
    ``torch.use_deterministic_algorithms(True)`` (an op with no
    deterministic implementation then raises instead of varying quietly),
    ``cudnn.deterministic`` True, ``cudnn.benchmark`` False and
    ``set_cublas_workspace``. The port's own kernels are deterministic in
    every mode (the warp backward gathers, the instance norm sums in a fixed
    order, the pads fold their gradient with slices). Process-wide, like
    ``disable_tf32``; nothing turns it off again."""
    set_cublas_workspace()
    torch.use_deterministic_algorithms(True)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
