"""The int8 convolution of the int8 serving path, through a hand-written
CUDA kernel.

Replaces no TPU kernel: the JAX package leaves this conv to XLA
(``conv_general_dilated(..., preferred_element_type=int32)`` in its
``ops/quantize.py``), and PyTorch has no int8 convolution on CUDA.
Source: ``csrc/int8_conv.cu``, an implicit GEMM on the int8 tensor cores
(``mma.sync`` m16n8k32) over a channels-last input.

``int8_conv_codes(xq, wq, x_scale, w_scale)`` takes codes that
``ops/quantize.py`` made: ``xq`` [B, Hp, Wp, C] int8 (already padded,
channels last), ``wq`` [O, KH, KW, C] int8, ``x_scale`` [B] and
``w_scale`` [O] float32, and gives the VALID conv as float32 NCHW
[B, O, Hp-KH+1, Wp-KW+1]: the exact int32 sum times ``x_scale[b] *
w_scale[o]`` (the product formed first). Integer sums are exact in any
order, so the kernel's output is bitwise its plain version's.

Bound: operations at the decoder's 256-channel sites (the card's dense
int8 rate), bytes at the last up conv (its float32 output).

For a tensor on the CPU ``int8_conv_codes`` takes the plain version; for a
CUDA tensor it launches the kernel or raises. ``int8_conv_codes.launches``
counts the kernel's launches.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from one_to_many_gan_torch.ops.cuda import build

# The kernel reads K in 32-byte slices of one tap: C % K_SLICE == 0.
K_SLICE = 32
# Output pixels per block (csrc/int8_conv.cu: kBM); the pixel count must
# stay below 2^31 - 1 - BLOCK_M.
BLOCK_M = 128


def _lib() -> ctypes.CDLL:
    lib = build.load("int8_conv")
    lib.otm_int8_conv.argtypes = [*[ctypes.c_void_p] * 5, *[ctypes.c_int] * 7, ctypes.c_void_p]
    lib.otm_int8_conv.restype = ctypes.c_int
    lib.otm_cuda_error_string.argtypes = [ctypes.c_int]
    lib.otm_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _shapes(xq: torch.Tensor, wq: torch.Tensor, x_scale: torch.Tensor,
            w_scale: torch.Tensor) -> tuple[int, ...]:
    """(B, Hp, Wp, C, O, KH, KW), after checking dtypes and shapes."""
    if xq.dtype != torch.int8 or wq.dtype != torch.int8:
        msg = f"int8_conv: codes must be int8, got {xq.dtype} and {wq.dtype}"
        raise TypeError(msg)
    if x_scale.dtype != torch.float32 or w_scale.dtype != torch.float32:
        msg = f"int8_conv: scales must be float32, got {x_scale.dtype} and {w_scale.dtype}"
        raise TypeError(msg)
    if xq.dim() != 4 or wq.dim() != 4:
        msg = f"int8_conv: expected [B,Hp,Wp,C] and [O,KH,KW,C], got {tuple(xq.shape)} and " \
              f"{tuple(wq.shape)}"
        raise ValueError(msg)
    b, hp, wp, c = xq.shape
    o, kh, kw, cw = wq.shape
    if cw != c or hp < kh or wp < kw or min(b, c, o, kh, kw) == 0:
        msg = f"int8_conv: input {tuple(xq.shape)} and weight {tuple(wq.shape)} do not fit"
        raise ValueError(msg)
    if tuple(x_scale.shape) != (b,) or tuple(w_scale.shape) != (o,):
        msg = f"int8_conv: scales {tuple(x_scale.shape)} and {tuple(w_scale.shape)}, " \
              f"want ({b},) and ({o},)"
        raise ValueError(msg)
    return b, hp, wp, c, o, kh, kw


def int8_conv_plain(xq: torch.Tensor, wq: torch.Tensor, x_scale: torch.Tensor,
                    w_scale: torch.Tensor) -> torch.Tensor:
    """The kernel's plain PyTorch version: the int32 sum as a float64 conv
    of the codes (exact: |sum| <= 127^2 * KH*KW*C, far below 2^53), then
    the same rescale."""
    _shapes(xq, wq, x_scale, w_scale)
    x64 = xq.permute(0, 3, 1, 2).to(torch.float64)
    w64 = wq.permute(0, 3, 1, 2).to(torch.float64)
    y32 = F.conv2d(x64, w64).to(torch.int32)
    return y32.to(torch.float32) * (x_scale[:, None, None, None] * w_scale[None, :, None, None])


def _launch(xq, wq, x_scale, w_scale) -> torch.Tensor:
    b, hp, wp, c, o, kh, kw = _shapes(xq, wq, x_scale, w_scale)
    tensors = (xq, wq, x_scale, w_scale)
    if any(t.device != xq.device for t in tensors):
        msg = f"int8_conv: tensors on {[str(t.device) for t in tensors]}"
        raise ValueError(msg)
    if not all(t.is_contiguous() for t in tensors):
        msg = "int8_conv: codes and scales must be contiguous"
        raise ValueError(msg)
    if c % K_SLICE:
        msg = f"int8_conv: {c} input channels (the kernel takes multiples of {K_SLICE})"
        raise ValueError(msg)
    ho, wo = hp - kh + 1, wp - kw + 1
    if b * ho * wo > 2**31 - 1 - BLOCK_M:
        msg = f"int8_conv: {b * ho * wo} output pixels (at most 2^31 - 1 - {BLOCK_M})"
        raise ValueError(msg)
    if (xq.data_ptr() | wq.data_ptr()) % 16:
        msg = "int8_conv: codes must start on a 16-byte boundary"
        raise ValueError(msg)
    y = torch.empty((b, o, ho, wo), dtype=torch.float32, device=xq.device)
    lib = _lib()
    with torch.cuda.device(xq.device):
        stream = torch.cuda.current_stream(xq.device).cuda_stream
        err = lib.otm_int8_conv(xq.data_ptr(), wq.data_ptr(), x_scale.data_ptr(),
                                w_scale.data_ptr(), y.data_ptr(), b, hp, wp, c, o, kh, kw,
                                stream)
    if err != 0:
        reason = lib.otm_cuda_error_string(err).decode()
        msg = f"int8_conv kernel launch failed: CUDA error {err} ({reason})"
        raise RuntimeError(msg)
    int8_conv_codes.launches += 1
    return y


def int8_conv_codes(xq: torch.Tensor, wq: torch.Tensor, x_scale: torch.Tensor,
                    w_scale: torch.Tensor) -> torch.Tensor:
    """The VALID conv of int8 codes, rescaled to float32 NCHW (module
    docstring). CPU tensors: the plain version. CUDA tensors: the kernel,
    which takes contiguous codes with C a multiple of 32; anything else
    raises."""
    if xq.device.type == "cpu":
        return int8_conv_plain(xq, wq, x_scale, w_scale)
    if xq.device.type != "cuda":
        msg = f"int8_conv: unsupported device {xq.device}"
        raise ValueError(msg)
    return _launch(xq, wq, x_scale, w_scale)


int8_conv_codes.launches = 0

