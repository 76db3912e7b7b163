"""The int8 serving path's modulated conv, through two hand-written CUDA
kernels: an amax pre-pass and one fused conv.

Replaces no TPU kernel: the JAX package leaves this conv to XLA
(``conv_general_dilated(..., preferred_element_type=int32)`` in its
``ops/quantize.py``, after modulating, padding and quantising its input
in separate ops), and PyTorch has no int8 convolution on CUDA. Source:
``csrc/int8_conv.cu``.

``modulated_int8_conv(x, s, w_q, w_scale, d, padding=, pad_mode=,
dtype=)`` is one decoder site of ``ModulatedConv(int8=True)`` from its
unpadded input to its demodulated output, in the activation ``dtype``:

    v       = x.to(dtype) * s.to(dtype)       (per sample and channel; s None: ones)
    vp      = pad2d(v, padding, pad_mode)
    x_scale = the per-sample scale of vp      (ops/quantize.py; = that of v)
    y       = int8_conv_plain(codes of vp, w_q, x_scale, w_scale)   (float32)
    y       = y.to(dtype) * d.to(dtype)       (per sample and output channel; d None: ones)

``w_q`` [O, C, 3, 3] int8 and ``w_scale`` [O] float32 are
``quantize_weight`` of the equalized weight. On the card it is two
launches: ``int8_prepass`` (``x_scale``) and ``fused_int8_conv``, which
modulates, pads and quantises while it loads, multiplies with ``wgmma``
on the int8 tensor cores and rescales, casts and demodulates in its
epilogue. Integer sums are exact in any order and every rounding is the
plain version's, so the kernels' output is bitwise the plain version's.

Bound: bytes (two reads of ``x``, one write of ``y``) at the up convs and
in float32; operations (the card's dense int8 rate) at the 256-channel
convs in bfloat16.

For tensors on the CPU each wrapper takes its plain version; for CUDA
tensors it launches its kernel or raises. ``int8_prepass.launches`` and
``fused_int8_conv.launches`` count the launches.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from one_to_many_gan_torch.ops.cuda import build
from one_to_many_gan_torch.ops.equalized import pad2d
from one_to_many_gan_torch.ops.quantize import activation_codes, activation_scale

# The kernel reads K in slices of 32 channels: C % K_SLICE == 0.
K_SLICE = 32
# Output channels per block (csrc/int8_conv.cu: one wgmma N): the smallest
# that holds O, else 256 and several N tiles.
N_TILES = (64, 128, 256)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_PAD_MODES = ("zero", "reflect")


def _lib() -> ctypes.CDLL:
    lib = build.load("int8_conv")
    lib.otm_int8_amax.argtypes = [*[ctypes.c_void_p] * 4, ctypes.c_int, ctypes.c_int,
                                  ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.otm_int8_amax.restype = ctypes.c_int
    lib.otm_int8_modconv.argtypes = [*[ctypes.c_void_p] * 7, *[ctypes.c_int] * 10,
                                     ctypes.c_void_p]
    lib.otm_int8_modconv.restype = ctypes.c_int
    lib.otm_cuda_error_string.argtypes = [ctypes.c_int]
    lib.otm_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _raise_on(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        reason = lib.otm_cuda_error_string(err).decode()
        msg = f"{what} kernel launch failed: CUDA error {err} ({reason})"
        raise RuntimeError(msg)


def _tile_n(o: int) -> int:
    """The kernel's N tile for ``o`` output channels."""
    return next((n for n in N_TILES if o <= n), N_TILES[-1])


# ------------------------------------------------------------ plain versions


def modulate_plain(x: torch.Tensor, s: torch.Tensor | None, dtype: torch.dtype) -> torch.Tensor:
    """``x.to(dtype) * s.to(dtype)`` over H and W (``s`` None: ones)."""
    x = x.to(dtype)
    return x if s is None else x * s[:, :, None, None].to(dtype)


def int8_conv_plain(xq: torch.Tensor, wq: torch.Tensor, x_scale: torch.Tensor,
                    w_scale: torch.Tensor) -> torch.Tensor:
    """The VALID conv of channels-last int8 codes ``xq`` [B, Hp, Wp, C] with
    ``wq`` [O, KH, KW, C], rescaled to float32 NCHW: the int32 sum as a
    float64 conv of the codes (exact: |sum| <= 127^2 * KH*KW*C, far below
    2^53), times ``x_scale[b] * w_scale[o]`` (the product formed first)."""
    x64 = xq.permute(0, 3, 1, 2).to(torch.float64)
    w64 = wq.permute(0, 3, 1, 2).to(torch.float64)
    y32 = F.conv2d(x64, w64).to(torch.int32)
    return y32.to(torch.float32) * (x_scale[:, None, None, None] * w_scale[None, :, None, None])


def int8_prepass_plain(x: torch.Tensor, s: torch.Tensor | None,
                       dtype: torch.dtype) -> torch.Tensor:
    """The pre-pass's plain version: the per-sample scale of the modulated
    ``x``, which padding does not change."""
    return activation_scale(modulate_plain(x, s, dtype))


def fused_int8_conv_plain(x: torch.Tensor, s: torch.Tensor | None, x_scale: torch.Tensor,
                          w_q: torch.Tensor, w_scale: torch.Tensor, d: torch.Tensor | None, *,
                          padding: int, pad_mode: str, dtype: torch.dtype) -> torch.Tensor:
    """The fused conv's plain version (module docstring), the codes taken
    at ``x_scale``."""
    vp = pad2d(modulate_plain(x, s, dtype), padding, pad_mode)
    codes = activation_codes(vp, x_scale).permute(0, 2, 3, 1)
    y = int8_conv_plain(codes, w_q.permute(0, 2, 3, 1), x_scale, w_scale).to(dtype)
    return y if d is None else y * d[:, :, None, None].to(dtype)


def modulated_int8_conv_plain(x: torch.Tensor, s: torch.Tensor | None, w_q: torch.Tensor,
                              w_scale: torch.Tensor, d: torch.Tensor | None, *, padding: int,
                              pad_mode: str, dtype: torch.dtype) -> torch.Tensor:
    """The plain version of the pre-pass and the fused conv together."""
    return fused_int8_conv_plain(x, s, int8_prepass_plain(x, s, dtype), w_q, w_scale, d,
                                 padding=padding, pad_mode=pad_mode, dtype=dtype)


# ------------------------------------------------------------------ kernels


def _check_device(where: str, *tensors: torch.Tensor | None) -> None:
    given = [t for t in tensors if t is not None]
    if any(t.device != given[0].device for t in given):
        msg = f"{where}: tensors on {[str(t.device) for t in given]}"
        raise ValueError(msg)
    if not all(t.is_contiguous() for t in given):
        msg = f"{where}: tensors must be contiguous"
        raise ValueError(msg)


def _check_x_s(where: str, x: torch.Tensor, s: torch.Tensor | None, dtype: torch.dtype) -> None:
    if x.dim() != 4 or x.numel() == 0:
        msg = f"{where}: expected a non-empty [B,C,H,W] input, got {tuple(x.shape)}"
        raise ValueError(msg)
    if x.dtype not in _DTYPE_CODES or dtype not in _DTYPE_CODES:
        msg = f"{where}: input and activation dtypes must be float32 or bfloat16, got " \
              f"{x.dtype} and {dtype}"
        raise TypeError(msg)
    if s is not None and (s.dtype != torch.float32 or tuple(s.shape) != tuple(x.shape[:2])):
        msg = f"{where}: style must be float32 {tuple(x.shape[:2])}, got {s.dtype} " \
              f"{tuple(s.shape)}"
        raise ValueError(msg)
    if x.data_ptr() % 16:
        msg = f"{where}: the input must start on a 16-byte boundary"
        raise ValueError(msg)


def _launch_prepass(x: torch.Tensor, s: torch.Tensor | None, dtype: torch.dtype) -> torch.Tensor:
    _check_x_s("int8_prepass", x, s, dtype)
    _check_device("int8_prepass", x, s)
    b, c, h, w = x.shape
    if b > 65535:
        msg = f"int8_prepass: {b} samples (at most 65535)"
        raise ValueError(msg)
    x_scale = torch.empty(b, dtype=torch.float32, device=x.device)
    work = torch.empty(2 * b, dtype=torch.int32, device=x.device)
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.otm_int8_amax(x.data_ptr(), None if s is None else s.data_ptr(),
                                work.data_ptr(), x_scale.data_ptr(), b, c, h * w,
                                _DTYPE_CODES[x.dtype], _DTYPE_CODES[dtype], stream)
    _raise_on(lib, err, "int8_prepass")
    int8_prepass.launches += 1
    return x_scale


def int8_prepass(x: torch.Tensor, s: torch.Tensor | None, dtype: torch.dtype) -> torch.Tensor:
    """The per-sample scale (float32 [B]) of ``x.to(dtype) * s.to(dtype)``
    padded either way (module docstring). CPU tensors: the plain version.
    CUDA tensors: the pre-pass kernel, or raises."""
    if x.device.type == "cpu":
        return int8_prepass_plain(x, s, dtype)
    if x.device.type != "cuda":
        msg = f"int8_prepass: unsupported device {x.device}"
        raise ValueError(msg)
    return _launch_prepass(x, s, dtype)


int8_prepass.launches = 0


def _pack_weight(w_q: torch.Tensor) -> torch.Tensor:
    """The weight codes [O, C, 3, 3] in the kernel's layout: per N tile and
    32-channel slice, [tap][K half][n][16 channels], zero past O."""
    o, c = w_q.shape[:2]
    n = _tile_n(o)
    tiles = -(-o // n)
    if tiles * n != o:
        w_q = torch.cat([w_q, w_q.new_zeros((tiles * n - o, c, 3, 3))])
    return w_q.view(tiles, n, c // K_SLICE, 2, 16, 3, 3).permute(0, 2, 5, 6, 3, 1, 4).contiguous()


def _launch_conv(x, s, x_scale, w_q, w_scale, d, padding, pad_mode, dtype) -> torch.Tensor:
    where = "fused_int8_conv"
    _check_x_s(where, x, s, dtype)
    b, c, h, w = x.shape
    if w_q.dtype != torch.int8 or w_q.dim() != 4 or tuple(w_q.shape[1:]) != (c, 3, 3):
        msg = f"{where}: weight codes must be int8 [O, {c}, 3, 3], got {w_q.dtype} " \
              f"{tuple(w_q.shape)}"
        raise ValueError(msg)
    o = w_q.shape[0]
    for name, t, shape in (("x_scale", x_scale, (b,)), ("w_scale", w_scale, (o,)),
                           ("d", d, (b, o))):
        if t is not None and (t.dtype != torch.float32 or tuple(t.shape) != shape):
            msg = f"{where}: {name} must be float32 {shape}, got {t.dtype} {tuple(t.shape)}"
            raise ValueError(msg)
    _check_device(where, x, s, x_scale, w_q, w_scale, d)
    if c % K_SLICE:
        msg = f"{where}: {c} input channels (the kernel takes multiples of {K_SLICE})"
        raise ValueError(msg)
    if padding not in (0, 1) or pad_mode not in _PAD_MODES:
        msg = f"{where}: padding {padding} in mode {pad_mode!r} (the kernel takes 0 or 1, " \
              "zero or reflect)"
        raise ValueError(msg)
    reflect = int(pad_mode == "reflect" and padding == 1)
    if reflect and min(h, w) < 2:
        msg = f"{where}: reflection padding of a {h}x{w} input"
        raise ValueError(msg)
    ho, wo = h + 2 * padding - 2, w + 2 * padding - 2
    if min(ho, wo) < 1:
        msg = f"{where}: a {h}x{w} input padded by {padding} is smaller than the 3x3 kernel"
        raise ValueError(msg)
    packed = _pack_weight(w_q)
    y = torch.empty((b, o, ho, wo), dtype=dtype, device=x.device)
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.otm_int8_modconv(
            x.data_ptr(), None if s is None else s.data_ptr(), x_scale.data_ptr(),
            packed.data_ptr(), w_scale.data_ptr(), None if d is None else d.data_ptr(),
            y.data_ptr(), b, c, h, w, o, padding, reflect, _tile_n(o), _DTYPE_CODES[x.dtype],
            _DTYPE_CODES[dtype], stream)
    _raise_on(lib, err, where)
    fused_int8_conv.launches += 1
    return y


def fused_int8_conv(x: torch.Tensor, s: torch.Tensor | None, x_scale: torch.Tensor,
                    w_q: torch.Tensor, w_scale: torch.Tensor, d: torch.Tensor | None, *,
                    padding: int, pad_mode: str, dtype: torch.dtype) -> torch.Tensor:
    """The modulated, padded 3x3 conv on int8 codes at the scales
    ``x_scale``, rescaled, cast to ``dtype`` and demodulated (module
    docstring). CPU tensors: the plain version. CUDA tensors: the fused
    kernel, which takes float32 or bfloat16 contiguous inputs with C a
    multiple of 32 and padding 0 or 1; anything else raises."""
    if x.device.type == "cpu":
        return fused_int8_conv_plain(x, s, x_scale, w_q, w_scale, d, padding=padding,
                                     pad_mode=pad_mode, dtype=dtype)
    if x.device.type != "cuda":
        msg = f"fused_int8_conv: unsupported device {x.device}"
        raise ValueError(msg)
    return _launch_conv(x, s, x_scale, w_q, w_scale, d, padding, pad_mode, dtype)


fused_int8_conv.launches = 0


def modulated_int8_conv(x: torch.Tensor, s: torch.Tensor | None, w_q: torch.Tensor,
                        w_scale: torch.Tensor, d: torch.Tensor | None, *, padding: int,
                        pad_mode: str, dtype: torch.dtype) -> torch.Tensor:
    """One int8 site of the decoder: the pre-pass, then the fused conv
    (module docstring)."""
    return fused_int8_conv(x, s, int8_prepass(x, s, dtype), w_q, w_scale, d, padding=padding,
                           pad_mode=pad_mode, dtype=dtype)
