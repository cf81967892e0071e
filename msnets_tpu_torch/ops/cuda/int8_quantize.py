"""Symmetric int8 quantization of an int8 conv's input, written channels
last for the conv kernel (``ops/cuda/int8_conv3d.py``), and the per-sample
max-abs that the dynamic scale is taken from.

Both replace the JAX package's ``_quant_act`` (``msnets_tpu/models/
layers.py:89``, computed by XLA, not Pallas) and the transpose that the
int8 conv needs; on the card they are the two kernels of
``msnets_tpu_torch/csrc/int8_quantize.cu``.

``int8_absmax(x)``: float32 ``[N]``, each sample's ``max(|float32(x)|)``
over every dim but the first of a contiguous ``[N, ...]`` float32 or
bfloat16 tensor (a sample holding a NaN gives a NaN). CPU tensors take
``int8_absmax_reference`` (one ``torch.aminmax`` pass); CUDA tensors
launch the kernel, or raise. ``int8_absmax.launches`` counts the launches.

``int8_quantize(x, scale)``:

  x      ``[N, C, D, H, W]`` in the compute dtype (float32 or bfloat16);
  scale  float32, one value a sample (``[N]`` or any shape of N values) or
         one in all;

returns int8 ``[N, D, H, W, Cp]``, ``Cp = padded_channels(C)``: channel c <
C is ``round(float32(x) / scale)`` (half to even, a true division) clamped
to +-127, as JAX's ``round(xf / scale)``; the channels past C are zeros.
CPU tensors take ``int8_quantize_reference``; CUDA tensors launch the
kernel, or raise. ``int8_quantize.launches`` counts the launches.
"""
from __future__ import annotations

import ctypes
import functools
import threading

import torch
import torch.nn.functional as F

from . import _build
from .int8_conv3d import padded_channels

_COUNT_LOCK = threading.Lock()    # servers call from several threads
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _check(x: torch.Tensor, scale: torch.Tensor) -> None:
    if x.dtype not in _DTYPES:
        raise TypeError(f"int8_quantize: x must be float32 or bfloat16, got "
                        f"{x.dtype}")
    if x.dim() != 5 or x.numel() == 0:
        raise ValueError(f"int8_quantize: x must be a non-empty [N, C, D, H, "
                         f"W], got {tuple(x.shape)}")
    if x.shape[1] > 128:
        raise ValueError(f"int8_quantize: the int8 conv takes at most 128 "
                         f"channels, got {x.shape[1]}")
    if scale.dtype != torch.float32:
        raise TypeError(f"int8_quantize: scale must be float32, got "
                        f"{scale.dtype}")
    if scale.numel() not in (1, x.shape[0]):
        raise ValueError(f"int8_quantize: scale has {scale.numel()} values "
                         f"for {x.shape[0]} samples")
    if x.device != scale.device or x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"int8_quantize: x on {x.device}, scale on "
                         f"{scale.device}")


def quantize_values(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``round(float32(x) / scale)`` clamped to +-127 as int8, in x's
    layout (JAX ``_quant_act``'s arithmetic); ``scale`` holds one value a
    sample or one in all."""
    s = scale.reshape((-1,) + (1,) * (x.dim() - 1))
    return torch.round(x.float() / s).clamp_(-127, 127).to(torch.int8)


def int8_quantize_reference(x: torch.Tensor,
                            scale: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: ``quantize_values`` moved channels last and
    zero-padded."""
    _check(x, scale)
    c = x.shape[1]
    return F.pad(quantize_values(x, scale).permute(0, 2, 3, 4, 1),
                 (0, padded_channels(c) - c)).contiguous()


def _bind(lib: ctypes.CDLL):
    """``msn_int8_quantize`` of a built ``lib``, with its C signature."""
    fn = lib.msn_int8_quantize
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, i, p] + [i] * 7 + [p]
    fn.restype = ctypes.c_int
    return fn


def _bind_absmax(lib: ctypes.CDLL):
    """``msn_int8_absmax`` of a built ``lib``, with its C signature."""
    fn = lib.msn_int8_absmax
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, i, i, ctypes.c_longlong, p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _kernel_fn():
    return _bind(_build.load("int8_quantize"))


@functools.cache
def _absmax_fn():
    return _bind_absmax(_build.load("int8_quantize"))


def _check_absmax(x: torch.Tensor) -> None:
    if x.dtype not in _DTYPES:
        raise TypeError(f"int8_absmax: x must be float32 or bfloat16, got "
                        f"{x.dtype}")
    if x.dim() == 0 or x.numel() == 0:
        raise ValueError(f"int8_absmax: x must be a non-empty [N, ...], got "
                         f"{tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("int8_absmax: x must be contiguous")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"int8_absmax: x on {x.device}; the kernel takes "
                         f"CUDA tensors, its plain version CPU ones")
    if x.shape[0] > 65535:
        raise ValueError(f"int8_absmax: at most 65535 samples, got "
                         f"{x.shape[0]}")


def int8_absmax_reference(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: ``max(-min, max)`` of one ``aminmax`` pass in
    x's dtype, equal to ``x.float().abs().amax(every dim but the first)``
    bit for bit (negation and widening to float32 are exact; ``abs`` makes
    a zero positive)."""
    _check_absmax(x)
    lo, hi = torch.aminmax(x.reshape(x.shape[0], -1), dim=1)
    return torch.maximum(-lo.float(), hi.float()).abs()


def int8_absmax(x: torch.Tensor) -> torch.Tensor:
    """Float32 ``[N]``, each sample's max-abs of ``x`` (``[N, ...]``): the
    kernel on CUDA tensors, ``int8_absmax_reference`` on CPU tensors."""
    _check_absmax(x)
    if x.device.type == "cpu":
        return int8_absmax_reference(x)
    fn = _absmax_fn()
    n = x.shape[0]
    with torch.cuda.device(x.device):
        out = torch.empty(n, dtype=torch.float32, device=x.device)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), out.data_ptr(), _DTYPES[x.dtype], n,
                 x.numel() // n, stream)
    if err != 0:
        raise RuntimeError(f"int8_absmax kernel launch failed: CUDA error "
                           f"{err} (x {tuple(x.shape)} {x.dtype})")
    with _COUNT_LOCK:
        int8_absmax.launches += 1
    return out


def int8_quantize(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """int8 ``[N, D, H, W, Cp]`` of ``x`` (``[N, C, D, H, W]``) at
    ``scale``: the kernel on CUDA tensors, ``int8_quantize_reference`` on
    CPU tensors."""
    _check(x, scale)
    if x.device.type == "cpu":
        return int8_quantize_reference(x, scale)
    N, C, D, H, W = x.shape
    x = x.contiguous()
    s = scale.reshape(-1).contiguous()
    fn = _kernel_fn()
    with torch.cuda.device(x.device):
        out = torch.empty((N, D, H, W, padded_channels(C)), dtype=torch.int8,
                          device=x.device)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), s.data_ptr(), int(s.numel() > 1),
                 out.data_ptr(), _DTYPES[x.dtype], N, C, D, H, W,
                 out.shape[-1], stream)
    if err != 0:
        raise RuntimeError(f"int8_quantize kernel launch failed: CUDA error "
                           f"{err} (x {tuple(x.shape)} {x.dtype})")
    with _COUNT_LOCK:
        int8_quantize.launches += 1
    return out


int8_quantize.launches = 0
int8_absmax.launches = 0
