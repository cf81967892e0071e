"""Exact int8 x int8 -> int32 3-D convolution for the port's int8 eval
(``models/quant.py``), raw or with its dequantization fused.

It replaces the XLA int8 convolutions of the JAX package's quantized
lowerings (``msnets_tpu/models/layers.py:218-272, 333-381, 483-540``: 2-D
convolutions of packed int8 tensors under ``preferred_element_type=
jnp.int32``, summed over the depth taps), whose integer sums equal one
k3 3-D convolution of the same int8 values. The JAX package has no Pallas
kernel here; on the card it is ``msnets_tpu_torch/csrc/int8_conv3d.cu``, an
implicit GEMM on the int8 tensor cores.

``int8_conv3d(xq, wq, stride, padding)``, the raw sums:

  xq       int8 ``[N, D, H, W, Cin]`` (channels last), contiguous;
  wq       int8 ``[Cout, 3, 3, 3, Cin]``, contiguous;
  stride   1 or 2 on every dim;
  padding  ``(pd, ph, pw)``, each 0 or 1 (``parallel/halo.py`` runs the
           conv on halo-extended windows with no padding along the dims a
           mesh splits);

returns int32 ``[N, Cout, D', H', W']`` with ``D' = (D + 2 pd - 3) //
stride + 1`` (likewise H', W'). The kernel takes the channels zero-padded
to 32, 64 or 128 (``padded_channels``; at most 128, as its whole kernel
stays in shared memory) and the weights in the layout of
``pack_weights``; this call pads both itself.

``int8_conv3d_dequant(xq, wp, sx, sk, bias, stride, padding, dtype)``, the
fused form the int8 eval runs: ``xq`` as ``int8_quantize`` writes it (the
channels padded), ``wp = pack_weights(wq)`` made once, and the output
``dequantize_reference(sums, sx, sk, bias, dtype)`` in ``dtype``.

CPU tensors take the plain versions (``int8_conv3d_reference``: ``F.conv3d``
in float64, exact because every product is at most 127^2 and every sum of
them lies far below 2^53; ``int8_conv3d_dequant_reference``). CUDA tensors
launch the kernel, or raise; ``int8_conv3d.launches`` counts its launches
in either mode.
"""
from __future__ import annotations

import ctypes
import functools
import threading
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from . import _build

_COUNT_LOCK = threading.Lock()    # servers call from several threads
MAX_CHANNELS = 128                # input channels the kernel takes
_MODES = {None: 0, torch.float32: 1, torch.bfloat16: 2}


def padded_channels(c: int) -> int:
    """The channels the kernel takes for ``c``: 32, 64 or 128 (1, 2 or 4
    of its k32 steps)."""
    return 32 if c <= 32 else 64 if c <= 64 else -(-c // 128) * 128


def _cout_block(cout: int) -> int:
    """Output channels a block of the kernel owns: 32, or 64 past 32."""
    return 32 if cout <= 32 else 64


def pack_weights(wq: torch.Tensor) -> torch.Tensor:
    """An int8 kernel ``[Cout, 3, 3, 3, Cin]`` in the kernel's layout: int8
    ``[Cout_pad, 27, Cp]``, the channels zero-padded to ``padded_channels``
    and the output channels to a multiple of the block's 32 or 64."""
    if wq.dtype != torch.int8 or wq.dim() != 5 or tuple(wq.shape[1:4]) != (
            3, 3, 3):
        raise ValueError(f"pack_weights: int8 [Cout, 3, 3, 3, Cin] expected, "
                         f"got {wq.dtype} {tuple(wq.shape)}")
    cout, cin = wq.shape[0], wq.shape[4]
    blk = _cout_block(cout)
    w = wq.reshape(cout, 27, cin)
    return F.pad(w, (0, padded_channels(cin) - cin, 0, 0,
                     0, -(-cout // blk) * blk - cout)).contiguous()


def _unpack(wp: torch.Tensor, cout: int) -> torch.Tensor:
    """``pack_weights``' inverse, with the padded channels kept:
    ``[Cout, 3, 3, 3, Cp]``."""
    return wp[:cout].reshape(cout, 3, 3, 3, wp.shape[2])


def _out_dims(dhw: Sequence[int], stride: int,
              padding: Sequence[int]) -> Tuple[int, int, int]:
    return tuple((n + 2 * p - 3) // stride + 1 for n, p in zip(dhw, padding))


def _check_x(xq: torch.Tensor, stride: int, padding: Sequence[int],
             name: str = "int8_conv3d") -> Tuple[int, int, int]:
    if xq.dtype != torch.int8:
        raise TypeError(f"{name}: xq must be int8, got {xq.dtype}")
    if xq.dim() != 5:
        raise ValueError(f"{name}: xq must be 5-D, got {tuple(xq.shape)}")
    if not xq.is_contiguous():
        raise ValueError(f"{name}: xq must be contiguous")
    if xq.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: xq on {xq.device}")
    if stride not in (1, 2) or len(padding) != 3 or any(
            p not in (0, 1) for p in padding):
        raise ValueError(f"{name}: stride {stride} padding {padding}: "
                         "stride 1 or 2, padding 0 or 1 per dim")
    if xq.shape[4] > MAX_CHANNELS:
        raise ValueError(f"{name}: {xq.shape[4]} input channels, at most "
                         f"{MAX_CHANNELS}")
    dims = _out_dims(xq.shape[1:4], stride, padding)
    if min(dims) < 1 or xq.numel() == 0:
        raise ValueError(f"{name}: empty output for {tuple(xq.shape)}")
    return dims


def _check(xq: torch.Tensor, wq: torch.Tensor, stride: int,
           padding: Sequence[int]) -> Tuple[int, int, int]:
    if wq.dtype != torch.int8:
        raise TypeError(f"int8_conv3d: wq must be int8, got {wq.dtype}")
    if wq.dim() != 5 or not wq.is_contiguous():
        raise ValueError(f"int8_conv3d: wq must be 5-D and contiguous, got "
                         f"{tuple(wq.shape)}")
    dims = _check_x(xq, stride, padding)
    if tuple(wq.shape[1:4]) != (3, 3, 3) or wq.shape[4] != xq.shape[4]:
        raise ValueError(f"int8_conv3d: kernel {tuple(wq.shape)} is not "
                         f"[Cout, 3, 3, 3, {xq.shape[4]}]")
    if xq.device != wq.device:
        raise ValueError(f"int8_conv3d: xq on {xq.device}, wq on {wq.device}")
    return dims


def int8_conv3d_reference(xq: torch.Tensor, wq: torch.Tensor, stride: int,
                          padding: Sequence[int] = (1, 1, 1)) -> torch.Tensor:
    """Plain PyTorch version: ``F.conv3d`` of the int8 values in float64,
    which is exact, as int32 ``[N, Cout, D', H', W']``."""
    _check(xq, wq, stride, padding)
    acc = F.conv3d(xq.permute(0, 4, 1, 2, 3).double(),
                   wq.permute(0, 4, 1, 2, 3).double(), None, stride,
                   tuple(padding))
    return acc.round().to(torch.int32)


def dequantize_reference(acc: torch.Tensor, sx: torch.Tensor,
                         sk: torch.Tensor, bias: torch.Tensor,
                         dtype: torch.dtype) -> torch.Tensor:
    """``(float32(acc) * (sx * sk)).to(dtype) + bias.to(dtype)``, JAX's
    order (the scale product first, the bias in the compute dtype); ``sx``
    holds one scale a sample or one in all."""
    c = (1, -1, 1, 1, 1)
    y = (acc.float() * (sx.reshape(-1, 1, 1, 1, 1) * sk.view(c))).to(dtype)
    return y + bias.to(dtype).view(c)


def _check_fused(xq, wp, sx, sk, bias, stride, padding, dtype):
    dims = _check_x(xq, stride, padding, "int8_conv3d_dequant")
    cout, cp = sk.numel(), xq.shape[4]
    if wp.dtype != torch.int8 or wp.dim() != 3 or not wp.is_contiguous():
        raise TypeError("int8_conv3d_dequant: wp must be pack_weights' "
                        f"int8 [Cout_pad, 27, Cp], got {wp.dtype} "
                        f"{tuple(wp.shape)}")
    blk = _cout_block(cout)
    if (cp != padded_channels(cp) or tuple(wp.shape[1:]) != (27, cp)
            or wp.shape[0] < cout or wp.shape[0] % blk):
        raise ValueError(f"int8_conv3d_dequant: xq {tuple(xq.shape)} and wp "
                         f"{tuple(wp.shape)} for {cout} output channels: "
                         "channels padded to 32, 64 or 128, wp from "
                         "pack_weights")
    for name, t, n in (("sx", sx, None), ("sk", sk, cout),
                       ("bias", bias, cout)):
        if t.dtype != torch.float32:
            raise TypeError(f"int8_conv3d_dequant: {name} must be float32, "
                            f"got {t.dtype}")
        if n is not None and tuple(t.shape) != (n,):
            raise ValueError(f"int8_conv3d_dequant: {name} {tuple(t.shape)}")
    if sx.numel() not in (1, xq.shape[0]):
        raise ValueError(f"int8_conv3d_dequant: sx has {sx.numel()} values "
                         f"for {xq.shape[0]} samples")
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"int8_conv3d_dequant: dtype {dtype}")
    devices = {t.device for t in (xq, wp, sx, sk, bias)}
    if len(devices) != 1:
        raise ValueError(f"int8_conv3d_dequant: tensors on {devices}")
    return dims


def int8_conv3d_dequant_reference(xq, wp, sx, sk, bias, stride: int,
                                  padding: Sequence[int],
                                  dtype: torch.dtype) -> torch.Tensor:
    """Plain PyTorch version of the fused conv: ``dequantize_reference``
    of ``int8_conv3d_reference``."""
    _check_fused(xq, wp, sx, sk, bias, stride, padding, dtype)
    acc = int8_conv3d_reference(xq, _unpack(wp, sk.numel()), stride, padding)
    return dequantize_reference(acc, sx, sk, bias, dtype)


def _bind(lib: ctypes.CDLL):
    """``msn_int8_conv3d`` of a built ``lib``, with its C signature."""
    fn = lib.msn_int8_conv3d
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, p, i, p, p] + [i] * 15 + [p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _kernel_fn():
    return _bind(_build.load("int8_conv3d"))


def _launch(xq, wp, cout, dims, stride, padding, dtype, sx=None, sk=None,
            bias=None) -> torch.Tensor:
    N, D, H, W, cp = xq.shape
    out = torch.empty((N, cout) + tuple(dims), device=xq.device,
                      dtype=torch.int32 if dtype is None else dtype)
    ptr = (lambda t: None if t is None else t.data_ptr())    # noqa: E731
    fn = _kernel_fn()
    with torch.cuda.device(xq.device):
        stream = torch.cuda.current_stream(xq.device).cuda_stream
        err = fn(xq.data_ptr(), wp.data_ptr(), out.data_ptr(), ptr(sx),
                 int(sx is not None and sx.numel() > 1), ptr(sk), ptr(bias),
                 _MODES[dtype], N, D, H, W, cp, cout, wp.shape[0], *dims,
                 stride, *padding, stream)
    if err != 0:
        raise RuntimeError(f"int8_conv3d kernel launch failed: CUDA error "
                           f"{err} (x {tuple(xq.shape)}, cout {cout}, "
                           f"stride {stride}, padding {tuple(padding)}, "
                           f"out {dtype})")
    with _COUNT_LOCK:
        int8_conv3d.launches += 1
    return out


def _aligned(t: torch.Tensor) -> torch.Tensor:
    return t if t.data_ptr() % 16 == 0 else t.clone()


def int8_conv3d(xq: torch.Tensor, wq: torch.Tensor, stride: int,
                padding: Sequence[int] = (1, 1, 1)) -> torch.Tensor:
    """int32 ``[N, Cout, D', H', W']`` sums of ``xq`` (int8 ``[N, D, H, W,
    Cin]``) under ``wq`` (int8 ``[Cout, 3, 3, 3, Cin]``): the kernel on
    CUDA tensors, ``int8_conv3d_reference`` on CPU tensors."""
    dims = _check(xq, wq, stride, padding)
    if xq.device.type == "cpu":
        return int8_conv3d_reference(xq, wq, stride, padding)
    cin = xq.shape[4]
    pad = padded_channels(cin) - cin
    x = F.pad(xq, (0, pad)) if pad else xq
    return _launch(_aligned(x), pack_weights(wq), wq.shape[0], dims, stride,
                   padding, None)


def int8_conv3d_dequant(xq: torch.Tensor, wp: torch.Tensor, sx: torch.Tensor,
                        sk: torch.Tensor, bias: torch.Tensor, stride: int,
                        padding: Sequence[int], dtype: torch.dtype
                        ) -> torch.Tensor:
    """The int8 conv with its dequantization fused: ``dtype`` ``[N, Cout,
    D', H', W']`` equal to ``dequantize_reference(int8 sums, sx, sk, bias,
    dtype)``. ``xq``: int8 ``[N, D, H, W, Cp]``, Cp 32, 64 or 128
    (``int8_quantize``'s output); ``wp``: ``pack_weights`` of the int8
    kernel; ``sx``: float32, one value a sample or one in all; ``sk`` and
    ``bias``: float32 ``[Cout]``. The kernel on CUDA tensors, the plain
    version on CPU tensors."""
    dims = _check_fused(xq, wp, sx, sk, bias, stride, padding, dtype)
    if xq.device.type == "cpu":
        return int8_conv3d_dequant_reference(xq, wp, sx, sk, bias, stride,
                                             padding, dtype)
    return _launch(_aligned(xq), _aligned(wp), sk.numel(), dims, stride,
                   padding, dtype, sx.reshape(-1).contiguous(),
                   sk.contiguous(), bias.contiguous())


int8_conv3d.launches = 0
