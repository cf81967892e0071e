"""MS-GCNet's serving head in one pass: deconv5, the softmax over D and the
soft-argmin, without the full-resolution logit volume (port of the XLA math
of ``msnets_tpu/models/layers.py:SubpixelSoftArgminHead``; no Pallas
kernel).

``subpixel_soft_argmin(x, weight, stride, max_disp)`` is

    disp[n, h, w] = sum_d d * softmax_d(L[n, d, h, w])
    L = conv_transpose3d(x, weight, None, stride, padding=1,
                         output_padding=stride - 1)[:, 0]

for

  x       the decoder's activation ``[N, C, D, H, W]``, NDHWC
          (``torch.channels_last_3d``), bfloat16 or float32;
  weight  deconv5's kernel ``[C, 1, 3, 3, 3]``, float32;
  stride  2, or 4 with ``quarter_input``; ``stride * D == max_disp``;

and returns float32 ``[N, stride * H, stride * W]``. deconv5's bias is
left out: it shifts every logit alike and cancels in the softmax.

Phase taps: along each axis, output o = s*i + k - 1 takes tap k of input i,
so output phase r (o = s*m + r) sums the taps k with (r + 1 - k) % s == 0
at input m + (r + 1 - k) // s (``_deconv_phase_taps`` of the JAX package,
there with the kernel stored flipped). Tap 1 feeds phase 0, tap 2 phase 1,
both from input m; tap 0 feeds phase s - 1 from input m + 1; with s = 4,
phase 2 takes no tap and its logits are 0.

CPU tensors take ``subpixel_soft_argmin_reference``, the plain PyTorch
version of the same phase-tap arithmetic. CUDA tensors launch the
hand-written Hopper kernel of ``msnets_tpu_torch/csrc/
subpixel_soft_argmin.cu`` or raise; ``subpixel_soft_argmin.launches``
counts the launches (one a call). ``fits(x)`` says whether the kernel's
plan takes ``x``'s channels; ``MSGCNet.head`` sends any other width to
deconv5 as a conv, on either device.
"""
from __future__ import annotations

import ctypes
import functools
import threading

import torch
import torch.nn.functional as F

from . import _build

_COUNT_LOCK = threading.Lock()    # servers call from several threads
_DTYPES = {torch.bfloat16: 0, torch.float32: 1}
STRIDES = (2, 4)
MAX_CHANNELS = 64                 # the kernel's shared-memory plan


def fits(x: torch.Tensor) -> bool:
    """Whether the kernel's plan takes ``x`` [N, C, D, H, W]: bfloat16 or
    float32, C whole 16-byte copies of that dtype and at most
    ``MAX_CHANNELS``."""
    return (x.dtype in _DTYPES and x.shape[1] <= MAX_CHANNELS
            and x.shape[1] % (16 // x.element_size()) == 0)


def phase_taps(stride: int):
    """Per output phase r of one axis, the (tap k, input offset) pairs that
    feed it."""
    return [[(k, (r + 1 - k) // stride) for k in range(3)
             if (r + 1 - k) % stride == 0] for r in range(stride)]


def subpixel_soft_argmin_reference(x: torch.Tensor, weight: torch.Tensor,
                                   stride: int) -> torch.Tensor:
    """Plain PyTorch head in float32 (float64, with a float64 result, for
    a float64 ``x``): the 27 tap projections of each input voxel, the
    logits of each output phase as sums of shifted projections, the softmax
    statistics of each spatial phase over its s depth phases, and the s*s
    disparity maps interleaved. ``x`` in any layout."""
    ct = torch.float64 if x.dtype == torch.float64 else torch.float32
    N, C, D, H, W = x.shape
    s = stride
    taps = phase_taps(s)
    proj = x.to(ct).permute(0, 2, 3, 4, 1) @ weight.to(ct).reshape(C, 27)
    proj = F.pad(proj, (0, 0, 0, 1, 0, 1, 0, 1))   # off = 1 reads 0 past the edge

    def logits(pz, ph, pw):
        acc = torch.zeros((N, D, H, W), dtype=ct, device=x.device)
        for kz, oz in taps[pz]:
            for ky, oy in taps[ph]:
                for kx, ox in taps[pw]:
                    acc = acc + proj[:, oz:oz + D, oy:oy + H, ox:ox + W,
                                     (kz * 3 + ky) * 3 + kx]
        return acc

    d = torch.arange(s * D, dtype=ct, device=x.device).view(1, -1, 1, 1)
    maps = []
    for ph in range(s):
        for pw in range(s):
            lg = torch.stack([logits(pz, ph, pw) for pz in range(s)], 2)
            lg = lg.reshape(N, s * D, H, W)          # depth s*j + pz
            e = torch.exp(lg - lg.amax(1, keepdim=True))
            maps.append((e * d).sum(1) / e.sum(1))
    # [ph, pw, N, H, W] -> [N, H, ph, W, pw]
    grid = torch.stack(maps).view(s, s, N, H, W).permute(2, 3, 0, 4, 1)
    return grid.reshape(N, s * H, s * W)


def _check(x: torch.Tensor, weight: torch.Tensor, stride: int,
           max_disp: int) -> None:
    if x.device != weight.device or x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"subpixel_soft_argmin: x and weight must be on one "
                         f"CPU or CUDA device, got {x.device} and "
                         f"{weight.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"subpixel_soft_argmin: x must be bfloat16 or "
                        f"float32, got {x.dtype}")
    if weight.dtype != torch.float32:
        raise TypeError(f"subpixel_soft_argmin: weight must be float32, got "
                        f"{weight.dtype}")
    if x.dim() != 5 or x.numel() == 0:
        raise ValueError(f"subpixel_soft_argmin: x must be a non-empty [N, C, "
                         f"D, H, W], got {tuple(x.shape)}")
    if tuple(weight.shape) != (x.shape[1], 1, 3, 3, 3):
        raise ValueError(f"subpixel_soft_argmin: weight must be [{x.shape[1]}"
                         f", 1, 3, 3, 3], got {tuple(weight.shape)}")
    if not x.is_contiguous(memory_format=torch.channels_last_3d):
        raise ValueError("subpixel_soft_argmin: x must be dense NDHWC "
                         "(torch.channels_last_3d)")
    if stride not in STRIDES:
        raise ValueError(f"subpixel_soft_argmin: stride must be one of "
                         f"{STRIDES}, got {stride}")
    if stride * x.shape[2] != max_disp:
        raise ValueError(f"subpixel_soft_argmin: {stride * x.shape[2]} output "
                         f"disparities != max_disp {max_disp}")


def _bind(lib: ctypes.CDLL):
    """``msn_subpixel_soft_argmin`` of a built ``lib``, with its C
    signature."""
    fn = lib.msn_subpixel_soft_argmin
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _kernel_fn():
    return _bind(_build.load("subpixel_soft_argmin"))


def subpixel_soft_argmin(x: torch.Tensor, weight: torch.Tensor, stride: int,
                         max_disp: int) -> torch.Tensor:
    """The disparity ``[N, stride*H, stride*W]`` (float32) of deconv5's
    logits (module docstring); raises on what the kernel does not take."""
    _check(x, weight, stride, max_disp)
    if x.device.type == "cpu":
        return subpixel_soft_argmin_reference(x, weight, stride)
    N, C, D, H, W = x.shape
    if not fits(x) or x.data_ptr() % 16:
        raise ValueError(f"subpixel_soft_argmin: the kernel takes a multiple "
                         f"of {16 // x.element_size()} channels up to "
                         f"{MAX_CHANNELS} in {x.dtype} at a 16-byte aligned "
                         f"address, got {C} at {x.data_ptr():#x}")
    w = weight.contiguous()
    fn = _kernel_fn()
    with torch.cuda.device(x.device):
        out = torch.empty((N, stride * H, stride * W), dtype=torch.float32,
                          device=x.device)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(), _DTYPES[x.dtype],
                 N, C, D, H, W, stride, stream)
    if err != 0:
        raise RuntimeError(f"subpixel_soft_argmin kernel launch failed: CUDA "
                           f"error {err} (x {tuple(x.shape)} {x.dtype}, "
                           f"stride {stride})")
    with _COUNT_LOCK:
        subpixel_soft_argmin.launches += 1
    return out


subpixel_soft_argmin.launches = 0
