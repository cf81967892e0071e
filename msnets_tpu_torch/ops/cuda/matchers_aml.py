"""The 8-channel matching-space volume from the census planes: the NCC, ZSAD
and SAD-of-Sobel matchers, their clip normalizations and AML likelihoods, and
the volume's assembly, margins trimmed.

``matchers_aml`` takes the padded uint8 pair at the working resolution and
the two [D, H, W] float32 planes of ``census_aml`` (channels 0 and 4) and
returns the finished [8, D, H', W'] volume in ``out_dtype``, in the channel
order of ``normalize_stack``. On CUDA tensors it launches the hand-written
Hopper kernel of ``msnets_tpu_torch/csrc/matchers_aml.cu``, one launch a
sample; on CPU tensors it computes ``matchers_aml_reference``, the plain
PyTorch version, whose arithmetic the kernel repeats step by step.

No Pallas kernel stands behind it: the JAX package computes these matchers
with XLA (``msnets_tpu/ops/matchers.py``, ``msnets_tpu/ops/features.py``).
"""
from __future__ import annotations

import ctypes
import functools
import threading
from typing import List

import numpy as np
import torch

from .. import matchers as M
from . import _build

WINDOWS = (3, 5, 5)    # (nccw, sadw, sobelw), the windows the kernel is built for
_COUNT_LOCK = threading.Lock()    # servers call from several threads


def normalize_stack(cen_cost, cen_aml, c_ncc, c_sob, c_sad, ncc_sigma: float,
                    sad_sigma: float) -> List[torch.Tensor]:
    """The 8 channel planes [D, H, W] in reference order: four normalized
    costs, then four AML likelihoods (over D, dim 0). The census channels
    come normalized; the other costs raw."""
    t13 = 2.0 ** 13
    return [
        cen_cost,
        (1.0 + torch.clamp(c_ncc, -1.0, 1.0)) / 2.0,
        M._div_const(torch.clamp(c_sob, 0.0, t13), t13),
        M._div_const(torch.clamp(c_sad, 0.0, t13), t13),
        cen_aml,
        M.extract_aml(c_ncc, ncc_sigma, dim=0),
        M.extract_aml(c_sob, sad_sigma, dim=0),   # sad_sigma on purpose
        M.extract_aml(c_sad, sad_sigma, dim=0),
    ]


def trim_planes(v: torch.Tensor, board_h: int, board_w_left: int,
                board_w_right: int) -> torch.Tensor:
    """[D, H, W] -> the view without the margins: rows [board_h, H -
    board_h), cols [board_w_left, W - board_w_right)."""
    _, H, W = v.shape
    return v[:, board_h:H - board_h, board_w_left:W - board_w_right]


def matchers_aml_reference(iml: torch.Tensor, imr: torch.Tensor,
                           cen_cost: torch.Tensor, cen_aml: torch.Tensor,
                           ndisp: int, nccw: int = 3, sadw: int = 5,
                           sobelw: int = 5, ncc_sigma: float = 0.02,
                           sad_sigma: float = 20000.0, board_h: int = 0,
                           board_w_left: int = 0, board_w_right: int = 0,
                           out_dtype: torch.dtype = torch.float32
                           ) -> torch.Tensor:
    """Plain PyTorch matchers, normalizations, AMLs and assembly:
    [8, D, H', W'] in ``out_dtype``."""
    def trim(v):
        return trim_planes(v, board_h, board_w_left, board_w_right)

    c_ncc = M.ncc_nister(iml, imr, ndisp, nccw).permute(2, 0, 1)
    c_sad = M.zsad(iml, imr, ndisp, sadw).permute(2, 0, 1)
    c_sob = M.sadsob(M.sobel(iml), M.sobel(imr), ndisp, sobelw).permute(2, 0, 1)
    ch = normalize_stack(trim(cen_cost), trim(cen_aml), trim(c_ncc),
                         trim(c_sob), trim(c_sad), ncc_sigma, sad_sigma)
    return torch.stack([c.to(out_dtype) for c in ch], dim=0)


def _check(iml, imr, cen_cost, cen_aml, ndisp, windows, margins) -> None:
    """The wrapper's input checks, the same on both devices."""
    for name, t in (("iml", iml), ("imr", imr)):
        if t.dtype != torch.uint8 or t.dim() != 2:
            raise ValueError(f"matchers_aml: {name} must be uint8 [H, W], got "
                             f"{t.dtype} {tuple(t.shape)}")
    if iml.shape != imr.shape:
        raise ValueError(f"matchers_aml: iml {tuple(iml.shape)} and imr "
                         f"{tuple(imr.shape)} differ")
    H, W = iml.shape
    for name, t in (("cen_cost", cen_cost), ("cen_aml", cen_aml)):
        if t.dtype != torch.float32 or tuple(t.shape) != (ndisp, H, W):
            raise ValueError(f"matchers_aml: {name} must be float32 "
                             f"{(ndisp, H, W)}, got {t.dtype} "
                             f"{tuple(t.shape)}")
    ts = (iml, imr, cen_cost, cen_aml)
    if any(t.device != iml.device for t in ts):
        raise ValueError("matchers_aml: inputs on different devices: "
                         + ", ".join(str(t.device) for t in ts))
    if iml.device.type not in ("cpu", "cuda"):
        raise ValueError(f"matchers_aml: unsupported device {iml.device}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("matchers_aml: inputs must be contiguous")
    if ndisp < 1 or any(w % 2 != 1 or w < 1 for w in windows):
        raise ValueError(f"matchers_aml: ndisp {ndisp} and odd windows "
                         f"{windows} required")
    if min(H, W) < max(windows) - 1:
        raise ValueError(f"matchers_aml: a {H}x{W} pair is smaller than the "
                         f"matchers' windows {windows} take")
    bh, bwl, bwr = margins
    if min(margins) < 0 or H - 2 * bh < 1 or W - bwl - bwr < 1:
        raise ValueError(f"matchers_aml: margins {margins} leave nothing of "
                         f"{H}x{W}")


def _bind(lib: ctypes.CDLL):
    """``msn_matchers_aml`` of a built ``lib``, with its C signature."""
    fn = lib.msn_matchers_aml
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
                   + [ctypes.c_float] * 2 + [ctypes.c_int] * 3
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _kernel_fn():
    """``msn_matchers_aml`` of the built library."""
    return _bind(_build.load("matchers_aml"))


def _inv(sigma: float) -> float:
    return float(np.float32(1) / np.float32(sigma))


def matchers_aml(iml: torch.Tensor, imr: torch.Tensor, cen_cost: torch.Tensor,
                 cen_aml: torch.Tensor, ndisp: int, nccw: int = 3,
                 sadw: int = 5, sobelw: int = 5, ncc_sigma: float = 0.02,
                 sad_sigma: float = 20000.0, board_h: int = 0,
                 board_w_left: int = 0, board_w_right: int = 0,
                 out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The 8-channel volume [8, D, H - 2 board_h, W - board_w_left -
    board_w_right] in ``out_dtype`` from a uint8 [H, W] pair and its
    ``census_aml`` planes (cost, aml), each [D, H, W] float32.

    CPU tensors take ``matchers_aml_reference``. CUDA tensors launch the
    kernel, which takes the windows ``WINDOWS`` and float32 or bfloat16 out,
    and raise otherwise or if the launch fails; ``matchers_aml.launches``
    counts those launches (one per call)."""
    windows, margins = (nccw, sadw, sobelw), (board_h, board_w_left,
                                              board_w_right)
    _check(iml, imr, cen_cost, cen_aml, ndisp, windows, margins)
    if iml.device.type == "cpu":
        return matchers_aml_reference(iml, imr, cen_cost, cen_aml, ndisp,
                                      *windows, ncc_sigma, sad_sigma,
                                      *margins, out_dtype)
    if windows != WINDOWS:
        raise ValueError(f"matchers_aml: the kernel takes windows {WINDOWS} "
                         f"(nccw, sadw, sobelw), got {windows}")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"matchers_aml: out_dtype float32 or bfloat16, got "
                         f"{out_dtype}")
    H, W = iml.shape
    fn = _kernel_fn()
    with torch.cuda.device(iml.device):
        out = torch.empty((8, ndisp, H - 2 * board_h,
                           W - board_w_left - board_w_right),
                          dtype=out_dtype, device=iml.device)
        stream = torch.cuda.current_stream(iml.device).cuda_stream
        err = fn(iml.data_ptr(), imr.data_ptr(), cen_cost.data_ptr(),
                 cen_aml.data_ptr(), out.data_ptr(),
                 int(out_dtype == torch.bfloat16), H, W, ndisp, *windows,
                 _inv(ncc_sigma), _inv(sad_sigma), *margins, stream)
    if err != 0:
        raise RuntimeError(f"matchers_aml kernel launch failed: CUDA error "
                           f"{err} (H={H}, W={W}, ndisp={ndisp})")
    with _COUNT_LOCK:
        matchers_aml.launches += 1
    return out


matchers_aml.launches = 0
