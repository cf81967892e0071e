"""Fused census cost + AML channels (port of
``msnets_tpu/ops/pallas/census_aml_pallas.py:census_aml_pallas``).

``census_aml`` computes channels 0 and 4 of the matching-space feature
volume from a uint8 pair: the normalized census cost ``clip(c, 0, 120)/120``
and its AML likelihood ``extract_aml(c, sigma)`` over disparity. On CUDA
tensors it launches the hand-written Hopper kernel of
``msnets_tpu_torch/csrc/census_aml.cu``; on CPU tensors it computes
``census_aml_reference``, the plain PyTorch version of the same function.

Both return [D, H, W] float32 planes (disparity-major), which is the kernel's
own output layout and the [C, D, H, W] plane order of the feature volume;
the JAX function returns the same values as [H, W, D].
"""
from __future__ import annotations

import ctypes
import functools
import threading
from typing import Tuple

import torch

from .. import matchers as M
from . import _build

_MAX_WSIZE = 11    # 121 census bits fill the kernel's 4 x 32-bit descriptor
_COUNT_LOCK = threading.Lock()    # servers call from several threads


def census_aml_reference(iml: torch.Tensor, imr: torch.Tensor, ndisp: int,
                         wsize: int = 11, sigma: float = 128.0
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch census + clip + AML, each [D, H, W] float32."""
    c = M.census(iml, imr, ndisp, wsize).permute(2, 0, 1)
    cost = M._div(torch.clamp(c, 0.0, 120.0), 120.0)
    aml = M.extract_aml(c, sigma, dim=0)
    return cost.contiguous(), aml.contiguous()


def _check(iml: torch.Tensor, imr: torch.Tensor, ndisp: int, wsize: int):
    for name, t in (("iml", iml), ("imr", imr)):
        if t.dtype != torch.uint8:
            raise TypeError(f"census_aml: {name} must be uint8, got {t.dtype}")
        if t.dim() != 2:
            raise ValueError(f"census_aml: {name} must be [H, W], got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"census_aml: {name} must be contiguous")
    if iml.shape != imr.shape or iml.device != imr.device:
        raise ValueError("census_aml: iml and imr differ in shape or device: "
                         f"{tuple(iml.shape)}@{iml.device} vs "
                         f"{tuple(imr.shape)}@{imr.device}")
    if min(iml.shape) < 1 or ndisp < 1:
        raise ValueError(f"census_aml: empty input {tuple(iml.shape)}, "
                         f"ndisp={ndisp}")
    if wsize % 2 != 1 or not 1 <= wsize <= _MAX_WSIZE:
        raise ValueError(f"census_aml: wsize must be odd and <= {_MAX_WSIZE}")


@functools.cache
def _kernel_fn():
    """``msn_census_aml`` of the built library, with its C signature."""
    fn = _build.load("census_aml").msn_census_aml
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def census_aml(iml: torch.Tensor, imr: torch.Tensor, ndisp: int,
               wsize: int = 11, sigma: float = 128.0
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cost, aml), each [D, H, W] float32, from a uint8 [H, W] pair.

    CPU tensors take ``census_aml_reference``. CUDA tensors launch the
    kernel and raise if the launch fails; ``census_aml.launches`` counts
    those launches (one per call)."""
    _check(iml, imr, ndisp, wsize)
    if iml.device.type == "cpu":
        return census_aml_reference(iml, imr, ndisp, wsize, sigma)
    if iml.device.type != "cuda":
        raise ValueError(f"census_aml: unsupported device {iml.device}")
    H, W = iml.shape
    fn = _kernel_fn()
    with torch.cuda.device(iml.device):
        dl = torch.empty((H, W, 4), dtype=torch.int32, device=iml.device)
        dr = torch.empty_like(dl)
        cost = torch.empty((ndisp, H, W), dtype=torch.float32,
                           device=iml.device)
        aml = torch.empty_like(cost)
        stream = torch.cuda.current_stream(iml.device).cuda_stream
        err = fn(iml.data_ptr(), imr.data_ptr(), dl.data_ptr(),
                 dr.data_ptr(), cost.data_ptr(), aml.data_ptr(),
                 H, W, ndisp, wsize, sigma, stream)
    if err != 0:
        raise RuntimeError(f"census_aml kernel launch failed: CUDA error "
                           f"{err} (H={H}, W={W}, ndisp={ndisp})")
    with _COUNT_LOCK:
        census_aml.launches += 1
    return cost, aml


census_aml.launches = 0
