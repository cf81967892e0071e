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

import numpy as np
import torch

from .. import matchers as M
from . import _build
from .census import check_pair

_COUNT_LOCK = threading.Lock()    # servers call from several threads


def census_aml_reference(iml: torch.Tensor, imr: torch.Tensor, ndisp: int,
                         wsize: int = 11, sigma: float = 128.0
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch census + clip + AML, each [D, H, W] float32."""
    c = M.census(iml, imr, ndisp, wsize).permute(2, 0, 1)
    cost = M._div_const(torch.clamp(c, 0.0, 120.0), 120.0)
    aml = M.extract_aml(c, sigma, dim=0)
    return cost.contiguous(), aml.contiguous()


def _bind(lib: ctypes.CDLL):
    """``msn_census_aml`` of a built ``lib``, with its C signature."""
    fn = lib.msn_census_aml
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _kernel_fn():
    """``msn_census_aml`` of the built library."""
    return _bind(_build.load("census_aml"))


def census_aml(iml: torch.Tensor, imr: torch.Tensor, ndisp: int,
               wsize: int = 11, sigma: float = 128.0
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cost, aml), each [D, H, W] float32, from a uint8 [H, W] pair.

    CPU tensors take ``census_aml_reference``. CUDA tensors launch the
    kernel and raise if the launch fails; ``census_aml.launches`` counts
    those launches (one per call)."""
    check_pair("census_aml", iml, imr, ndisp, wsize)
    if iml.device.type == "cpu":
        return census_aml_reference(iml, imr, ndisp, wsize, sigma)
    H, W = iml.shape
    fn = _kernel_fn()
    with torch.cuda.device(iml.device):
        cost = torch.empty((ndisp, H, W), dtype=torch.float32,
                           device=iml.device)
        aml = torch.empty_like(cost)
        stream = torch.cuda.current_stream(iml.device).cuda_stream
        err = fn(iml.data_ptr(), imr.data_ptr(), cost.data_ptr(),
                 aml.data_ptr(), H, W, ndisp, wsize,
                 float(np.float32(1) / np.float32(sigma)), stream)
    if err != 0:
        raise RuntimeError(f"census_aml kernel launch failed: CUDA error "
                           f"{err} (H={H}, W={W}, ndisp={ndisp})")
    with _COUNT_LOCK:
        census_aml.launches += 1
    return cost, aml


census_aml.launches = 0
