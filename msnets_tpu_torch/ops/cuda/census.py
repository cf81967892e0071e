"""Census Hamming cost volume (port of
``msnets_tpu/ops/pallas/census_pallas.py:census_pallas``).

``census`` computes the raw census cost volume of a uint8 pair: the Hamming
distance of the packed census descriptors, float32, with ``INVALID`` outside
the reference valid region. The 16-channel feature stage needs it raw, to
re-index it to the right view before normalizing. On CUDA tensors it
launches the hand-written Hopper kernel of ``msnets_tpu_torch/csrc/census.cu``;
on CPU tensors it computes ``census_reference``, the plain PyTorch version.

Both return [D, H, W] float32 (disparity-major, the kernel's own layout);
the JAX function returns the same values as [H, W, D].
"""
from __future__ import annotations

import ctypes
import functools
import threading

import torch

from .. import matchers as M
from . import _build

MAX_WSIZE = 11     # 121 census bits fill the kernels' 4 x 32-bit descriptor
_COUNT_LOCK = threading.Lock()    # servers call from several threads


def check_pair(fn: str, iml: torch.Tensor, imr: torch.Tensor, ndisp: int,
               wsize: int) -> None:
    """The input checks of the census kernels' wrappers (``fn`` names the
    wrapper in the message)."""
    for name, t in (("iml", iml), ("imr", imr)):
        if t.dtype != torch.uint8:
            raise TypeError(f"{fn}: {name} must be uint8, got {t.dtype}")
        if t.dim() != 2:
            raise ValueError(f"{fn}: {name} must be [H, W], got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{fn}: {name} must be contiguous")
    if iml.shape != imr.shape or iml.device != imr.device:
        raise ValueError(f"{fn}: iml and imr differ in shape or device: "
                         f"{tuple(iml.shape)}@{iml.device} vs "
                         f"{tuple(imr.shape)}@{imr.device}")
    if min(iml.shape) < 1 or ndisp < 1:
        raise ValueError(f"{fn}: empty input {tuple(iml.shape)}, "
                         f"ndisp={ndisp}")
    if wsize % 2 != 1 or not 1 <= wsize <= MAX_WSIZE:
        raise ValueError(f"{fn}: wsize must be odd and <= {MAX_WSIZE}")
    if iml.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{fn}: unsupported device {iml.device}")


def census_reference(iml: torch.Tensor, imr: torch.Tensor, ndisp: int,
                     wsize: int = 11) -> torch.Tensor:
    """Plain PyTorch census cost volume, [D, H, W] float32."""
    return M.census(iml, imr, ndisp, wsize).permute(2, 0, 1).contiguous()


def _bind(lib: ctypes.CDLL):
    """``msn_census`` of a built ``lib``, with its C signature."""
    fn = lib.msn_census
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _kernel_fn():
    """``msn_census`` of the built library."""
    return _bind(_build.load("census"))


def census(iml: torch.Tensor, imr: torch.Tensor, ndisp: int,
           wsize: int = 11) -> torch.Tensor:
    """Census cost volume [D, H, W] float32 from a uint8 [H, W] pair.

    CPU tensors take ``census_reference``. CUDA tensors launch the kernel
    and raise if the launch fails; ``census.launches`` counts those launches
    (one per call)."""
    check_pair("census", iml, imr, ndisp, wsize)
    if iml.device.type == "cpu":
        return census_reference(iml, imr, ndisp, wsize)
    H, W = iml.shape
    fn = _kernel_fn()
    with torch.cuda.device(iml.device):
        cost = torch.empty((ndisp, H, W), dtype=torch.float32,
                           device=iml.device)
        stream = torch.cuda.current_stream(iml.device).cuda_stream
        err = fn(iml.data_ptr(), imr.data_ptr(), cost.data_ptr(), H, W, ndisp,
                 wsize, stream)
    if err != 0:
        raise RuntimeError(f"census kernel launch failed: CUDA error {err} "
                           f"(H={H}, W={W}, ndisp={ndisp})")
    with _COUNT_LOCK:
        census.launches += 1
    return cost


census.launches = 0
