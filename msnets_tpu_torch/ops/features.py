"""Matching-space feature stage (counterpart of ``msnets_tpu/ops/features.py``).

A uint8 stereo pair becomes the matching-space volume on the device:
anti-aliased half-scale downsample, four matchers (census 11x11, NCC 3x3,
ZSAD 5x5, SAD-of-Sobel 5x5), their clip normalizations and AML likelihoods,
margins trimmed. Three variants, chosen by ``MatchingConfig``:

* 8 channels (``num_channels=8``, the default): the left view. Channels 0
  and 4 (census cost and census AML) come fused from ``ops.cuda.census_aml``.
* 16 channels (``num_channels=16``): the 8 left channels, then the same 8
  computed on each cost volume re-indexed to the right view,
  R[d, i, j] = L[d, i, j+d]. The re-index needs the raw census volume, which
  comes from ``ops.cuda.census``.
* raw (``features_mode="raw"``): 2 channels, L(x)/255 and R(x-d)/255, the
  no-matching ablation volume; no matcher runs.

The ``ops.cuda`` wrappers launch the hand-written kernels on CUDA tensors
and compute their plain PyTorch versions on CPU tensors. Everything else is
plain PyTorch.

Two entry points: ``ms_features_test`` (the serving path: the padded
full-resolution pair, downsampled and bordered by 10 px) and
``ms_features_train`` (a train crop with its margins, downsampled; the
trainer calls it once a sample).

Layout: the volume is returned as [C, D, H, W], the reference layout and the
one ``nn.Conv3d`` takes (after a batch axis). The JAX package returns
[D, H, W, C]; ``msnets_tpu.ops.features.to_ncdhw`` of its output equals the
port's.

Numerics mirror the reference:
  * normalizations: census clip(0, 120)/120, ncc (1+clip(-1,1))/2,
    sobel and zsad clip(0, 2^13)/2^13;
  * AML sigmas: census 128, ncc 0.02, sad 2e4; the sobel channel uses
    sad_sigma, as the reference does;
  * the half-scale downsample replicates skimage's rescale(0.5,
    anti_aliasing=True, mode='constant'): 5-tap sigma=0.5 gaussian
    (zero-padded) on img/255, 2x2 average, *255, truncated to uint8;
  * divisions by constants are reciprocal multiplies, as XLA compiles them
    (``matchers._div_const``).
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from ..config import MatchingConfig
from . import matchers as M
from .cuda.census import census
from .cuda.census_aml import census_aml

_BORDER = 10     # test-time pad that keeps sentinel values off the image


def _gaussian_kernel1d(sigma: float = 0.5, truncate: float = 4.0) -> np.ndarray:
    """scipy.ndimage gaussian weights: phi(x) normalized over integer taps."""
    radius = int(truncate * sigma + 0.5)
    x = np.arange(-radius, radius + 1)
    phi = np.exp(-0.5 / (sigma * sigma) * x * x)
    return (phi / phi.sum()).astype(np.float64)


def _fma(a: torch.Tensor, k: np.float32, c: torch.Tensor) -> torch.Tensor:
    """float32 ``a * k + c`` with one rounding, as a fused multiply-add. The
    product of two float32 values is exact in float64, so one float64 add,
    rounded to float32, gives the fused result; it could differ only where
    the float64 sum lands exactly on a float32 tie."""
    return torch.add(c.double(), a.double(), alpha=float(k)).float()


def downsample_half(img: torch.Tensor) -> torch.Tensor:
    """uint8 [H, W] -> uint8 [round(H/2), round(W/2)] anti-aliased
    half-scale (numpy banker's rounding of odd sizes, as skimage)."""
    H, W = img.shape
    oh = int(np.round(H * 0.5)) if H % 2 else H // 2
    ow = int(np.round(W * 0.5)) if W % 2 else W // 2
    img_f = img.to(torch.float32)
    x = M._div_const(img_f, 255.0)
    kern = [np.float32(k) for k in _gaussian_kernel1d()]
    r = (len(kern) - 1) // 2

    def gauss_axis(a, axis, centre, centre_k):
        # the arithmetic XLA compiles the JAX loop into: tap 0 fused into
        # tap 1's rounded product, every later tap a fused multiply-add, and
        # the centre tap on the unpadded operand
        pad = (0, 0, r, r) if axis == 0 else (r, r)
        ap = torch.nn.functional.pad(a, pad)
        n = a.shape[axis]
        acc = ap.narrow(axis, 1, n) * float(kern[1])
        acc = _fma(ap.narrow(axis, 0, n), kern[0], acc)
        for i in range(2, len(kern)):
            if i == r:
                acc = _fma(centre, centre_k, acc)
            else:
                acc = _fma(ap.narrow(axis, i, n), kern[i], acc)
        return acc

    # XLA folds the constant of img/255 into the first pass's centre weight
    y = gauss_axis(x, 0, img_f, np.float32(1) / np.float32(255) * kern[r])
    x = gauss_axis(y, 1, y, kern[r])
    # bilinear at source coords 2*o + 0.5 is the 2x2 average; odd sizes are
    # zero-padded (skimage's cval=0 out-of-range handling)
    ph, pw = max(0, 2 * oh - H), max(0, 2 * ow - W)
    if ph or pw:
        x = torch.nn.functional.pad(x, (0, pw, 0, ph))
    x = x[:2 * oh, :2 * ow].reshape(oh, 2, ow, 2)
    x = (x[:, 0, :, 0] + x[:, 0, :, 1] + x[:, 1, :, 0] + x[:, 1, :, 1]) * 0.25
    return (x * 255.0).to(torch.uint8)


def compute_costs(iml: torch.Tensor, imr: torch.Tensor, maxdisp: int,
                  cfg: MatchingConfig, board_h: int = 10,
                  board_w_left: int = 10, board_w_right: int = 0,
                  left_only: bool = True) -> Tuple[torch.Tensor, ...]:
    """The matching costs with margins trimmed, all [D, H', W'].

    ``left_only``: ``(census_cost, census_aml, ncc, sobel_sad, zsad)``, the
    two census channels already normalized (one ``census_aml`` launch).
    Otherwise ``(census, ncc, sobel_sad, zsad)`` with the raw census Hamming
    volume (one ``census`` launch), which the right view re-indexes. The
    other costs are raw, for ``_normalize_stack``."""
    H, W = iml.shape
    h_end = H - board_h if board_h > 0 else H
    w_end = W - board_w_right if board_w_right > 0 else W

    def trim_dhw(v):
        return v[:, board_h:h_end, board_w_left:w_end]

    def trim_hwd(v):
        return trim_dhw(v.permute(2, 0, 1))

    if left_only:
        cen = tuple(trim_dhw(v) for v in census_aml(
            iml, imr, maxdisp, cfg.censw, cfg.cens_sigma))
    else:
        cen = (trim_dhw(census(iml, imr, maxdisp, cfg.censw)),)
    c_ncc = M.ncc_nister(iml, imr, maxdisp, cfg.nccw)
    c_sad = M.zsad(iml, imr, maxdisp, cfg.sadw)
    c_sob = M.sadsob(M.sobel(iml), M.sobel(imr), maxdisp, cfg.sobelw)
    return cen + (trim_hwd(c_ncc), trim_hwd(c_sob), trim_hwd(c_sad))


def _normalize_stack(cen_cost, cen_aml, c_ncc, c_sob, c_sad,
                     cfg: MatchingConfig) -> List[torch.Tensor]:
    """The 8 channel planes [D, H, W] in reference order: four normalized
    costs, then four AML likelihoods (over D, dim 0)."""
    t13 = 2.0 ** 13
    return [
        cen_cost,
        (1.0 + torch.clamp(c_ncc, -1.0, 1.0)) / 2.0,
        M._div_const(torch.clamp(c_sob, 0.0, t13), t13),
        M._div_const(torch.clamp(c_sad, 0.0, t13), t13),
        cen_aml,
        M.extract_aml(c_ncc, cfg.ncc_sigma, dim=0),
        M.extract_aml(c_sob, cfg.sad_sigma, dim=0),   # sad_sigma on purpose
        M.extract_aml(c_sad, cfg.sad_sigma, dim=0),
    ]


def _normalize_stack_raw(c_cen, c_ncc, c_sob, c_sad,
                         cfg: MatchingConfig) -> List[torch.Tensor]:
    """``_normalize_stack`` from the raw census volume: its clip/120 and
    its AML computed here in torch, as the JAX ``_normalize_stack`` does."""
    return _normalize_stack(
        M._div_const(torch.clamp(c_cen, 0.0, 120.0), 120.0),
        M.extract_aml(c_cen, cfg.cens_sigma, dim=0), c_ncc, c_sob, c_sad, cfg)


def assemble_features_left(cen_cost, cen_aml, c_ncc, c_sob, c_sad,
                           cfg: MatchingConfig,
                           out_dtype: torch.dtype = torch.float32
                           ) -> torch.Tensor:
    """8-channel matching-space volume [C, D, H, W] in ``out_dtype``."""
    ch = _normalize_stack(cen_cost, cen_aml, c_ncc, c_sob, c_sad, cfg)
    return torch.stack([c.to(out_dtype) for c in ch], dim=0)


def assemble_features_lr(c_cen, c_ncc, c_sob, c_sad, cfg: MatchingConfig,
                         out_dtype: torch.dtype = torch.float32
                         ) -> torch.Tensor:
    """16-channel volume [C, D, H, W]: the 8 left channels, then the 8 of
    the costs re-indexed to the right view, R[d, i, j] = L[d, i, j+d]
    (trimmed volumes; the fill is each volume's [0, 0, 0])."""
    costs = (c_cen, c_ncc, c_sob, c_sad)
    ch = (_normalize_stack_raw(*costs, cfg)
          + _normalize_stack_raw(*(M.reindex_planes(c) for c in costs), cfg))
    return torch.stack([c.to(out_dtype) for c in ch], dim=0)


def raw_features(iml: torch.Tensor, imr: torch.Tensor, maxdisp: int,
                 board_h: int, board_w_left: int, board_w_right: int = 0,
                 out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """2-channel raw-intensity volume [2, D, H', W'], margins trimmed:
    channel 0 is L(x)/255 over every d, channel 1 is R(x-d)/255 (0 where
    x < d). Both are normalized in float32 and cast once."""
    H, W = iml.shape
    h_end = H - board_h if board_h > 0 else H
    w_end = W - board_w_right if board_w_right > 0 else W
    L = M._div_const(iml.to(torch.float32), 255.0)
    R = M._div_const(imr.to(torch.float32), 255.0)
    # window k of R zero-padded by D on the left is R(x - (D - k)): the
    # windows D..1, in that order, are the shifts d = 0..D-1 in one copy
    Rp = torch.nn.functional.pad(R, (maxdisp, 0))
    Rs = Rp.unfold(1, W, 1).flip(1)[:, :maxdisp].permute(1, 0, 2)  # [D, H, W]
    rows, cols = slice(board_h, h_end), slice(board_w_left, w_end)
    L = L[rows, cols].expand(maxdisp, -1, -1)
    return torch.stack([L, Rs[:, rows, cols]], dim=0).to(out_dtype)


def ms_features(iml: torch.Tensor, imr: torch.Tensor, maxdisp: int,
                cfg: MatchingConfig, board_h: int, board_w_left: int,
                board_w_right: int = 0, left_only: bool = True,
                out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """uint8 [H, W] pair (already at the working resolution) -> features
    [C, D, H', W'] with margins trimmed. ``maxdisp`` and the margins are at
    the working resolution too. ``cfg.features_mode="raw"`` gives the
    raw-intensity volume; otherwise ``left_only`` picks 8 or 16 channels."""
    if cfg.features_mode == "raw":
        return raw_features(iml, imr, maxdisp, board_h, board_w_left,
                            board_w_right, out_dtype)
    costs = compute_costs(iml, imr, maxdisp, cfg, board_h, board_w_left,
                          board_w_right, left_only)
    if left_only:
        return assemble_features_left(*costs, cfg, out_dtype)
    return assemble_features_lr(*costs, cfg, out_dtype)


def _downsample(iml: torch.Tensor, imr: torch.Tensor, s: int):
    if s == 2:
        return downsample_half(iml), downsample_half(imr)
    if s != 1:
        raise NotImplementedError(f"ds_scale={s}")
    return iml, imr


def ms_features_train(iml: torch.Tensor, imr: torch.Tensor, maxdisp: int,
                      cfg: MatchingConfig, board_h: int, board_w_left: int,
                      board_w_right: int = 0, left_only: bool = True,
                      out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Train-sample feature stage: the cropped full-resolution pair, margins
    included, is downsampled by ds_scale and turned into features with
    ``maxdisp`` and the margins divided by ds_scale. Output
    [C, maxdisp/s, crop_h/s, crop_w/s]."""
    s = cfg.ds_scale
    iml, imr = _downsample(iml, imr, s)
    return ms_features(iml, imr, maxdisp // s, cfg, board_h // s,
                       board_w_left // s, board_w_right // s, left_only,
                       out_dtype)


def ms_features_test(iml: torch.Tensor, imr: torch.Tensor, maxdisp: int,
                     cfg: MatchingConfig, left_only: bool = True,
                     out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Test-time feature stage: the full-resolution pair (already padded to
    a multiple of encoder_ds) is downsampled by ds_scale, padded by 10 px on
    every side and turned into features with 10-px margins, which trims the
    pad back off. Output [C, D/s, H/s, W/s]."""
    s = cfg.ds_scale
    iml, imr = _downsample(iml, imr, s)
    b = _BORDER
    iml = torch.nn.functional.pad(iml, (b, b, b, b))
    imr = torch.nn.functional.pad(imr, (b, b, b, b))
    return ms_features(iml, imr, maxdisp // s, cfg, b, b, b, left_only,
                       out_dtype)
