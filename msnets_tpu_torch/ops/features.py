"""Matching-space feature stage (counterpart of ``msnets_tpu/ops/features.py``).

A uint8 stereo pair becomes the 8-channel matching-space volume on the
device: anti-aliased half-scale downsample, four matchers (census 11x11,
NCC 3x3, ZSAD 5x5, SAD-of-Sobel 5x5), their clip normalizations and AML
likelihoods, margins trimmed.

Layout: the volume is returned as [C, D, H, W], the reference layout and the
one ``nn.Conv3d`` takes (after a batch axis). The JAX package returns
[D, H, W, C]; ``msnets_tpu.ops.features.to_ncdhw`` of its output equals the
port's.

Channels 0 and 4 (census cost and census AML) come from
``ops.cuda.census_aml``: the hand-written kernel on CUDA tensors, its plain
PyTorch version on CPU tensors. The other six are plain PyTorch.

Numerics mirror the reference:
  * normalizations: census clip(0, 120)/120, ncc (1+clip(-1,1))/2,
    sobel and zsad clip(0, 2^13)/2^13;
  * AML sigmas: census 128, ncc 0.02, sad 2e4; the sobel channel uses
    sad_sigma, as the reference does;
  * the half-scale downsample replicates skimage's rescale(0.5,
    anti_aliasing=True, mode='constant'): 5-tap sigma=0.5 gaussian
    (zero-padded) on img/255, 2x2 average, *255, truncated to uint8.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from ..config import MatchingConfig
from . import matchers as M
from .cuda.census_aml import census_aml

_BORDER = 10     # test-time pad that keeps sentinel values off the image


def _gaussian_kernel1d(sigma: float = 0.5, truncate: float = 4.0) -> np.ndarray:
    """scipy.ndimage gaussian weights: phi(x) normalized over integer taps."""
    radius = int(truncate * sigma + 0.5)
    x = np.arange(-radius, radius + 1)
    phi = np.exp(-0.5 / (sigma * sigma) * x * x)
    return (phi / phi.sum()).astype(np.float64)


def downsample_half(img: torch.Tensor) -> torch.Tensor:
    """uint8 [H, W] -> uint8 [round(H/2), round(W/2)] anti-aliased
    half-scale (numpy banker's rounding of odd sizes, as skimage)."""
    H, W = img.shape
    oh = int(np.round(H * 0.5)) if H % 2 else H // 2
    ow = int(np.round(W * 0.5)) if W % 2 else W // 2
    x = M._div(img.to(torch.float32), 255.0)
    kern = [float(np.float32(k)) for k in _gaussian_kernel1d()]
    r = (len(kern) - 1) // 2

    def gauss_axis(a, axis):
        pad = (0, 0, r, r) if axis == 0 else (r, r)
        ap = torch.nn.functional.pad(a, pad)
        n = a.shape[axis]
        acc = None
        for i, kv in enumerate(kern):
            term = ap.narrow(axis, i, n) * kv
            acc = term if acc is None else acc + term
        return acc

    x = gauss_axis(gauss_axis(x, 0), 1)
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
                  board_w_left: int = 10, board_w_right: int = 0
                  ) -> Tuple[torch.Tensor, ...]:
    """The matching costs with margins trimmed, all [D, H', W'].

    Returns ``(census_cost, census_aml, ncc, sobel_sad, zsad)``: the two
    census channels already normalized (they come fused from
    ``census_aml``), the other three raw costs, for ``_normalize_stack``."""
    H, W = iml.shape
    h_end = H - board_h if board_h > 0 else H
    w_end = W - board_w_right if board_w_right > 0 else W

    def trim_dhw(v):
        return v[:, board_h:h_end, board_w_left:w_end]

    def trim_hwd(v):
        return trim_dhw(v.permute(2, 0, 1))

    cen_cost, cen_aml = census_aml(iml, imr, maxdisp, cfg.censw,
                                   cfg.cens_sigma)
    c_ncc = M.ncc_nister(iml, imr, maxdisp, cfg.nccw)
    c_sad = M.zsad(iml, imr, maxdisp, cfg.sadw)
    c_sob = M.sadsob(M.sobel(iml), M.sobel(imr), maxdisp, cfg.sobelw)
    return (trim_dhw(cen_cost), trim_dhw(cen_aml), trim_hwd(c_ncc),
            trim_hwd(c_sob), trim_hwd(c_sad))


def _normalize_stack(cen_cost, cen_aml, c_ncc, c_sob, c_sad,
                     cfg: MatchingConfig) -> List[torch.Tensor]:
    """The 8 channel planes [D, H, W] in reference order: four normalized
    costs, then four AML likelihoods (over D, dim 0)."""
    t13 = 2.0 ** 13
    return [
        cen_cost,
        (1.0 + torch.clamp(c_ncc, -1.0, 1.0)) / 2.0,
        M._div(torch.clamp(c_sob, 0.0, t13), t13),
        M._div(torch.clamp(c_sad, 0.0, t13), t13),
        cen_aml,
        M.extract_aml(c_ncc, cfg.ncc_sigma, dim=0),
        M.extract_aml(c_sob, cfg.sad_sigma, dim=0),   # sad_sigma on purpose
        M.extract_aml(c_sad, cfg.sad_sigma, dim=0),
    ]


def assemble_features_left(cen_cost, cen_aml, c_ncc, c_sob, c_sad,
                           cfg: MatchingConfig,
                           out_dtype: torch.dtype = torch.float32
                           ) -> torch.Tensor:
    """8-channel matching-space volume [C, D, H, W] in ``out_dtype``."""
    ch = _normalize_stack(cen_cost, cen_aml, c_ncc, c_sob, c_sad, cfg)
    return torch.stack([c.to(out_dtype) for c in ch], dim=0)


def ms_features(iml: torch.Tensor, imr: torch.Tensor, maxdisp: int,
                cfg: MatchingConfig, board_h: int, board_w_left: int,
                board_w_right: int = 0, left_only: bool = True,
                out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """uint8 [H, W] pair (already at the working resolution) -> features
    [C, D, H', W'] with margins trimmed. ``maxdisp`` and the margins are at
    the working resolution too."""
    if cfg.features_mode != "ms":
        raise NotImplementedError(
            f"features_mode={cfg.features_mode!r}: raw_features is not "
            "ported yet (ROADMAP queue 1)")
    if not left_only:
        raise NotImplementedError(
            "16-channel assemble_features_lr is not ported yet (ROADMAP "
            "queue 1, with census_pallas)")
    costs = compute_costs(iml, imr, maxdisp, cfg, board_h, board_w_left,
                          board_w_right)
    return assemble_features_left(*costs, cfg, out_dtype)


def ms_features_test(iml: torch.Tensor, imr: torch.Tensor, maxdisp: int,
                     cfg: MatchingConfig, left_only: bool = True,
                     out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Test-time feature stage: the full-resolution pair (already padded to
    a multiple of encoder_ds) is downsampled by ds_scale, padded by 10 px on
    every side and turned into features with 10-px margins, which trims the
    pad back off. Output [C, D/s, H/s, W/s]."""
    s = cfg.ds_scale
    if s == 2:
        iml, imr = downsample_half(iml), downsample_half(imr)
    elif s != 1:
        raise NotImplementedError(f"ds_scale={s}")
    b = _BORDER
    iml = torch.nn.functional.pad(iml, (b, b, b, b))
    imr = torch.nn.functional.pad(imr, (b, b, b, b))
    return ms_features(iml, imr, maxdisp // s, cfg, b, b, b, left_only,
                       out_dtype)
