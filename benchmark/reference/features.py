"""Matching-space feature stage in plain float32 PyTorch (8 channels, left
view): half-scale anti-aliased downsample, census 11x11 with its AML, NCC
3x3, ZSAD 5x5 and SAD-of-Sobel 5x5, each clip-normalized with an AML
likelihood over disparity; margins trimmed. Layout [C, D, H, W].

A frozen copy of the published feature stage (MS-Nets' ``cbmv`` matchers as
the port computes them): box sums are float32 shift-adds, divisions by a
constant are multiplies by the float32 reciprocal, and the downsample keeps
its fused multiply-adds, so that the reference reads the same uint8 image
the port does.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

INVALID = 2147483648.0      # float32(RAND_MAX): a cost never computed
BORDER = 10                 # test-time pad around the half-res pair


def div_const(x: torch.Tensor, v: float) -> torch.Tensor:
    return x * x.new_full((), float(np.float32(1) / np.float32(v)))


def _gauss_taps(sigma: float = 0.5, truncate: float = 4.0):
    radius = int(truncate * sigma + 0.5)
    x = np.arange(-radius, radius + 1)
    phi = np.exp(-0.5 / (sigma * sigma) * x * x)
    return [np.float32(k) for k in phi / phi.sum()]


def _fma(a: torch.Tensor, k: np.float32, c: torch.Tensor) -> torch.Tensor:
    return torch.add(c.double(), a.double(), alpha=float(k)).float()


def downsample_half(img: torch.Tensor) -> torch.Tensor:
    """uint8 [H, W] -> uint8 [H/2, W/2]: 5-tap gaussian (sigma 0.5, zero
    padded) on img/255, 2x2 mean, *255, truncated (skimage's rescale(0.5,
    anti_aliasing=True)); even sizes."""
    H, W = img.shape
    if H % 2 or W % 2:
        raise ValueError(f"downsample_half: even sizes only, got {H}x{W}")
    img_f = img.to(torch.float32)
    x = div_const(img_f, 255.0)
    kern = _gauss_taps()
    r = (len(kern) - 1) // 2

    def gauss_axis(a, axis, centre, centre_k):
        ap = F.pad(a, (0, 0, r, r) if axis == 0 else (r, r))
        n = a.shape[axis]
        acc = ap.narrow(axis, 1, n) * float(kern[1])
        acc = _fma(ap.narrow(axis, 0, n), kern[0], acc)
        for i in range(2, len(kern)):
            src, k = (centre, centre_k) if i == r else (ap.narrow(axis, i, n),
                                                        kern[i])
            acc = _fma(src, k, acc)
        return acc

    y = gauss_axis(x, 0, img_f, np.float32(1) / np.float32(255) * kern[r])
    x = gauss_axis(y, 1, y, kern[r]).reshape(H // 2, 2, W // 2, 2)
    x = (x[:, 0, :, 0] + x[:, 0, :, 1] + x[:, 1, :, 0] + x[:, 1, :, 1]) * 0.25
    return (x * 255.0).to(torch.uint8)


def _valid_mask(H, W, ndisp, w, device):
    wc = w // 2
    r = torch.arange(H, device=device)[:, None, None]
    c = torch.arange(W, device=device)[None, :, None]
    d = torch.arange(ndisp, device=device)[None, None, :]
    return ((r >= wc) & (r < H - w + wc) & (c >= wc) & (c < W - w + wc)
            & (d <= c - wc))


def _shifted(x: torch.Tensor, ndisp: int, fill=0.0) -> torch.Tensor:
    """[H, W, ...] -> [H, W, D, ...], out[:, j, d] = x[:, j - d]."""
    H, W = x.shape[:2]
    out = x.new_full((H, W, ndisp) + tuple(x.shape[2:]), fill)
    for d in range(min(ndisp, W)):
        out[:, d:, d] = x[:, :W - d]
    return out


def _box_valid(x: torch.Tensor, w: int) -> torch.Tensor:
    def sum_axis(a, axis):
        n = a.shape[axis] - w + 1
        out = a.narrow(axis, 0, n)
        for i in range(1, w):
            out = out + a.narrow(axis, i, n)
        return out
    return sum_axis(sum_axis(x, 0), 1)


def _centre_pad(v, H, W, wc):
    out = v.new_zeros((H, W) + tuple(v.shape[2:]))
    out[wc:wc + v.shape[0], wc:wc + v.shape[1]] = v
    return out


def _popcount32(x):
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


def census(iml, imr, ndisp: int, wsize: int = 11) -> torch.Tensor:
    """Census Hamming cost [H, W, D]: bit k of a pixel's descriptor is
    centre < neighbour k of its row-major window."""
    H, W = iml.shape

    def descriptors(img):
        x = img.to(torch.int32)
        wc = wsize // 2
        words, acc, bit = [], torch.zeros_like(x, dtype=torch.int64), 0
        for dy in range(-wc, wc + 1):
            for dx in range(-wc, wc + 1):
                nb = torch.roll(x, (-dy, -dx), dims=(0, 1))
                acc = acc | ((x < nb).to(torch.int64) << bit)
                bit += 1
                if bit == 32:
                    words.append(acc)
                    acc, bit = torch.zeros_like(acc), 0
        if bit:
            words.append(acc)
        return torch.stack(words, dim=-1)

    dl = descriptors(iml)
    dr = _shifted(descriptors(imr), ndisp, 0)
    cost = _popcount32(dl[:, :, None, :] ^ dr).sum(-1).to(torch.float32)
    mask = _valid_mask(H, W, ndisp, wsize, iml.device)
    return torch.where(mask, cost, cost.new_full((), INVALID))


def sobel(img):
    H, W = img.shape
    x = img.to(torch.float32)

    def col(r, c):
        return x[r:H - 2 + r, c:W - 2 + c]

    v = (-col(0, 0) + col(0, 2) - 2.0 * col(1, 0) + 2.0 * col(1, 2)
         - col(2, 0) + col(2, 2))
    out = torch.zeros((H, W), dtype=torch.float32, device=img.device)
    out[1:H - 2, 1:W - 2] = v[:H - 3, :W - 3]
    return out


def ncc(iml, imr, ndisp: int, wsize: int = 3):
    H, W = iml.shape
    wc, n = wsize // 2, float(wsize * wsize)
    L, R = iml.to(torch.float32), imr.to(torch.float32)

    def stats(img):
        A = _centre_pad(_box_valid(img, wsize), H, W, wc)
        B = _centre_pad(_box_valid(img * img, wsize), H, W, wc)
        var = n * B - A * A
        C = torch.where(var > 0, torch.rsqrt(torch.clamp(var, min=1e-30)),
                        var.new_full((), float("inf")))
        return A, C

    Al, Cl = stats(L)
    Ar, Cr = stats(R)
    S = _centre_pad(_box_valid(L[:, :, None] * _shifted(R, ndisp), wsize),
                    H, W, wc)
    Cr_s = _shifted(Cr, ndisp, fill=float("inf"))
    val = -(n * S - Al[:, :, None] * _shifted(Ar, ndisp)) * Cl[:, :, None] * Cr_s
    finite = torch.isfinite(Cl)[:, :, None] & torch.isfinite(Cr_s)
    val = torch.where(finite, val, val.new_full((), 1.0))
    mask = _valid_mask(H, W, ndisp, wsize, iml.device)
    return torch.where(mask, val, val.new_full((), INVALID))


def zsad(iml, imr, ndisp: int, wsize: int = 5):
    H, W = iml.shape
    wc, n = wsize // 2, float(wsize * wsize)
    L, R = iml.to(torch.float32), imr.to(torch.float32)

    def mean(img):
        return _centre_pad(div_const(_box_valid(img, wsize), n), H, W, wc)

    K = mean(L)[:, :, None] - _shifted(mean(R), ndisp)
    T = F.pad(L[:, :, None] - _shifted(R, ndisp), (0, 0, wc, wc, wc, wc))
    cost = torch.zeros((H, W, ndisp), dtype=torch.float32, device=iml.device)
    for u in range(wsize):
        for v in range(wsize):
            cost = cost + torch.abs(T[u:u + H, v:v + W] - K)
    mask = _valid_mask(H, W, ndisp, wsize, iml.device)
    return torch.where(mask, cost, cost.new_full((), INVALID))


def sadsob(sobl, sobr, ndisp: int, wsize: int = 5):
    H, W = sobl.shape
    wc = wsize // 2
    diff = torch.abs(sobl[:, :, None] - _shifted(sobr, ndisp))
    on_image = _shifted(torch.ones_like(sobr, dtype=torch.bool), ndisp, False)
    diff = torch.where(on_image, diff, diff.new_zeros(()))
    s = _centre_pad(_box_valid(diff, wsize), H, W, wc)
    mask = _valid_mask(H, W, ndisp, wsize, sobl.device)
    return torch.where(mask, s, s.new_full((), INVALID))


def aml(vol, sigma: float, dim: int = 0):
    """Softmax of -(c - min c)^2 / sigma over ``dim``; 0 where the minimum
    is INVALID."""
    mn = vol.amin(dim=dim, keepdim=True)
    num = vol - mn
    w = torch.exp(div_const(-(num * num), sigma))
    p = w / w.sum(dim=dim, keepdim=True)
    return torch.where(mn >= INVALID, p.new_zeros(()), p)


def features(iml, imr, ndisp: int, m: dict, board_h: int, bwl: int,
             bwr: int) -> torch.Tensor:
    """uint8 [H, W] pair at the working resolution -> float32
    [8, D, H', W'] with the margins trimmed; ``m`` the configuration's
    ``matching`` mapping."""
    H, W = iml.shape
    h_end, w_end = H - board_h if board_h else H, W - bwr if bwr else W

    def trim(v_hwd):
        return v_hwd.permute(2, 0, 1)[:, board_h:h_end, bwl:w_end]

    c_cen = trim(census(iml, imr, ndisp, m["censw"]))
    c_ncc = trim(ncc(iml, imr, ndisp, m["nccw"]))
    c_sob = trim(sadsob(sobel(iml), sobel(imr), ndisp, m["sobelw"]))
    c_sad = trim(zsad(iml, imr, ndisp, m["sadw"]))
    t13 = 2.0 ** 13
    planes = [
        div_const(torch.clamp(c_cen, 0.0, 120.0), 120.0),
        (1.0 + torch.clamp(c_ncc, -1.0, 1.0)) / 2.0,
        div_const(torch.clamp(c_sob, 0.0, t13), t13),
        div_const(torch.clamp(c_sad, 0.0, t13), t13),
        aml(c_cen, m["cens_sigma"]),
        aml(c_ncc, m["ncc_sigma"]),
        aml(c_sob, m["sad_sigma"]),     # the published stage uses sad_sigma
        aml(c_sad, m["sad_sigma"]),
    ]
    return torch.stack(planes, dim=0)


def features_test(iml, imr, max_disp: int, m: dict) -> torch.Tensor:
    """Serving: a pair padded to its bucket -> [8, D/2, H/2, W/2]."""
    s = m["ds_scale"]
    if s != 2:
        raise NotImplementedError(f"ds_scale={s}")
    a = F.pad(downsample_half(iml), (BORDER,) * 4)
    b = F.pad(downsample_half(imr), (BORDER,) * 4)
    return features(a, b, max_disp // s, m, BORDER, BORDER, BORDER)


def features_train(iml, imr, max_disp: int, m: dict, board_h: int,
                   bwl: int, bwr: int) -> torch.Tensor:
    """Training: a crop with its margins -> [8, D/2, crop_h/2, crop_w/2]."""
    s = m["ds_scale"]
    if s != 2:
        raise NotImplementedError(f"ds_scale={s}")
    return features(downsample_half(iml), downsample_half(imr),
                    max_disp // s, m, board_h // s, bwl // s, bwr // s)


def pad_to_bucket(iml: np.ndarray, imr: np.ndarray, multiple: int
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Zero-pad a pair on top and right to the next multiple of
    ``multiple`` (the published test padding)."""
    h, w = iml.shape
    ph, pw = (-h) % multiple, (-w) % multiple
    pad = ((ph, 0), (0, pw))
    return np.pad(iml, pad), np.pad(imr, pad)
