"""Matching costs in plain PyTorch (counterpart of ``msnets_tpu/ops/matchers.py``).

Every function takes uint8 or float [H, W] images and returns the
centre-aligned [H, W, D] cost volume of the JAX package, with the reference
valid-region semantics: windows cover rows [wc, H-w+wc) and cols
[wc, W-w+wc), costs exist only for d <= col - wc, and every other entry holds
``INVALID``.

Numerics follow the JAX formulations step by step:
  * box sums are exact float32 shift-adds in the same order, not
    convolutions (cuDNN's float32 convolutions default to TF32);
  * division by a constant goes through :func:`_div`, a true division. On
    CUDA, ``tensor / python_float`` multiplies by the reciprocal instead,
    which can differ in the last bit.
"""
from __future__ import annotations

import torch

from ..config import INVALID


def _div(x: torch.Tensor, v: float) -> torch.Tensor:
    """``x / v`` as an IEEE division (the divisor is a 0-dim tensor on x's
    device, which PyTorch does not rewrite into a reciprocal multiply)."""
    return x / x.new_full((), v)


def _valid_mask(H: int, W: int, ndisp: int, w: int,
                device: torch.device) -> torch.Tensor:
    """Reference valid-region mask [H, W, D] (bool): rows [wc, H-w+wc),
    cols [wc, W-w+wc), and d <= c - wc."""
    wc = w // 2
    r = torch.arange(H, device=device)[:, None, None]
    c = torch.arange(W, device=device)[None, :, None]
    d = torch.arange(ndisp, device=device)[None, None, :]
    return ((r >= wc) & (r < H - w + wc)
            & (c >= wc) & (c < W - w + wc)
            & (d <= c - wc))


def shifted_over_disp(x: torch.Tensor, ndisp: int, fill=0.0) -> torch.Tensor:
    """[H, W, ...] -> [H, W, D, ...] with out[:, j, d] = x[:, j-d] (``fill``
    where j < d)."""
    H, W = x.shape[:2]
    out = x.new_full((H, W, ndisp) + tuple(x.shape[2:]), fill)
    for d in range(min(ndisp, W)):
        out[:, d:, d] = x[:, :W - d]
    return out


def _box_valid(x: torch.Tensor, w: int) -> torch.Tensor:
    """Separable VALID box sum over the leading two axes of [H, W, ...], as
    w-1 shift-adds per axis (rows first, then columns)."""
    def sum_axis(a, axis):
        n = a.shape[axis] - w + 1
        out = a.narrow(axis, 0, n)
        for i in range(1, w):
            out = out + a.narrow(axis, i, n)
        return out
    return sum_axis(sum_axis(x, 0), 1)


def _centre_pad(v: torch.Tensor, H: int, W: int, wc: int) -> torch.Tensor:
    """Place a valid-window result at centre coordinates inside [H, W, ...]."""
    out = v.new_zeros((H, W) + tuple(v.shape[2:]))
    out[wc:wc + v.shape[0], wc:wc + v.shape[1]] = v
    return out


def _popcount32(x: torch.Tensor) -> torch.Tensor:
    """Bit count of each int64 element holding a 32-bit value (SWAR)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


def census_descriptors(img: torch.Tensor, wsize: int) -> torch.Tensor:
    """Census descriptors packed into 32-bit words, [H, W, NW] int64.

    Bit k at centre (r, c) is ``centre < window_k`` over the row-major
    wsize x wsize window. Out-of-image neighbours wrap around (``roll``, as
    in JAX); the valid-region mask removes every entry that reads them."""
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


def census(iml: torch.Tensor, imr: torch.Tensor, ndisp: int,
           wsize: int = 11) -> torch.Tensor:
    """Census Hamming cost volume [H, W, D] (float32): popcount of the XOR
    of the packed descriptors, summed over words."""
    H, W = iml.shape
    dl = census_descriptors(iml, wsize)
    dr = shifted_over_disp(census_descriptors(imr, wsize), ndisp, 0)
    cost = _popcount32(dl[:, :, None, :] ^ dr).sum(-1).to(torch.float32)
    mask = _valid_mask(H, W, ndisp, wsize, iml.device)
    return torch.where(mask, cost, cost.new_full((), INVALID))


def sobel(img: torch.Tensor) -> torch.Tensor:
    """3x3 horizontal Sobel, float32, zero border; drops the last valid row
    and column exactly like the reference."""
    H, W = img.shape
    x = img.to(torch.float32)

    def col(r, c):
        return x[r:H - 2 + r, c:W - 2 + c]

    v = (-col(0, 0) + col(0, 2) - 2.0 * col(1, 0) + 2.0 * col(1, 2)
         - col(2, 0) + col(2, 2))
    out = torch.zeros((H, W), dtype=torch.float32, device=img.device)
    out[1:H - 2, 1:W - 2] = v[:H - 3, :W - 3]
    return out


def ncc_nister(iml: torch.Tensor, imr: torch.Tensor, ndisp: int,
               wsize: int = 3) -> torch.Tensor:
    """Windowed NCC cost [H, W, D]: -(n*S_lr - A_l*A_r) * C_l * C_r with
    C = rsqrt(n*B - A^2); non-finite C (flat window) gives cost 1."""
    H, W = iml.shape
    wc = wsize // 2
    n = float(wsize * wsize)
    L = iml.to(torch.float32)
    R = imr.to(torch.float32)

    def stats(img):
        A = _centre_pad(_box_valid(img, wsize), H, W, wc)
        B = _centre_pad(_box_valid(img * img, wsize), H, W, wc)
        var = n * B - A * A
        C = torch.where(var > 0, torch.rsqrt(torch.clamp(var, min=1e-30)),
                        var.new_full((), float("inf")))
        return A, C

    Al, Cl = stats(L)
    Ar, Cr = stats(R)
    prod = L[:, :, None] * shifted_over_disp(R, ndisp)
    S = _centre_pad(_box_valid(prod, wsize), H, W, wc)
    Ar_s = shifted_over_disp(Ar, ndisp)
    Cr_s = shifted_over_disp(Cr, ndisp, fill=float("inf"))
    val = -(n * S - Al[:, :, None] * Ar_s) * Cl[:, :, None] * Cr_s
    finite = torch.isfinite(Cl)[:, :, None] & torch.isfinite(Cr_s)
    val = torch.where(finite, val, val.new_full((), 1.0))
    mask = _valid_mask(H, W, ndisp, wsize, iml.device)
    return torch.where(mask, val, val.new_full((), INVALID))


def zsad(iml: torch.Tensor, imr: torch.Tensor, ndisp: int,
         wsize: int = 5) -> torch.Tensor:
    """Zero-mean SAD cost [H, W, D]:
    sum_{u,v} |L[r+u, c+v] - R[r+u, c+v-d] - K_d[r, c]| with
    K_d = muL(r, c) - muR(r, c-d), accumulated over the w^2 offsets."""
    H, W = iml.shape
    wc = wsize // 2
    n = float(wsize * wsize)
    L = iml.to(torch.float32)
    R = imr.to(torch.float32)

    def mean(img):
        return _centre_pad(_div(_box_valid(img, wsize), n), H, W, wc)

    muL, muR = mean(L), mean(R)
    K = muL[:, :, None] - shifted_over_disp(muR, ndisp)
    T = L[:, :, None] - shifted_over_disp(R, ndisp)
    Tp = torch.nn.functional.pad(T, (0, 0, wc, wc, wc, wc))
    cost = torch.zeros((H, W, ndisp), dtype=torch.float32, device=iml.device)
    for u in range(wsize):
        for v in range(wsize):
            cost = cost + torch.abs(Tp[u:u + H, v:v + W] - K)
    mask = _valid_mask(H, W, ndisp, wsize, iml.device)
    return torch.where(mask, cost, cost.new_full((), INVALID))


def sadsob(sobl: torch.Tensor, sobr: torch.Tensor, ndisp: int,
           wsize: int = 5) -> torch.Tensor:
    """SAD over Sobel maps [H, W, D]: box sum of |sobL - shift(sobR, d)|,
    zero where the shift runs off the image."""
    H, W = sobl.shape
    wc = wsize // 2
    # the zero fill of shifted_over_disp would leave |sobL| where j < d;
    # those terms are zero in the reference's integral image
    diff = torch.abs(sobl[:, :, None] - shifted_over_disp(sobr, ndisp))
    on_image = shifted_over_disp(torch.ones_like(sobr, dtype=torch.bool),
                                 ndisp, False)
    diff = torch.where(on_image, diff, diff.new_zeros(()))
    s = _centre_pad(_box_valid(diff, wsize), H, W, wc)
    mask = _valid_mask(H, W, ndisp, wsize, sobl.device)
    return torch.where(mask, s, s.new_full((), INVALID))


def extract_aml(vol: torch.Tensor, sigma: float, dim: int = -1) -> torch.Tensor:
    """AML confidence: softmax of -(c - c_min)^2 / sigma over ``dim``; where
    the minimum is the INVALID sentinel the likelihoods are all 0."""
    mn = vol.amin(dim=dim, keepdim=True)
    num = vol - mn
    w = torch.exp(_div(-(num * num), sigma))
    p = w / w.sum(dim=dim, keepdim=True)
    return torch.where(mn >= INVALID, p.new_zeros(()), p)
