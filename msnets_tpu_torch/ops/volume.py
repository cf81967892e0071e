"""The concat cost volume of a learned feature stage (GC-Net, Kendall et al.
2017, section 3.2), in plain PyTorch.

``concat_volume(fl, fr, ndisp)`` takes the two views' feature maps
[N, C, H, W] and gives [N, 2C, ndisp, H, W] with

    v[:, :C, d, :, x] = fl[:, :, :, x]        for x >= d
    v[:, C:, d, :, x] = fr[:, :, :, x - d]    for x >= d

and 0 where x < d in both halves. It is an ``autograd.Function``: the
forward writes each half with one call over every disparity (the left half
a ``where`` against the mask x >= d, the right half a ``gather`` from the
right map padded by ``ndisp`` zero columns), and the backward sums the
volume's gradient over d into ``fl`` (the masked left half) and into ``fr``
shifted back (the right half read through a view whose d stride is one row
plus one column, so that it walks the diagonal x = y + d). Each takes a
fixed number of launches, whatever ``ndisp``.

Counters, kept as attributes of ``concat_volume``: ``launches`` counts the
volumes built (one a call) and ``bytes`` the bytes they hold. The forward's
span is the caller's (``features.volume``); the backward runs in the span
``features.volume_backward``, on autograd's thread.
"""
from __future__ import annotations

import threading

import torch
import torch.nn.functional as F

from ..utils.profiling import span

_COUNT_LOCK = threading.Lock()


def _valid(ndisp: int, width: int, device) -> torch.Tensor:
    """[1, 1, ndisp, 1, W] bool: x >= d."""
    x = torch.arange(width, device=device)
    d = torch.arange(ndisp, device=device)
    return (x[None, :] >= d[:, None]).view(1, 1, ndisp, 1, width)


class _ConcatVolume(torch.autograd.Function):

    @staticmethod
    def forward(ctx, fl, fr, ndisp: int):
        N, C, H, W = fl.shape
        out = fl.new_empty((N, 2 * C, ndisp, H, W))
        valid = _valid(ndisp, W, fl.device)
        torch.where(valid, fl[:, :, None], fl.new_zeros(()), out=out[:, :C])
        # fr padded by ndisp zero columns on the left: column x - d + ndisp
        # of the padded map is fr's column x - d, or 0 where x < d
        padded = F.pad(fr, (ndisp, 0))
        x = torch.arange(W, device=fr.device)
        d = torch.arange(ndisp, device=fr.device)
        index = (x[None, :] - d[:, None] + ndisp).view(1, 1, ndisp, 1, W)
        torch.gather(padded[:, :, None].expand(N, C, ndisp, H, W + ndisp), 4,
                     index.expand(N, C, ndisp, H, W), out=out[:, C:])
        ctx.ndisp, ctx.channels = ndisp, C
        return out

    @staticmethod
    def backward(ctx, g):
        with span("features.volume_backward"):
            ndisp, C = ctx.ndisp, ctx.channels
            N, _, _, H, W = g.shape
            valid = _valid(ndisp, W, g.device)
            dfl = torch.where(valid, g[:, :C], g.new_zeros(())).sum(2)
            # fr's column y gets g[:, C:, d, :, y + d] for every d with
            # y + d < W: pad each row by ndisp zero columns and read the
            # diagonal through a view whose d stride is a row plus one
            wp = W + ndisp
            gp = F.pad(g[:, C:], (0, ndisp)).contiguous()
            diag = gp.as_strided((N, C, ndisp, H, W),
                                 (C * ndisp * H * wp, ndisp * H * wp,
                                  H * wp + 1, wp, 1), gp.storage_offset())
            dfr = diag.sum(2)
        return dfl, dfr, None


def concat_volume(fl: torch.Tensor, fr: torch.Tensor,
                  ndisp: int) -> torch.Tensor:
    """The concat volume [N, 2C, ndisp, H, W] of two [N, C, H, W] feature
    maps of one dtype (module docstring)."""
    if fl.shape != fr.shape or fl.dim() != 4 or fl.dtype != fr.dtype:
        raise ValueError(f"concat_volume: two [N, C, H, W] maps of one dtype, "
                         f"got {tuple(fl.shape)} {fl.dtype} and "
                         f"{tuple(fr.shape)} {fr.dtype}")
    if ndisp < 1:
        raise ValueError(f"concat_volume: ndisp {ndisp} < 1")
    out = _ConcatVolume.apply(fl, fr, ndisp)
    with _COUNT_LOCK:
        concat_volume.launches += 1
        concat_volume.bytes += out.numel() * out.element_size()
    return out


concat_volume.launches = 0
concat_volume.bytes = 0
