"""Least bytes and operations of the port's hand kernels, the least time
they allow on the H100 (``peaks``), and each kernel's launch shape in a
cell (``KERNELS``: name -> (count, launch shape of a cell)).

``census_aml`` (channels 0 and 4 of the feature volume from a uint8 pair
at the half-resolution working shape [H, W] with D disparities): the two
images read once (2*H*W bytes) and the two [D, H, W] planes written once
at 2 bytes a value, the bfloat16 the model reads them in. Operations:
4 popcounts a valid (d, pixel) entry and one exponential an entry of a
pixel with a valid minimum (the special-function units), 7 integer or
float operations a valid entry and 8 an output entry (the float32 rate).

``matchers_aml`` (channels 1-3 and 5-7 and the assembled volume, from the
same pair and the census planes, with the margins (board_h, board_w_left,
board_w_right) trimmed to the [8, D, H', W'] volume): the two images and
the trimmed census planes (float32) read once, the bfloat16 volume
written once. Operations: 140 a valid 5x5 entry (ZSAD 75, SAD-of-Sobel
50, NCC 13, the validity selects 2) and 24 an output (d, pixel): three
AMLs and normalizations, at the float32 rate.

The least time is the larger of bytes over the HBM rate and the
operations at their rates.
"""
from __future__ import annotations

from typing import Dict, Tuple

from . import peaks
from ..loads import bucket_of
from ..reference.features import BORDER

CENSUS_WINDOW = 11
MATCHERS_WINDOW = 5


def valid_entries(H: int, W: int, D: int, wsize: int = CENSUS_WINDOW,
                  margins: Tuple[int, int, int] = (0, 0, 0)):
    """(valid pixels, valid (d, pixel) entries) of the published mask:
    rows and cols [wc, n - wsize + wc), d <= col - wc; inside the volume
    that the margins (board_h, board_w_left, board_w_right) leave."""
    bh, bwl, bwr = margins
    wc = wsize // 2
    rows = max(0, min(H - bh, H - wsize + wc) - max(bh, wc))
    cols = range(max(bwl, wc), min(W - bwr, W - wsize + wc))
    return rows * len(cols), rows * sum(min(D, c - wc + 1) for c in cols)


def _bound(nbytes: float, **ops) -> Dict[str, float]:
    """``ops``: {name: (count, rate)}."""
    t_bytes = nbytes / peaks.HBM_BYTES_PER_S
    t_ops = max(n / rate for n, rate in ops.values())
    out = {"bytes": nbytes, **{k: n for k, (n, _) in ops.items()}}
    out.update(bound_s=max(t_bytes, t_ops),
               bound_by="bytes" if t_bytes >= t_ops else "operations")
    return out


def census_aml(H: int, W: int, D: int) -> Dict[str, float]:
    pixels, entries = valid_entries(H, W, D)
    return _bound(2 * H * W + 2 * D * H * W * 2,
                  sfu_ops=(4 * entries + D * pixels, peaks.SFU_OPS_PER_S),
                  alu_ops=(7 * entries + 8 * D * H * W, peaks.F32_FLOPS))


def matchers_aml(H: int, W: int, D: int,
                 margins: Tuple[int, int, int]) -> Dict[str, float]:
    bh, bwl, bwr = margins
    ho, wo = H - 2 * bh, W - bwl - bwr
    entries = valid_entries(H, W, D, MATCHERS_WINDOW, margins)[1]
    return _bound(2 * H * W + 2 * D * ho * wo * 4 + 8 * D * ho * wo * 2,
                  alu_ops=(140 * entries + 24 * D * ho * wo,
                           peaks.F32_FLOPS))


def working_shape(cell) -> Tuple[int, int, int, Tuple[int, int, int]]:
    """(H, W, D, margins) of the half-resolution pair that each sample's
    feature stage works on: the bucket with its test-time border when
    serving, the crop with its margins in training."""
    m, mc = cell.config["matching"], cell.config["model"]
    s, D = m["ds_scale"], mc["max_disp"] // m["ds_scale"]
    if cell.kind == "train":
        ch, cw = cell.mix["crop"]
        return ((ch + 2 * m["board_h"]) // s, (cw + mc["max_disp"]) // s, D,
                (m["board_h"] // s, mc["max_disp"] // s, 0))
    (bh, bw), = {bucket_of(h, w, mc["encoder_ds"])
                 for h, w, _ in cell.mix["sizes"]}
    return (bh // s + 2 * BORDER, bw // s + 2 * BORDER, D, (BORDER,) * 3)


def census_launch_shape(cell) -> Tuple[int, int, int]:
    """[H, W, D] of each ``census_aml`` launch of the cell."""
    return working_shape(cell)[:3]


def matchers_launch_shape(cell):
    """(H, W, D, margins) of each ``matchers_aml`` launch of the cell."""
    return working_shape(cell)


KERNELS = {"census_aml": (census_aml, census_launch_shape),
           "matchers_aml": (matchers_aml, matchers_launch_shape)}
