"""Least bytes and operations of the port's hand kernels, and the least
time they allow on the H100 (``peaks``).

``census_aml`` (channels 0 and 4 of the feature volume from a uint8 pair
at the half-resolution working shape [H, W] with D disparities): the two
images read once (2*H*W bytes) and the two [D, H, W] planes written once
at 2 bytes a value, the bfloat16 the model reads them in. Operations:
4 popcounts a valid (d, pixel) entry and one exponential an entry of a
pixel with a valid minimum (the special-function units), 7 integer or
float operations a valid entry and 8 an output entry (the float32 rate).
The least time is the larger of bytes over the HBM rate and the
operations at their rates.
"""
from __future__ import annotations

from typing import Dict

from . import peaks

CENSUS_WINDOW = 11


def valid_entries(H: int, W: int, D: int, wsize: int = CENSUS_WINDOW):
    """(valid pixels, valid (d, pixel) entries) of the published census
    mask: rows and cols [wc, n - wsize + wc), d <= col - wc."""
    rows, cols = max(0, H - wsize), max(0, W - wsize)
    per_row = sum(min(D, k) for k in range(1, cols + 1))
    return rows * cols, rows * per_row


def census_aml(H: int, W: int, D: int) -> Dict[str, float]:
    pixels, entries = valid_entries(H, W, D)
    nbytes = 2 * H * W + 2 * D * H * W * 2
    sfu = 4 * entries + D * pixels
    alu = 7 * entries + 8 * D * H * W
    t_bytes = nbytes / peaks.HBM_BYTES_PER_S
    t_ops = max(sfu / peaks.SFU_OPS_PER_S, alu / peaks.F32_FLOPS)
    return {"bytes": nbytes, "sfu_ops": sfu, "alu_ops": alu,
            "bound_s": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


KERNELS = {"census_aml": census_aml}
