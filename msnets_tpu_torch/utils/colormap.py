"""KITTI-2015 disparity and error colorizations (vectorized NumPy): the
port's copy of ``msnets_tpu/utils/colormap.py``.

Ports of the reference's Cython kernels (reference:
src/cython/writeKT15FalseColor.pyx:27-82 and
src/cython/writeKT15ErrorLogColor.pyx:32-71): table lookups, no native code.
``jet_color`` imports OpenCV when it is called, not before.
"""
from __future__ import annotations

import numpy as np

_KT15_CLR = np.array(
    [[0, 0, 0, 114], [0, 0, 1, 185], [1, 0, 0, 114], [1, 0, 1, 174],
     [0, 1, 0, 114], [0, 1, 1, 185], [1, 1, 0, 114], [1, 1, 1, 0]],
    dtype=np.float32)

_LOG_CLR = np.array(
    [[0, 0.0625, 49, 54, 149],
     [0.0625, 0.125, 69, 117, 180],
     [0.125, 0.25, 116, 173, 209],
     [0.25, 0.5, 171, 217, 233],
     [0.5, 1, 224, 243, 248],
     [1, 2, 254, 224, 144],
     [2, 4, 253, 174, 97],
     [4, 8, 244, 109, 67],
     [8, 16, 215, 48, 39],
     [16, 1e9, 165, 0, 38]], dtype=np.float32)


def kt15_false_color(disp: np.ndarray, max_disp: float = -1.0) -> np.ndarray:
    """Disparity -> KITTI false-color RGB float map [H, W, 3] in [0, 255]."""
    disp = np.asarray(disp, np.float32)
    s = _KT15_CLR[:, 3].sum()
    weights = np.zeros(8, np.float32)
    cumsum = np.zeros(8, np.float32)
    with np.errstate(divide="ignore"):
        weights[:7] = s / _KT15_CLR[:7, 3]
    cumsum[1:8] = np.cumsum(_KT15_CLR[:7, 3] / s)
    max_val = float(max_disp) if max_disp > 0 else float(disp.max())
    if max_val <= 0:
        max_val = 1.0
    val = np.clip(disp / max_val, 0.0, 1.0)
    k = np.minimum(np.searchsorted(cumsum[1:8], val, side="right"), 6)
    w = 1.0 - (val - cumsum[k]) * weights[k]
    w3 = w[..., None]
    rgb = (w3 * _KT15_CLR[k, :3] + (1.0 - w3) * _KT15_CLR[k + 1, :3]) * 255.0
    return rgb.astype(np.float32)


def kt15_error_log_color(disp: np.ndarray, disp_gt: np.ndarray) -> np.ndarray:
    """|pred-gt| -> KITTI log-binned error colors [H, W, 3] in [0, 255].

    n_err = min(|d-gt|/3, 20|d-gt|/|gt|); colored only on the interior
    (1..H-2, 1..W-2) where gt > 0, like the reference.
    """
    disp = np.asarray(disp, np.float32)
    gt = np.asarray(disp_gt, np.float32)
    H, W = disp.shape
    out = np.zeros((H, W, 3), np.float32)
    d_err = np.abs(disp - gt)
    with np.errstate(divide="ignore", invalid="ignore"):
        n_err = np.minimum(d_err / 3.0, 20.0 * d_err / np.abs(gt))
    bins = np.searchsorted(_LOG_CLR[:, 1], n_err, side="right")
    bins = np.minimum(bins, 9)
    colors = _LOG_CLR[bins, 2:5]
    valid = gt > 0
    interior = np.zeros((H, W), bool)
    interior[1:H - 1, 1:W - 1] = True
    m = valid & interior
    out[m] = colors[m]
    return out


def jet_color(img: np.ndarray) -> np.ndarray:
    """cv2 jet colormap on a uint8-scaled image -> RGB uint8 [H, W, 3]."""
    import cv2
    return cv2.cvtColor(cv2.applyColorMap(np.uint8(img), 2), cv2.COLOR_BGR2RGB)
