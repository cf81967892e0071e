"""PFM (portable float map) I/O: the port's copy of
``msnets_tpu/data/pfm.py``.

Format parity with the reference reader/writer (reference: src/pfmutil.py:
48-110): header 'Pf' (gray) / 'PF' (color), dims line, scale line whose sign
encodes endianness, rows stored bottom-up (flipud on read/write).
"""
from __future__ import annotations

import re
import sys

import numpy as np


def read_pfm(path: str) -> np.ndarray:
    """Read a PFM file -> float32 array [H, W] (gray) or [H, W, 3] (color)."""
    with open(path, "rb") as f:
        header = f.readline().decode("latin-1").strip()
        if header == "PF":
            channels = 3
        elif header == "Pf":
            channels = 1
        else:
            raise ValueError(f"{path}: not a PFM file (header {header!r})")
        dims = f.readline().decode("latin-1")
        m = re.findall(r"\d+", dims)
        if len(m) < 2:
            raise ValueError(f"{path}: malformed PFM dims line {dims!r}")
        width, height = int(m[0]), int(m[1])
        scale = float(f.readline().decode("latin-1").strip())
        endian = "<" if scale < 0 else ">"
        data = np.frombuffer(f.read(width * height * channels * 4),
                             dtype=endian + "f4")
        shape = (height, width, 3) if channels == 3 else (height, width)
        img = np.flipud(data.reshape(shape)).astype(np.float32)
    return np.ascontiguousarray(img)


def write_pfm(path: str, image: np.ndarray, scale: float = 1.0) -> None:
    """Write a float32 array as PFM (little-endian, flipped rows)."""
    image = np.asarray(image)
    if image.dtype != np.float32:
        raise ValueError("PFM image dtype must be float32")
    if image.ndim == 3 and image.shape[2] == 3:
        color = True
    elif image.ndim == 2 or (image.ndim == 3 and image.shape[2] == 1):
        color = False
        image = image.reshape(image.shape[0], image.shape[1])
    else:
        raise ValueError("image must be HxW, HxWx1 or HxWx3")
    little = image.dtype.byteorder == "<" or (
        image.dtype.byteorder in ("=", "|") and sys.byteorder == "little")
    with open(path, "wb") as f:
        f.write(b"PF\n" if color else b"Pf\n")
        f.write(f"{image.shape[1]} {image.shape[0]}\n".encode())
        f.write(f"{-scale if little else scale:f}\n".encode())
        np.flipud(image).tofile(f)
