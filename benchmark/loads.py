"""The one traffic generator: it reads a mix's parameters from
``traffic/<mix>.json`` and makes, from the run's seed, the pool of inputs
and the order in which they are sent.

Pairs are textured and carry a slanted-plane disparity field: the right
image is uniform uint8 noise, the left image samples it (linearly) at
x - d(x, y), where d is the plane through three corner disparities drawn
from ``disparity_px`` and clipped to it. ``channels`` (default 1: grey
[H, W] images) above 1 makes colour [H, W, C] pairs on the same planes.
Every seed gives the same sizes in the same proportions; only their order,
the textures and the planes change.

Mix kinds:
  * ``closed_loop`` and ``stream`` (serving): a pool of ``pool`` pairs of
    ``frame`` size; request i is a pool pair cropped to the i-th size of a
    sequence made of blocks of ``sizes`` ([h, w, count] entries), each
    block shuffled;
  * ``train``: a pool of ``pool`` batches of ``batch`` crops with their
    margins, as the train pipeline cuts them ([crop_h + 2 board_h,
    crop_w + board_w_left + board_w_right] uint8 pairs and
    [crop_h, crop_w] float32 targets); the margins are the configuration's
    reference system's. ``batch`` is the global batch; with ``mesh``
    ([data, spatial, disp], one rank a card) each data index takes its
    share of it.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np

TRAFFIC_DIR = Path(__file__).resolve().parent / "traffic"


def load(name: str) -> dict:
    with open(TRAFFIC_DIR / f"{name}.json") as f:
        return json.load(f)


def rng(seed: int, stream: int) -> np.random.Generator:
    """The generator of one of a seed's independent streams (1: traffic)."""
    return np.random.default_rng([int(seed), stream])


def bucket_of(h: int, w: int, multiple: int) -> Tuple[int, int]:
    """The size a frame of h x w pads to."""
    return (h + (-h) % multiple, w + (-w) % multiple)


def pad_to_bucket(iml: np.ndarray, imr: np.ndarray, multiple: int
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Zero-pad a pair, [H, W] or [H, W, C], on top and right to the next
    multiple of ``multiple`` (the published test padding)."""
    h, w = iml.shape[:2]
    ph, pw = (-h) % multiple, (-w) % multiple
    pad = ((ph, 0), (0, pw)) + ((0, 0),) * (iml.ndim - 2)
    return np.pad(iml, pad), np.pad(imr, pad)


def slanted_pair(r: np.random.Generator, H: int, W: int, lo: float,
                 hi: float, channels: int = 1
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(left uint8, right uint8, disparity float32 [H, W]); the images
    [H, W] (``channels`` 1) or [H, W, channels]; left[y, x] sees
    right[y, x - d(x, y)]."""
    c = r.uniform(lo, hi, 3)
    x = np.arange(W, dtype=np.float64)
    y = np.arange(H, dtype=np.float64)
    d = (c[0] + (c[1] - c[0]) * x[None, :] / max(W - 1, 1)
         + (c[2] - c[0]) * y[:, None] / max(H - 1, 1))
    d = np.clip(d, lo, hi)
    margin = int(np.ceil(hi)) + 1
    size = (H, W + margin + 1) + ((channels,) if channels > 1 else ())
    base = r.integers(0, 256, size, dtype=np.uint8)
    src = margin + x[None, :] - d
    i0 = np.floor(src).astype(np.int64)
    f = src - i0
    if channels > 1:
        i0, f = i0[..., None], f[..., None]
    b = base.astype(np.float64)
    left = ((1 - f) * np.take_along_axis(b, i0, 1)
            + f * np.take_along_axis(b, i0 + 1, 1))
    return (np.rint(left).astype(np.uint8),
            np.ascontiguousarray(base[:, margin:margin + W]),
            d.astype(np.float32))


class Serving:
    """A serving mix: ``pairs`` (the pool) and ``request(i)``."""

    def __init__(self, mix: dict, seed: int):
        self.mix = mix
        r = rng(seed, 1)
        H, W = mix["frame"]
        lo, hi = mix["disparity_px"]
        c = mix.get("channels", 1)
        self.pairs = [slanted_pair(r, H, W, lo, hi, c)[:2]
                      for _ in range(mix["pool"])]
        self.block = [(h, w) for h, w, n in mix["sizes"] for _ in range(n)]
        self._r = r
        self._order: List[Tuple[int, int, int]] = []

    @property
    def shapes(self) -> List[Tuple[int, int]]:
        return sorted({tuple(s) for s in self.block})

    def request(self, i: int) -> Tuple[int, int, int]:
        """(pool index, h, w) of request i."""
        while len(self._order) <= i:
            sizes = [self.block[j] for j in self._r.permutation(len(self.block))]
            pool = self._r.permutation(len(self.pairs))
            for k, (h, w) in enumerate(sizes):
                self._order.append((int(pool[k % len(pool)]), h, w))
        return self._order[i]

    def pair(self, i: int) -> Tuple[np.ndarray, np.ndarray]:
        k, h, w = self.request(i)
        left, right = self.pairs[k]
        return (np.ascontiguousarray(left[:h, :w]),
                np.ascontiguousarray(right[:h, :w]))


class Training:
    """A train mix: ``batches`` (the pool), each a dict as the train
    pipeline yields it."""

    def __init__(self, mix: dict, seed: int, margins: Tuple[int, int, int]):
        self.mix = mix
        r = rng(seed, 1)
        ch, cw = mix["crop"]
        board_h, bwl, bwr = margins
        H, W = ch + 2 * board_h, cw + bwl + bwr
        lo, hi = mix["disparity_px"]
        c = mix.get("channels", 1)
        self.batches: List[Dict] = []
        for _ in range(mix["pool"]):
            ls, rs, ds = zip(*(slanted_pair(r, H, W, lo, hi, c)
                               for _ in range(mix["batch"])))
            self.batches.append({
                "iml": np.stack(ls), "imr": np.stack(rs),
                "disp": np.ascontiguousarray(
                    np.stack(ds)[:, board_h:board_h + ch, bwl:bwl + cw]),
                "board_h": board_h, "board_w_left": bwl,
                "board_w_right": bwr})


def make(mix: dict, seed: int, margins: Tuple[int, int, int] = (0, 0, 0)):
    """The mix's traffic; ``margins`` those of a train crop."""
    if mix["kind"] == "train":
        return Training(mix, seed, margins)
    return Serving(mix, seed)
