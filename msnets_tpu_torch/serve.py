"""Shape-bucketed stereo serving on the GPU (counterpart of
``msnets_tpu/serve.py``).

A request is a uint8 [H, W] pair. It is zero-padded on top and right to a
bucket shape (``pick_bucket``), goes through the feature stage and the model
on the device, and the disparity is cropped back to [H, W].

Two bucketing modes, as in the JAX server:

* **exact** (default, ``buckets=None``): every frame is padded to its
  minimal multiple of ``encoder_ds`` (the reference's test padding).
* **explicit buckets**: frames are padded to the smallest configured bucket
  that covers them. This is not numerically identical to minimal padding:
  the padded band's features are non-zero, so outputs near the top and
  right edge shift slightly.

The feature stage follows ``cfg.matching``: the 8-channel matching space
(the default), the 16-channel left+right one (``num_channels=16``) or the
2-channel raw-intensity volume (``features_mode="raw"``); the model's
``in_channels`` must be ``cfg.matching.feature_channels``.

The server runs in ``cfg.model.compute_dtype``. In bfloat16 the BatchNorm
affines are folded into the conv and deconv weights in float32 and cast
once (the JAX eval math); the head (deconv5, softmax, soft-argmin) stays
float32. Pipelined streaming, checkpoints and multi-GPU serving are not
ported yet (ROADMAP).

Usage:
    server = StereoServer(cfg, state_dict)        # on the GPU
    server.warmup([(375, 1242)])
    disp = server.predict(iml, imr)
"""
from __future__ import annotations

import threading
from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from .config import Config
from .models import build_model, fold_batchnorm
from .ops.features import ms_features_test
from .runtime import DeviceLike, resolve_device

DEFAULT_BUCKETS: Tuple[Tuple[int, int], ...] = (
    (256, 512), (384, 1248), (576, 960))

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def exact_bucket(h: int, w: int, encoder_ds: int = 32) -> Tuple[int, int]:
    """Minimal pad-to-multiple-of-encoder_ds shape (reference parity)."""
    return (h + (encoder_ds - h % encoder_ds) % encoder_ds,
            w + (encoder_ds - w % encoder_ds) % encoder_ds)


def pick_bucket(h: int, w: int,
                buckets: Optional[Sequence[Tuple[int, int]]],
                encoder_ds: int = 32) -> Tuple[int, int]:
    """Smallest-area configured bucket covering (h, w); the exact
    pad-to-multiple shape when there are no buckets or none covers."""
    fits = [b for b in (buckets or ()) if b[0] >= h and b[1] >= w]
    if fits:
        return min(fits, key=lambda b: b[0] * b[1])
    return exact_bucket(h, w, encoder_ds)


def pad_to_bucket(iml: np.ndarray, imr: np.ndarray,
                  bucket: Tuple[int, int]) -> Tuple[np.ndarray, np.ndarray]:
    """Zero-pad a uint8 pair on TOP and RIGHT to the bucket shape."""
    h, w = iml.shape
    ph, pw = bucket[0] - h, bucket[1] - w
    if ph < 0 or pw < 0:
        raise ValueError(f"frame {iml.shape} larger than bucket {bucket}")
    pad = ((ph, 0), (0, pw))
    return np.pad(iml, pad), np.pad(imr, pad)


class StereoServer:
    """Stereo-disparity inference on one device. ``predict`` is safe to call
    from several threads (the statistics are locked; the device work is
    PyTorch's)."""

    def __init__(self, cfg: Config, state_dict: Mapping[str, torch.Tensor],
                 buckets: Optional[Sequence[Tuple[int, int]]] = None,
                 device: DeviceLike = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.buckets = tuple(tuple(b) for b in buckets) if buckets else None
        if cfg.model.compute_dtype not in _DTYPES:
            raise ValueError(f"compute_dtype={cfg.model.compute_dtype!r}")
        self.dtype = _DTYPES[cfg.model.compute_dtype]
        model = build_model(cfg.model, self.device)
        model.load_state_dict(state_dict)
        self.model = fold_batchnorm(model)
        for name, module in self.model.named_children():
            if name != "deconv5":                  # the head stays float32
                module.to(self.dtype)
        self._lock = threading.Lock()
        self._stats = {"frames": 0, "bucket_hits": {}}
        self._warm = set()

    def features(self, iml: torch.Tensor, imr: torch.Tensor) -> torch.Tensor:
        """Device uint8 bucket-shaped pair -> feature volume [C, D, H, W]
        in the compute dtype."""
        m = self.cfg.matching
        return ms_features_test(iml, imr, self.cfg.model.max_disp, m,
                                m.left_only, self.dtype)

    @torch.inference_mode()
    def forward(self, iml: torch.Tensor, imr: torch.Tensor) -> torch.Tensor:
        """Device uint8 bucket-shaped pair -> disparity [1, H, W] float32."""
        return self.model(self.features(iml, imr)[None])

    def warmup(self, shapes: Sequence[Tuple[int, int]] = ()) -> None:
        """Run one zero pair through every configured bucket and through the
        bucket of each given frame shape (builds the kernel library and
        cuDNN's plans before the first request)."""
        enc = self.cfg.model.encoder_ds
        todo = list(self.buckets or ()) + [
            pick_bucket(h, w, self.buckets, enc) for h, w in shapes]
        for bucket in todo:
            zero = torch.zeros(bucket, dtype=torch.uint8, device=self.device)
            self.forward(zero, zero)
            with self._lock:
                self._warm.add(tuple(bucket))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def predict(self, iml: np.ndarray, imr: np.ndarray) -> np.ndarray:
        """One frame, blocking: uint8 [H, W] pair -> float32 [H, W]
        disparity at the original resolution."""
        h, w = iml.shape
        bucket = pick_bucket(h, w, self.buckets, self.cfg.model.encoder_ds)
        il, ir = pad_to_bucket(iml, imr, bucket)
        disp = self.forward(torch.from_numpy(il).to(self.device),
                            torch.from_numpy(ir).to(self.device))[0]
        out = disp[bucket[0] - h:, :w].cpu().numpy()
        with self._lock:
            self._stats["frames"] += 1
            hits = self._stats["bucket_hits"]
            hits[bucket] = hits.get(bucket, 0) + 1
        return np.ascontiguousarray(out, dtype=np.float32)

    def stats(self) -> Dict:
        with self._lock:
            return {"frames": self._stats["frames"],
                    "bucket_hits": dict(self._stats["bucket_hits"]),
                    "warm_buckets": sorted(self._warm)}
