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

The server runs MS-GCNet or MS-PSMNet (``cfg.model.name``) in
``cfg.model.compute_dtype``. In bfloat16 the BatchNorm affines are folded
into the conv and deconv weights in float32 and cast once (the JAX eval
math); the children a model names in ``FLOAT32_CHILDREN`` stay float32
(MS-GCNet's head, deconv5; MS-PSMNet casts to float32 for its upsample and
softmax itself). Multi-GPU serving is not ported yet (ROADMAP).

Throughput comes from pipelining (``predict_stream``): up to ``depth`` frames
are in flight. The host pads frame k+1 into a pinned buffer and queues its
copy and forward on the compute stream while the device runs frame k; the
disparity is copied back into a pinned buffer on a copy stream that waits
on an event recorded after the forward, and a fetcher thread waits on the
copies and crops the results.

Usage:
    server = StereoServer(cfg, state_dict)        # or .from_checkpoint(...)
    server.warmup([(375, 1242)])
    disp = server.predict(iml, imr)               # one frame, blocking
    for d in server.predict_stream(pairs):        # pipelined, in input order
        ...
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, Iterable, Iterator, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from .config import Config
from .models import build_model, compute_dtype, fold_batchnorm
from .ops.features import ms_features_test
from .runtime import DeviceLike, resolve_device

DEFAULT_BUCKETS: Tuple[Tuple[int, int], ...] = (
    (256, 512), (384, 1248), (576, 960))


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


class _Slot:
    """Host buffers of one frame in flight: the padded pair going in and the
    bucket's disparity coming back; pinned when the server is on a GPU."""

    def __init__(self, bucket: Tuple[int, int], pin: bool):
        self.pair = torch.empty((2,) + tuple(bucket), dtype=torch.uint8,
                                pin_memory=pin)
        self.out = torch.empty(tuple(bucket), dtype=torch.float32,
                               pin_memory=pin)


class StereoServer:
    """Stereo-disparity inference on one device. ``predict`` is safe to call
    from several threads (the statistics are locked; the device work is
    PyTorch's); ``predict_stream`` is the pipelined bulk path, with up to
    ``depth`` frames in flight."""

    def __init__(self, cfg: Config, state_dict: Mapping[str, torch.Tensor],
                 buckets: Optional[Sequence[Tuple[int, int]]] = None,
                 device: DeviceLike = None, depth: int = 2):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.buckets = tuple(tuple(b) for b in buckets) if buckets else None
        self.depth = max(1, depth)
        self.dtype = compute_dtype(cfg.model)
        model = build_model(cfg.model, self.device)
        model.load_state_dict(state_dict)
        self.model = fold_batchnorm(model)
        for name, module in self.model.named_children():
            if name not in model.FLOAT32_CHILDREN:
                module.to(self.dtype)
        self._lock = threading.Lock()
        self._stats = {"frames": 0, "bucket_hits": {}}
        self._warm = set()
        self._slots: Dict[Tuple[int, int], "queue.Queue[_Slot]"] = {}
        self._copy_stream = (torch.cuda.Stream(self.device)
                             if self.device.type == "cuda" else None)

    @classmethod
    def from_checkpoint(cls, cfg: Config, path: str, **kw) -> "StereoServer":
        """A server with the weights of one of the port's checkpoints or of
        a reference ``.tar`` (through ``Trainer.resume``); ``kw`` as
        ``__init__`` takes them."""
        from .engine.trainer import Trainer
        tr = Trainer(cfg, device=kw.get("device"))
        tr.resume(path)
        return cls(cfg, tr.model.state_dict(), **kw)

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

    def _count(self, bucket: Tuple[int, int]) -> None:
        with self._lock:
            self._stats["frames"] += 1
            hits = self._stats["bucket_hits"]
            hits[bucket] = hits.get(bucket, 0) + 1

    def predict(self, iml: np.ndarray, imr: np.ndarray) -> np.ndarray:
        """One frame, blocking: uint8 [H, W] pair -> float32 [H, W]
        disparity at the original resolution."""
        h, w = iml.shape
        bucket = pick_bucket(h, w, self.buckets, self.cfg.model.encoder_ds)
        il, ir = pad_to_bucket(iml, imr, bucket)
        disp = self.forward(torch.from_numpy(il).to(self.device),
                            torch.from_numpy(ir).to(self.device))[0]
        out = disp[bucket[0] - h:, :w].cpu().numpy()
        self._count(bucket)
        return np.ascontiguousarray(out, dtype=np.float32)

    # -- pipelined stream -------------------------------------------------

    def _slot(self, bucket: Tuple[int, int]) -> _Slot:
        """A free slot of ``bucket``'s pool of ``depth``; blocks until the
        fetcher has released one."""
        with self._lock:
            pool = self._slots.get(bucket)
            if pool is None:
                pool = self._slots[bucket] = queue.Queue()
                for _ in range(self.depth):
                    pool.put(_Slot(bucket, self.device.type == "cuda"))
        return pool.get()

    def _launch(self, iml: np.ndarray, imr: np.ndarray):
        """Pad one frame into a slot and queue its host-to-device copy, its
        forward and its device-to-host copy; returns (slot, copied event or
        None on the CPU, h, w, bucket) without waiting for the device."""
        h, w = iml.shape
        bucket = pick_bucket(h, w, self.buckets, self.cfg.model.encoder_ds)
        il, ir = pad_to_bucket(iml, imr, bucket)
        slot = self._slot(bucket)
        try:
            slot.pair[0].numpy()[...] = il
            slot.pair[1].numpy()[...] = ir
            with torch.inference_mode():
                pair = slot.pair.to(self.device, non_blocking=True)
                disp = self.forward(pair[0], pair[1])[0]
                copied = None
                if self._copy_stream is None:
                    slot.out.copy_(disp)
                else:
                    done = torch.cuda.current_stream(self.device).record_event()
                    with torch.cuda.stream(self._copy_stream):
                        self._copy_stream.wait_event(done)
                        slot.out.copy_(disp, non_blocking=True)
                        # disp was made on the compute stream: its memory
                        # must not be reused before this copy has read it
                        disp.record_stream(self._copy_stream)
                        copied = self._copy_stream.record_event()
        except BaseException:
            self._slots[bucket].put(slot)
            raise
        self._count(bucket)
        return slot, copied, h, w, bucket

    def _finish(self, slot: _Slot, copied, h: int, w: int,
                bucket: Tuple[int, int]) -> np.ndarray:
        """Wait for a launched frame's copy, crop its disparity and release
        its slot."""
        try:
            if copied is not None:
                copied.synchronize()
            # a copy: the slot's buffer is the next frame's
            return slot.out.numpy()[bucket[0] - h:, :w].copy()
        finally:
            self._slots[bucket].put(slot)

    def predict_stream(self, pairs: Iterable[Tuple[np.ndarray, np.ndarray]]
                       ) -> Iterator[np.ndarray]:
        """Pipelined inference over uint8 pairs, up to ``depth`` frames in
        flight; yields float32 disparities in input order. A frame that
        fails raises its error at its place in the order. Abandoning the
        generator drains the frames in flight and stops the fetcher."""
        q: "queue.Queue" = queue.Queue(maxsize=self.depth)
        results: "queue.Queue" = queue.Queue()
        done = object()

        def fetcher():
            # never stops draining q on an item's error: a producer blocked
            # in q.put would otherwise wait forever
            while True:
                item = q.get()
                if item is done:
                    results.put(done)
                    return
                try:
                    results.put(item if isinstance(item, Exception)
                                else self._finish(*item))
                except Exception as e:
                    results.put(e)

        thread = threading.Thread(target=fetcher, name="predict_stream fetcher",
                                  daemon=True)
        thread.start()
        pending = 0

        def next_result():
            r = results.get()
            if isinstance(r, Exception):
                raise r
            return r

        try:
            for iml, imr in pairs:
                try:
                    item = self._launch(iml, imr)
                except Exception as e:            # this frame's result
                    item = e
                q.put(item)
                pending += 1
                while pending > self.depth and not results.empty():
                    pending -= 1
                    yield next_result()
            while pending:
                pending -= 1
                yield next_result()
        finally:
            # normal end, an error, or the consumer abandoning the generator
            # (GeneratorExit): stop the fetcher after the frames in flight
            q.put(done)
            while results.get() is not done:
                pass
            thread.join()

    def stats(self) -> Dict:
        with self._lock:
            return {"frames": self._stats["frames"],
                    "bucket_hits": dict(self._stats["bucket_hits"]),
                    "warm_buckets": sorted(self._warm)}
