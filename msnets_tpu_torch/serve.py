"""Shape-bucketed stereo serving on the GPU (counterpart of
``msnets_tpu/serve.py``).

A request is a uint8 pair of the kind the model's feature stage takes (its
``STAGE``; the server never asks which model it runs): grey [H, W] for the
matching space of ``cfg.matching`` (``in_channels`` must be its
``feature_channels``), RGB [H, W, 3] for GC-Net's tower. It is zero-padded
on top and right to a bucket shape (``pick_bucket``), goes through the
feature stage and the model on the device, and the disparity is cropped
back to [H, W]; a pair of another kind raises ``ValueError``.

Two bucketing modes, as in the JAX server:

* **exact** (default, ``buckets=None``): every frame is padded to its
  minimal multiple of ``encoder_ds`` (the reference's test padding).
* **explicit buckets**: frames are padded to the smallest configured bucket
  that covers them. This is not numerically identical to minimal padding:
  the padded band's features are non-zero, so outputs near the top and
  right edge shift slightly.

The model runs in ``cfg.model.compute_dtype``, its BatchNorm affines folded
into the conv and deconv weights in float32 and cast once (the JAX eval
math; ``layers.cast_eval_model`` keeps a model's ``FLOAT32_CHILDREN`` and
the int8 convs' kernels float32).

With ``cfg.model.quant_eval`` the flagged convs run int8 (``models/quant.py``)
in ``cfg.model.quant_mode``. ``quant_stats`` is the JAX ``quant_stats``
collection as ``{dotted path: absmax}`` (``convert.quant_stats_from_jax``),
which the checkpoints never hold, checked as the JAX server checks it
(``_checked_quant_stats``); ``set_quant_mode("calib")`` is how the Evaluator
calibrates.

Over a mesh (``StereoServer(..., mesh=parallel.make_mesh((1, S, P)))``, one
process a GPU, every process running this server): every rank computes the
whole feature volume and keeps its block of it (``shard_volume``), the model
runs on the blocks of every volume with halo exchanges and a split
soft-argmin (``parallel/halo.py``, ``models/layers.py``), and every rank
returns the whole disparity. The ranks start from rank 0's weights
(broadcast over the mesh). The server is SPMD: every rank must make the same
requests (``predict``, ``predict_stream``, ``forward``, ``warmup``) in the
same order, since each forward runs collectives that all ranks must join;
a rank runs one forward at a time.

Throughput comes from pipelining (``predict_stream``): up to ``depth`` frames
are in flight. The host pads frame k+1 into a pinned buffer and queues its
copy and forward on the compute stream while the device runs frame k; the
disparity is copied back into a pinned buffer on a copy stream that waits
on an event recorded after the forward. With ``depth`` frames in flight a
launch first finishes the oldest (waits for its copy, crops it), then
queues its own, and only then is the result yielded, so the device has work
while the consumer takes it.

Usage:
    server = StereoServer(cfg, state_dict)        # or .from_checkpoint(...)
    server.warmup([(375, 1242)])
    disp = server.predict(iml, imr)               # one frame, blocking
    for d in server.predict_stream(pairs):        # pipelined, in input order
        ...

Where the time goes: serve under ``utils.profiling.trace(logdir)`` and open
``logdir/trace.json`` (Perfetto or chrome://tracing). Beside the host's ops
and the device's kernels and copies, on the same clock, it holds the
program's spans (``msn.*``; ``utils/profiling.py`` lists them): a request is
a ``server.predict`` (blocking) or ``server.launch`` (a stream frame) with
``server.pad``, ``server.slot_wait`` (a stream frame's wait for the oldest
in flight), ``server.h2d``, ``features`` and its matchers, ``regularizer``,
``server.d2h`` and ``server.crop`` inside. With no profiler recording a span
costs a flag check.

``stats()`` counts since construction:
  * ``frames``: frames served (blocking and streamed); ``bucket_hits`` the
    frames of each bucket;
  * ``warm_buckets``: the buckets ``warmup`` ran;
  * ``cold_frames``: frames served in a bucket ``warmup`` did not run; the
    first of each pays cuDNN's choice of plans and the allocator's growth
    (the JAX server's ``compiles``);
  * ``slot_waits``, ``slot_wait_s``: stream launches that found ``depth``
    frames in flight, and the seconds they took to finish the oldest
    (waiting for its copy back, cropping it), which frees its slot.
"""
from __future__ import annotations

import collections
import threading
import time
from typing import (Dict, Iterable, Iterator, List, Mapping, Optional,
                    Sequence, Tuple)

import numpy as np
import torch

from .config import Config
from .models import build_model, compute_dtype, fold_batchnorm
from .models import quant as Q
from .models.layers import cast_eval_model
from .parallel import mesh as pm
from .runtime import DeviceLike, resolve_device
from .utils.profiling import span

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
    """Zero-pad a uint8 pair, [H, W] or [H, W, C], on TOP and RIGHT to the
    bucket shape."""
    h, w = iml.shape[:2]
    ph, pw = bucket[0] - h, bucket[1] - w
    if ph < 0 or pw < 0:
        raise ValueError(f"frame {iml.shape} larger than bucket {bucket}")
    pad = ((ph, 0), (0, pw)) + ((0, 0),) * (iml.ndim - 2)
    return np.pad(iml, pad), np.pad(imr, pad)


def _checked_quant_stats(cfg: Config, quant_stats
                         ) -> Optional[Dict[str, float]]:
    """The JAX server's checks of ``quant_stats``: an all-zero mapping is
    uncalibrated (None); under ``quant_mode="static"`` zeros raise, naming
    the layers, and so does a missing calibration."""
    stats = None
    if quant_stats is not None and any(float(v) for v in quant_stats.values()):
        stats = {k: float(v) for k, v in quant_stats.items()}
    static = cfg.model.quant_eval and cfg.model.quant_mode == "static"
    if stats is not None and static:
        zero = sorted(k for k, v in stats.items() if v == 0)
        if zero:
            raise ValueError(
                f"StereoServer: quant_stats has zero (uncalibrated) absmax "
                f"for layers {zero}; calibrate on a more representative "
                "frame or disable quant_eval")
    if stats is None and static:
        raise ValueError(
            "StereoServer: quant_mode='static' needs calibrated quant_stats "
            "(serve some frames with set_quant_mode('calib') and pass "
            "quant_stats(), or let the Evaluator calibrate)")
    return stats


class _Slot:
    """Host buffers of one frame in flight: the padded pair going in and the
    bucket's disparity coming back; pinned when the server is on a GPU."""

    def __init__(self, bucket: Tuple[int, int], pin: bool,
                 pixel: Tuple[int, ...] = ()):
        self.pair = torch.empty((2,) + tuple(bucket) + pixel,
                                dtype=torch.uint8, pin_memory=pin)
        self.out = torch.empty(tuple(bucket), dtype=torch.float32,
                               pin_memory=pin)


class StereoServer:
    """Stereo-disparity inference on one device, or on one rank of a
    ``mesh`` (``parallel.Mesh``). Without a mesh ``predict`` is safe to
    call from several threads (the statistics are locked; the device work is
    PyTorch's); under a mesh the forwards of one rank run one at a time,
    and every rank must make the same calls in the same order (SPMD).
    ``predict_stream`` is the pipelined bulk path, with up to ``depth``
    frames in flight; a server runs one stream at a time."""

    def __init__(self, cfg: Config, state_dict: Mapping[str, torch.Tensor],
                 buckets: Optional[Sequence[Tuple[int, int]]] = None,
                 device: DeviceLike = None, depth: int = 2,
                 mesh: Optional[pm.Mesh] = None,
                 quant_stats: Optional[Mapping[str, float]] = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.buckets = tuple(tuple(b) for b in buckets) if buckets else None
        self.depth = max(1, depth)
        self.dtype = compute_dtype(cfg.model)
        stats = _checked_quant_stats(cfg, quant_stats)
        model = build_model(cfg.model, self.device)
        model.load_state_dict(state_dict)
        self.model = cast_eval_model(fold_batchnorm(model), self.dtype)
        if stats is not None:
            Q.load_quant_stats(self.model, stats)
        self.stage = self.model.STAGE(cfg, self.model)
        self.mesh = mesh
        if mesh is not None:
            pm.broadcast_module(self.model, mesh.group)
        # a forward's collectives must not interleave with another's
        self._forward_lock = threading.Lock()
        self._lock = threading.Lock()
        self._stats = {"frames": 0, "bucket_hits": {}, "cold_frames": 0,
                       "slot_waits": 0, "slot_wait_s": 0.0}
        self._warm = set()
        self._slots: Dict[Tuple[int, int], List[_Slot]] = {}
        self._copy_stream = (torch.cuda.Stream(self.device)
                             if self.device.type == "cuda" else None)

    @classmethod
    def from_checkpoint(cls, cfg: Config, path: str, **kw) -> "StereoServer":
        """A server with the weights of one of the port's checkpoints, of a
        reference ``.tar`` or of the JAX package's ``.msgpack`` (through
        ``Trainer.resume``); ``kw`` as ``__init__`` takes them."""
        from .engine.trainer import Trainer
        tr = Trainer(cfg, device=kw.get("device"))
        tr.resume(path)
        return cls(cfg, tr.model.state_dict(), **kw)

    def set_quant_mode(self, mode: str) -> None:
        """Switch the int8 convs to ``mode`` ("dynamic", "static" or
        "calib"): a request served in "calib" computes in the compute dtype
        and widens each conv's recorded absmax (``quant_stats``)."""
        Q.set_quant_mode(self.model, mode)

    def quant_stats(self, recorded: bool = False) -> Dict[str, float]:
        """Each int8 conv's recorded input absmax, by its JAX quant_stats
        path (``block_3d_1.convbn_3d_1``, ...); with ``recorded`` only the
        convs that recorded since ``set_quant_mode("calib")``."""
        return Q.quant_stats(self.model, recorded)

    def features(self, iml: torch.Tensor, imr: torch.Tensor) -> torch.Tensor:
        """Device uint8 bucket-shaped pair of the stage's kind -> feature
        volume [C, D, H, W] in the compute dtype."""
        with span("features"):
            return self.stage.serve(iml, imr)

    @torch.inference_mode()
    def forward(self, iml: torch.Tensor, imr: torch.Tensor) -> torch.Tensor:
        """Device uint8 bucket-shaped pair -> disparity [1, H, W] float32
        (the whole map on every rank of a mesh)."""
        if self.mesh is None:
            volume = self.features(iml, imr)[None]
            with span("regularizer"):
                return self.model(volume)
        with self._forward_lock:
            volume = pm.shard_volume(self.features(iml, imr)[None], self.mesh)
            with span("regularizer"):
                disp = self.model(volume)
            return pm.gather_volume(disp)

    def warmup(self, shapes: Sequence[Tuple[int, int]] = ()) -> None:
        """Run one zero pair through every configured bucket and through the
        bucket of each given frame shape (builds the kernel library and
        cuDNN's plans before the first request)."""
        enc = self.cfg.model.encoder_ds
        todo = list(self.buckets or ()) + [
            pick_bucket(h, w, self.buckets, enc) for h, w in shapes]
        for bucket in todo:
            zero = torch.zeros(tuple(bucket) + self.stage.pixel,
                               dtype=torch.uint8, device=self.device)
            self.forward(zero, zero)
            with self._lock:
                self._warm.add(tuple(bucket))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _count(self, bucket: Tuple[int, int]) -> None:
        with self._lock:
            self._stats["frames"] += 1
            self._stats["cold_frames"] += bucket not in self._warm
            hits = self._stats["bucket_hits"]
            hits[bucket] = hits.get(bucket, 0) + 1

    def _pad(self, iml: np.ndarray, imr: np.ndarray):
        """A pair of the stage's kind (module docstring) -> (H, W, its
        bucket, the pair padded to it)."""
        if iml.shape != imr.shape or iml.shape[2:] != self.stage.pixel:
            raise ValueError(f"{self.cfg.model.name} takes "
                             f"{self.stage.pairs} pairs of one shape, got "
                             f"{iml.shape} and {imr.shape}")
        h, w = iml.shape[:2]
        with span("server.pad"):
            bucket = pick_bucket(h, w, self.buckets,
                                 self.cfg.model.encoder_ds)
            return (h, w, bucket) + pad_to_bucket(iml, imr, bucket)

    def predict(self, iml: np.ndarray, imr: np.ndarray) -> np.ndarray:
        """One frame, blocking: a uint8 pair of the stage's kind -> float32
        [H, W] disparity at the original resolution."""
        with span("server.predict"):
            h, w, bucket, il, ir = self._pad(iml, imr)
            with span("server.h2d"):
                il = torch.from_numpy(il).to(self.device)
                ir = torch.from_numpy(ir).to(self.device)
            disp = self.forward(il, ir)[0]
            with span("server.d2h"):
                out = disp[bucket[0] - h:, :w].cpu().numpy()
            self._count(bucket)
            with span("server.crop"):
                return np.ascontiguousarray(out, dtype=np.float32)

    # -- pipelined stream -------------------------------------------------

    def _slot(self, bucket: Tuple[int, int]) -> _Slot:
        """A free slot of ``bucket``'s pool of ``depth`` (one always is)."""
        pool = self._slots.get(bucket)
        if pool is None:
            pool = self._slots[bucket] = [
                _Slot(bucket, self.device.type == "cuda", self.stage.pixel)
                for _ in range(self.depth)]
        return pool.pop()

    def _launch(self, iml: np.ndarray, imr: np.ndarray,
                flight: collections.deque, done: collections.deque):
        """Pad a frame; while ``depth`` frames are in ``flight``, finish the
        oldest into ``done`` (the slot wait); queue the frame's copies and
        forward from a slot. Returns (slot, copied event or None on the
        CPU, h, w, bucket) without waiting for the device."""
        with span("server.launch"):
            h, w, bucket, il, ir = self._pad(iml, imr)
            if len(flight) >= self.depth:
                t0 = time.perf_counter()
                with span("server.slot_wait"):
                    while len(flight) >= self.depth:
                        done.append(self._finish(flight.popleft()))
                with self._lock:
                    self._stats["slot_waits"] += 1
                    self._stats["slot_wait_s"] += time.perf_counter() - t0
            slot = self._slot(bucket)
            try:
                with torch.inference_mode():
                    with span("server.h2d"):
                        slot.pair[0].numpy()[...] = il
                        slot.pair[1].numpy()[...] = ir
                        pair = slot.pair.to(self.device, non_blocking=True)
                    disp = self.forward(pair[0], pair[1])[0]
                    with span("server.d2h"):
                        copied = self._copy_back(slot, disp)
            except BaseException:
                self._slots[bucket].append(slot)
                raise
            self._count(bucket)
            return slot, copied, h, w, bucket

    def _copy_back(self, slot: _Slot, disp: torch.Tensor):
        """Queue the copy of a frame's disparity into its slot; the copy
        stream's event after it, or None on the CPU (copied already)."""
        if self._copy_stream is None:
            slot.out.copy_(disp)
            return None
        done = torch.cuda.current_stream(self.device).record_event()
        with torch.cuda.stream(self._copy_stream):
            self._copy_stream.wait_event(done)
            slot.out.copy_(disp, non_blocking=True)
            # disp was made on the compute stream: its memory must not be
            # reused before this copy has read it
            disp.record_stream(self._copy_stream)
            return self._copy_stream.record_event()

    def _finish(self, frame):
        """A launched frame's cropped disparity once its copy is done, its
        slot released; or its error (the launch's, or the wait's)."""
        if isinstance(frame, Exception):
            return frame
        slot, copied, h, w, bucket = frame
        try:
            if copied is not None:
                copied.synchronize()
            # a copy: the slot's buffer is the next frame's
            return slot.out.numpy()[bucket[0] - h:, :w].copy()
        except Exception as e:
            return e
        finally:
            self._slots[bucket].append(slot)

    def predict_stream(self, pairs: Iterable[Tuple[np.ndarray, np.ndarray]]
                       ) -> Iterator[np.ndarray]:
        """Pipelined inference over uint8 pairs (as ``predict`` takes them),
        up to ``depth`` frames in flight; yields float32 disparities in
        input order. A frame that fails raises its error at its place in
        the order. On every way out (the end, an error, the consumer
        abandoning the generator) the frames in flight are finished and
        their slots returned."""
        flight = collections.deque()   # launched frames or launch errors
        done = collections.deque()     # their results, in input order
        try:
            for iml, imr in pairs:
                try:
                    flight.append(self._launch(iml, imr, flight, done))
                except Exception as e:            # this frame's result
                    flight.append(e)
                while done:
                    yield _result(done.popleft())
            while flight:
                yield _result(self._finish(flight.popleft()))
        finally:
            while flight:
                self._finish(flight.popleft())

    def stats(self) -> Dict:
        with self._lock:
            return {"frames": self._stats["frames"],
                    "bucket_hits": dict(self._stats["bucket_hits"]),
                    "warm_buckets": sorted(self._warm),
                    "cold_frames": self._stats["cold_frames"],
                    "slot_waits": self._stats["slot_waits"],
                    "slot_wait_s": self._stats["slot_wait_s"]}


def _result(r):
    """A finished frame's disparity, or its error raised."""
    if isinstance(r, Exception):
        raise r
    return r
