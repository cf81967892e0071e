"""Tracing and numerics-debug helpers (counterpart of
``msnets_tpu/utils/profiling.py``).

``trace`` records ``torch.profiler`` over a block and writes a Chrome
trace: the host's ops, the program's spans and, on a GPU, the device's
kernels and copies, all on one clock. ``span`` names a stretch of the
program in that trace (``msn.<layer>.<part>``); it costs a flag check when
no profiler records. ``debug_nans`` is autograd's anomaly mode (the
reference keeps ``torch.autograd.set_detect_anomaly(True)`` on during
training, main_msnet.py:767; here it is opt-in, since anomaly mode slows
every backward). ``device_memory_stats`` reads the CUDA caching
allocator's counters.

The spans, by layer (the first component after ``msn.``):
  * server: ``server.predict`` (a blocking request) and ``server.launch``
    (a frame of ``predict_stream``), each the root of a request, with
    ``server.pad``, ``server.slot_wait``, ``server.h2d``, ``server.d2h``
    and ``server.crop`` (``serve.py``);
  * features: ``features`` (the stage) with ``features.downsample``, then
    on 8 channels ``features.census_aml`` and ``features.matchers``, on 16
    channels ``features.census``, ``features.ncc``, ``features.zsad``,
    ``features.sobel_sad`` and ``features.assemble`` (``ops/features.py``);
    GC-Net's learned stage has ``features.unary`` (the tower on both
    views) and ``features.volume`` (the concat volume) inside
    ``features`` (``models/gcnet_kendall.py``), and in training
    ``features.volume_backward``, opened on autograd's thread inside the
    volume's backward (``ops/volume.py``; counters
    ``concat_volume.launches``, one a volume built, and
    ``concat_volume.bytes``); the tower's own backward has no span and
    runs inside ``regularizer.backward``;
  * regularizer: ``regularizer`` (the model when serving),
    ``regularizer.forward`` and ``regularizer.backward`` (training);
  * trainer: ``trainer.step`` (the root of a step) with ``trainer.h2d``,
    ``trainer.loss``, ``trainer.metrics``, ``trainer.allreduce`` (over a
    mesh) and ``trainer.optimizer`` (``engine/trainer.py``).

A span is recorded on the thread the profiler was started on and on the
threads that existed then; a thread started inside the profiled block
(such as ``predict_stream``'s fetcher) sees no profiler and records none.
"""
from __future__ import annotations

import contextlib
import os
from typing import Dict, Iterator

import torch

_NULL = contextlib.nullcontext()


@contextlib.contextmanager
def trace(logdir: str) -> Iterator["torch.profiler.profile"]:
    """``torch.profiler`` over the block, CUDA activity included when a GPU
    is present; writes ``logdir/trace.json`` (chrome://tracing or Perfetto)
    and yields the profiler (``key_averages()``). The program's spans are
    its ``user_annotation`` events named ``msn.*``."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def span(name: str):
    """A context naming a stretch of the program ``msn.<name>`` in the
    profiler's trace while a profiler records on this thread; otherwise
    one shared do-nothing context (a flag check: an unconditional
    ``record_function`` costs ~20 times as much)."""
    if torch._C._autograd._profiler_enabled():
        return torch.profiler.record_function("msn." + name)
    return _NULL


@contextlib.contextmanager
def debug_nans(enable: bool = True) -> Iterator[None]:
    """autograd's anomaly mode with its NaN check: a backward that makes a
    NaN raises and names the forward op that made it."""
    with torch.autograd.set_detect_anomaly(enable, check_nan=True):
        yield


def device_memory_stats() -> Dict[str, Dict[str, float]]:
    """Each CUDA device's allocator byte counters (``torch.cuda.
    memory_stats``) in MiB, by device name ``cuda:i``; empty without a
    GPU."""
    if not torch.cuda.is_available():
        return {}
    return {f"cuda:{i}": {k: v / 2 ** 20
                          for k, v in torch.cuda.memory_stats(i).items()
                          if "bytes" in k}
            for i in range(torch.cuda.device_count())}
