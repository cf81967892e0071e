"""The program's spans in a profiled sub-window: the device's busy and idle
time charged to the innermost ``msn.*`` span (``msnets_tpu_torch.utils.
profiling.span``) of the host thread that caused it.

- A device op (kernel, copy or memset), clipped to the window, goes to the
  innermost span around its launch (the ``cuda_runtime``/``cuda_driver``
  event of the same ``args.correlation``) on the launching thread; where
  that thread is in no span (autograd's backward thread), to the innermost
  span at that moment on any thread; where there is none, to ``outside``.
  An op whose launch the trace lacks is looked up at its start.
- An idle gap of the device (the window less the union of its ops, as
  ``harness.read_trace`` computes it) goes to the innermost span at the
  gap's middle on the thread that launched the op ending the gap, with the
  same fallbacks; the gap at the window's end looks on any thread.

The layer of a span is its name's first component after ``msn.``. A
request or a step is a root span (``ROOTS``) that starts in the window.

The readers (``readers/span_layer.py``, ``readers/span_name.py``) read the
harness's own profiled sub-window (``harness.profiled_window``, whose
``Trace`` keeps its events), attributed once a run and shared through the
run's ``Context``.
"""
from __future__ import annotations

import bisect
import dataclasses
import json
from typing import Dict, List, Optional, Tuple

from . import harness

PREFIX = "msn."
ROOTS = ("server.predict", "server.launch", "trainer.step")
OUTSIDE = "outside"
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


@dataclasses.dataclass
class SpanTrace:
    busy_s: Dict[str, float]    # span name (or "outside") -> device seconds
    idle_s: Dict[str, float]    # span name (or "outside") -> idle seconds
    roots: int                  # root spans started in the window
    window_s: float
    device_busy_s: float        # the union of the device's ops

    def layer_s(self, layer: str, part: str) -> float:
        """Seconds of ``part`` ("busy" or "idle") under the spans of
        ``layer`` (``outside`` for the time under none)."""
        table = self.busy_s if part == "busy" else self.idle_s
        return sum(v for k, v in table.items() if k.split(".")[0] == layer)

    def summary(self) -> dict:
        """ms a root of each span and of each layer, for the log."""
        per = 1e3 / max(self.roots, 1)
        layers = sorted({k.split(".")[0] for k in (*self.busy_s,
                                                   *self.idle_s)})
        return {
            "roots": self.roots, "window_s": self.window_s,
            "device_busy_s": self.device_busy_s,
            "idle_s": sum(self.idle_s.values()),
            "spans_ms": {k: [self.busy_s.get(k, 0.0) * per,
                             self.idle_s.get(k, 0.0) * per]
                         for k in sorted({*self.busy_s, *self.idle_s})},
            "layers_ms": {k: [self.layer_s(k, "busy") * per,
                              self.layer_s(k, "idle") * per]
                          for k in layers}}


class _Timeline:
    """The innermost span at each moment on one thread: change points and
    the (name, duration) of the span from each on (None: no span)."""

    def __init__(self, spans: List[Tuple[float, float, str]]):
        self.t: List[float] = []
        self.inner: List[Optional[Tuple[str, float]]] = []
        stack: List[Tuple[float, float, str]] = []
        for a, b, name in sorted(spans, key=lambda s: (s[0], -s[1])):
            while stack and stack[-1][1] <= a:
                self._pop(stack)
            if stack:               # nested by construction; clip round-off
                b = min(b, stack[-1][1])
            stack.append((a, b, name))
            self._mark(a, (name, b - a))
        while stack:
            self._pop(stack)

    def _pop(self, stack):
        end = stack.pop()[1]
        self._mark(end, (stack[-1][2], stack[-1][1] - stack[-1][0])
                   if stack else None)

    def _mark(self, t: float, inner) -> None:
        if self.t and self.t[-1] == t:
            self.inner[-1] = inner
        else:
            self.t.append(t)
            self.inner.append(inner)

    def at(self, t: float):
        i = bisect.bisect_right(self.t, t) - 1
        return self.inner[i] if i >= 0 else None


def attribute(events: List[dict]) -> SpanTrace:
    """``SpanTrace`` of the ``harness.WINDOW_SPAN`` span of a Chrome
    trace's events."""
    win = [e for e in events if e.get("name") == harness.WINDOW_SPAN
           and e.get("cat") in harness.HOST_CATS]
    if not win:
        raise RuntimeError("the trace holds no bench.window span")
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    by_tid: Dict[object, List[Tuple[float, float, str]]] = {}
    roots = 0
    launch: Dict[object, Tuple[object, float]] = {}
    for e in events:
        cat = e.get("cat")
        if cat == "user_annotation" and str(e.get("name", "")).startswith(
                PREFIX) and "dur" in e:
            a = float(e["ts"])
            name = e["name"][len(PREFIX):]
            by_tid.setdefault(e.get("tid"), []).append(
                (a, a + float(e["dur"]), name))
            roots += name in ROOTS and w0 <= a < w1
        elif cat in LAUNCH_CATS and "correlation" in e.get("args", {}):
            launch[e["args"]["correlation"]] = (e.get("tid"), float(e["ts"]))
    lines = {tid: _Timeline(s) for tid, s in by_tid.items()}

    def inner(t: float, tid=None) -> str:
        own = lines.get(tid)
        hit = own.at(t) if own is not None else None
        if hit is None:
            hits = [h for h in (line.at(t) for line in lines.values()) if h]
            hit = min(hits, key=lambda h: h[1]) if hits else None
        return hit[0] if hit else OUTSIDE

    ops = []                    # (start, end, launching tid, launch time)
    for e in events:
        if e.get("cat") not in harness.DEVICE_CATS or "dur" not in e:
            continue
        a, b = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        a, b = max(a, w0), min(b, w1)
        if b <= a:
            continue
        tid, t = launch.get(e.get("args", {}).get("correlation"), (None, a))
        ops.append((a, b, tid, t))
    ops.sort(key=lambda o: (o[0], o[1]))
    busy_s: Dict[str, float] = {}
    idle_s: Dict[str, float] = {}
    union, cur = 0.0, w0

    def add(table, key, us):
        table[key] = table.get(key, 0.0) + us / 1e6

    for a, b, tid, t in ops:
        add(busy_s, inner(t, tid), b - a)
        if a > cur:
            add(idle_s, inner(0.5 * (cur + a), tid), a - cur)
        if b > cur:
            union += b - max(a, cur)
            cur = b
    if cur < w1:
        add(idle_s, inner(0.5 * (cur + w1)), w1 - cur)
    return SpanTrace(busy_s, idle_s, roots, (w1 - w0) / 1e6, union / 1e6)


def of(ctx) -> Optional[SpanTrace]:
    """The run's ``SpanTrace``: the attribution of the events of the
    harness's profiled sub-window, made on the first call and kept on the
    ``Context``."""
    if not hasattr(ctx, "span_trace"):
        tr = attribute(ctx.trace.events)
        harness.log("spans: " + json.dumps(tr.summary()))
        ctx.span_trace = tr
    return ctx.span_trace
