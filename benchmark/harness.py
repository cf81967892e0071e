"""Runs one cell of ``BENCHMARK.json`` against the port.

A run: set-up (imports, the kernel library, weights from the seed, the
traffic pool, warm-up of the cell's one bucket or crop, and for a train
cell the first steps that the check follows), the measured window of
``seconds``, with ``trace`` a profiled sub-window and the per-layer
probes after it, then the correctness check against the plain reference
once the program's state is freed. Everything a cell is made of is found
by name: ``configs/<config>.json`` (whose ``"reference"`` names the
configuration's reference system in ``reference/``, which the weights, the
FLOPs, the train crops' margins and the check take the model from),
``traffic/<mix>.json``, ``checks/<cell>.json`` and
``metrics/<metric>.json`` (which names its reader in ``readers/``). A cell
on several cards runs one rank process a card (``ranks.py``), each
calling ``run_cell`` with its ``mesh``.
"""
from __future__ import annotations

import dataclasses
import gc
import heapq
import importlib
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from . import loads, reference, weights
from .counts import flops as FL
from .counts import kernels as KC
from .loads import bucket_of
from .ranks import READY
from .reference import control as RC
from .reference import train as RT

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "msnets_tpu")


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    mix: dict
    chips: int
    end_to_end: List[dict]
    per_layer: List[dict]
    checks: dict

    @property
    def kind(self) -> str:
        return self.mix["kind"]


def load_cell(name: str, spec: Optional[dict] = None) -> Cell:
    """A cell of ``BENCHMARK.json`` with everything it names."""
    spec = spec or _json(ROOT / "BENCHMARK.json")
    work = {w["name"]: w for w in spec["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(work)})")
    w = work[name]
    conf = {c["name"]: c for c in spec["configs"]}[w["config"]]

    def mine(metrics):
        return [m for m in metrics if name in m.get("workloads", [name])]

    mix = loads.load(w["traffic"])
    if math.prod(mix.get("mesh", [1])) != w["chips"]:
        raise ValueError(f"{name}: the mix's mesh {mix.get('mesh')} does "
                         f"not lay out its {w['chips']} chips")
    return Cell(name, _json(ROOT / conf["file"]), mix, w["chips"],
                mine(spec["end_to_end"]), mine(spec["per_layer"]),
                _json(BENCH / "checks" / f"{name}.json"))


PORT_SECTIONS = ("model", "matching")


def port_config(cell: Cell, **model):
    """The port's ``Config`` of the cell: the configuration's model and
    matching settings, its train settings with the mix's crop and (global)
    batch."""
    from msnets_tpu_torch.config import Config
    c, mix = cell.config, cell.mix
    train = dict(c.get("train", {}))
    if cell.kind == "train":
        train.update(crop_height=mix["crop"][0], crop_width=mix["crop"][1],
                     batch_size=mix["batch"])
    doc = {k: c[k] for k in PORT_SECTIONS if k in c}
    doc["model"] = {**doc["model"], **model}
    return Config.from_json(json.dumps({**doc, "train": train}))


def train_margins(cell: Cell):
    """(board_h, board_w_left, board_w_right) of the cell's train crops."""
    return reference.system_class(cell.config).train_margins(cell.config)


def flops_per_item(cell: Cell) -> float:
    """Model FLOPs of one served pair or one (global) train step."""
    channels = cell.mix.get("channels", 1)
    if cell.kind == "train":
        return FL.train_step_flops(cell.config, cell.mix["batch"],
                                   tuple(cell.mix["crop"]), channels)
    (hw,), = [{bucket_of(h, w, cell.config["model"]["encoder_ds"])
               for h, w, _ in cell.mix["sizes"]}]
    return FL.forward_flops(cell.config, hw, channels)


# ---------------------------------------------------------------------------
# timing on the device


class Stopwatch:
    """Device time of a run of calls: CUDA events on a GPU (host clock
    after a synchronise elsewhere, which only the CPU tests use)."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"

    def mean_ms(self, fn: Callable, n: int) -> float:
        fn()
        if self.cuda:
            torch.cuda.synchronize()
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            for _ in range(n):
                fn()
            b.record()
            torch.cuda.synchronize()
            return a.elapsed_time(b) / n
        t = time.perf_counter()
        for _ in range(n):
            fn()
        return (time.perf_counter() - t) * 1e3 / n

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# the systems under test


def _clone(state_dict):
    """The program's own copy of the seed's weights; the benchmark keeps
    the original for the reference."""
    return {k: v.clone() for k, v in state_dict.items()}


def _priority(seed: int, i: int) -> int:
    """A 64-bit hash of (seed, request index) (splitmix64)."""
    x = (int(seed) * 0x9E3779B97F4A7C15 + i + 1) & 0xFFFFFFFFFFFFFFFF
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    return x ^ (x >> 31)


class Sample:
    """The check's sample of the finished requests, drawn from the seed as
    they finish: the ``k`` with the smallest ``_priority``. Only these
    disparities are kept (a client drops each answer once it has it)."""

    def __init__(self, k: int, seed: int):
        self.k, self.seed, self.kept = k, seed, []     # heap of (-p, i, d)

    def add(self, i: int, d) -> None:
        item = (-_priority(self.seed, i), i, d)
        if len(self.kept) < self.k:
            heapq.heappush(self.kept, item)
        elif item[0] > self.kept[0][0]:
            heapq.heapreplace(self.kept, item)

    def items(self):
        return sorted((i, d) for _, i, d in self.kept)


class ServeSUT:
    """``StereoServer`` of the cell; ``variant="int8"`` turns on the port's
    own int8 path (``quant_eval``, dynamic scales, every flagged conv)."""

    def __init__(self, cell: Cell, seed: int, device, variant=None):
        from msnets_tpu_torch import StereoServer
        extra = ({"quant_eval": True, "quant_mode": "dynamic",
                  "quant_scope": "all"} if variant == "int8" else {})
        self.cell, self.device = cell, torch.device(device)
        self.cfg = port_config(cell, **extra)
        self.state_dict = weights.make(cell.config, seed, self.device)
        self.traffic = loads.make(cell.mix, seed)
        self.server = StereoServer(self.cfg, _clone(self.state_dict),
                                   device=self.device,
                                   depth=cell.mix.get("depth", 2))
        self.watch = Stopwatch(self.device)
        self.sample = Sample(cell.mix["sample"], seed)

    def warmup(self) -> None:
        self.server.warmup(self.traffic.shapes[-1:])
        for i in range(self.cell.mix.get("warmup_requests", 2)):
            self.server.predict(*self.traffic.pair(i))
        if self.cell.kind == "stream":
            for _ in self.server.predict_stream(
                    self.traffic.pair(i) for i in range(3)):
                pass
        self.watch.sync()

    def window(self, seconds: float, first: int = 0) -> dict:
        if self.cell.kind == "stream":
            return self._stream(seconds, first)
        return self._closed_loop(seconds, first)

    def _closed_loop(self, seconds, first):
        lat, done, failed = [], 0, 0
        t0 = time.perf_counter()
        i = first
        while time.perf_counter() - t0 < seconds:
            pair = self.traffic.pair(i)
            t1 = time.perf_counter()
            try:
                d = self.server.predict(*pair)
                lat.append(time.perf_counter() - t1)
                self.sample.add(i, d)
                done += 1
            except Exception:               # a failed request is missing
                traceback.print_exc()
                failed += 1
                lat.append(None)
            i += 1
        return {"attempted": i - first, "failed": failed, "latency_s": lat,
                "done": done, "seconds": time.perf_counter() - t0, "next": i}

    def _stream(self, seconds, first):
        t0 = time.perf_counter()
        sent: List[int] = []
        done: List[float] = []

        def feed():
            i = first
            while time.perf_counter() - t0 < seconds:
                sent.append(i)
                yield self.traffic.pair(i)
                i += 1

        try:
            for j, d in enumerate(self.server.predict_stream(feed())):
                done.append(time.perf_counter() - t0)
                self.sample.add(sent[j], d)
        except Exception:                   # the rest of the stream is lost
            traceback.print_exc()
        return {"attempted": len(sent), "failed": len(sent) - len(done),
                "done": len(done),
                "seconds": done[-1] if done else time.perf_counter() - t0,
                "next": first + len(sent)}

    def layer_ms(self, layer: str, n: int = 10) -> Optional[float]:
        """Mean device ms of one call into ``layer`` at the cell's bucket:
        ``features`` (``server.features``) or ``regularizer``
        (``server.model`` over that volume)."""
        mc = self.cell.config["model"]
        l, r = self.traffic.pair(0)
        l, r = loads.pad_to_bucket(l, r, mc["encoder_ds"])
        il = torch.from_numpy(l).to(self.device)
        ir = torch.from_numpy(r).to(self.device)
        with torch.inference_mode():
            if layer == "features":
                return self.watch.mean_ms(lambda: self.server.features(il, ir),
                                          n)
            if layer == "regularizer":
                vol = self.server.features(il, ir)[None]
                return self.watch.mean_ms(lambda: self.server.model(vol), n)
        return None


class TrainSUT:
    """``Trainer`` of the cell, loaded with the seed's weights, driven by
    ``step_fn`` as ``train_epoch`` drives it (each step's metrics read as
    floats). Its first ``checked_steps`` run in set-up and are the ones
    the check follows.

    With a ``mesh`` (``ranks.join``) it is one rank of the step over the
    mesh: ``Trainer(mesh=)``, fed this rank's share of each global batch
    as the port's mesh training takes it (micro-batch k is rows
    [k m, (k + 1) m) of every data index's share, m = batch / (data x
    grad_accum)). Every rank takes the same number of steps: a window of
    ``seconds`` is as many steps as rank 0's step time, measured in set-up
    and broadcast once, fits into it, so no collective of the harness's
    runs inside a window.

    A mix with ``"dispatch_ahead_s"`` feeds the step as a prefetching
    loader does (each batch copied to the card from page-locked memory
    without a wait, in the checked steps too) and reads each step's
    metrics behind it: copied to the host after the step, read once that
    step has ended, at most that many seconds of steps unread. The card
    keeps working through a stall of the host. Its window ends as a
    dispatching loop has to: when the time is up (or the fixed count is
    sent) nothing more is sent, all that was sent is waited for, and the
    clock is read after that wait; its step time for the count is taken
    from ``PROBE_STEPS`` such steps at the end of set-up."""

    PROBE_STEPS = 16

    def __init__(self, cell: Cell, seed: int, device, variant=None,
                 mesh=None):
        from msnets_tpu_torch.engine import Trainer
        self.cell, self.device, self.mesh = cell, torch.device(device), mesh
        self.cfg = port_config(cell)
        self.state_dict = weights.make(cell.config, seed, self.device)
        self.traffic = loads.make(cell.mix, seed, train_margins(cell))
        self.trainer = Trainer(self.cfg, device=self.device, mesh=mesh)
        self.trainer.model.load_state_dict(_clone(self.state_dict))
        self.rows = self._rows()
        self.batches = [self._share(b) for b in self.traffic.batches]
        b = self.traffic.batches[0]
        self.fn = self.trainer.step_fn(b["board_h"], b["board_w_left"],
                                       b["board_w_right"])
        self.lr = cell.config["train"]["lr"]
        self.watch = Stopwatch(self.device)
        self.readings: Dict = {}
        self.variant = variant
        self.step_s = 0.0
        self.ahead_s = cell.mix.get("dispatch_ahead_s")
        self.pinned = None
        self.next = cell.mix["checked_steps"]

    def _rows(self):
        """This rank's rows of a global batch (all of them alone)."""
        batch = self.cell.mix["batch"]
        if self.mesh is None:
            return slice(0, batch)
        data, d = self.mesh.size("data"), self.mesh.index("data")
        accum = self.cfg.train.grad_accum
        m = batch // (data * accum)
        return [r for k in range(accum)
                for r in range((k * data + d) * m, (k * data + d + 1) * m)]

    def _share(self, b: dict) -> dict:
        if self.mesh is None:
            return b
        return dict(b, **{k: np.ascontiguousarray(b[k][self.rows])
                          for k in ("iml", "imr", "disp")})

    def _feed(self, i: int):
        """Step ``i``'s crops and targets on the card, copied from
        page-locked memory without a wait (``dispatch_ahead_s``)."""
        k = i % len(self.batches)
        if self.pinned is None:
            cuda = self.device.type == "cuda"
            self.pinned = [[torch.from_numpy(b[f]).pin_memory() if cuda
                            else torch.from_numpy(b[f])
                            for f in ("iml", "imr", "disp")]
                           for b in self.batches]
        return [t.to(self.device, non_blocking=True) for t in self.pinned[k]]

    def _dispatch(self, i: int):
        """Send step ``i``; its metrics come back later (``_await``)."""
        metrics, self.last_disp = self.fn(*self._feed(i), self.lr)
        keys = sorted(metrics)
        vals = torch.stack([metrics[k].float() for k in keys])
        if self.device.type != "cuda":
            return keys, vals, None
        host = torch.empty(vals.shape, dtype=vals.dtype, pin_memory=True)
        host.copy_(vals, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return keys, host, done

    @staticmethod
    def _await(sent) -> Dict[str, float]:
        """The metrics of a step sent by ``_dispatch``, once it has ended
        (a wait for that step alone, not for those sent after it)."""
        keys, host, done = sent
        if done is not None:
            done.synchronize()
        return dict(zip(keys, host.tolist()))

    def _step(self, i: int) -> Dict[str, float]:
        if self.ahead_s is not None:
            return self._await(self._dispatch(i))
        b = self.batches[i % len(self.batches)]
        metrics, self.last_disp = self.fn(b["iml"], b["imr"], b["disp"],
                                          self.lr)
        return {k: float(v) for k, v in metrics.items()}

    def _global_disp(self) -> torch.Tensor:
        """The step's disparity of the whole global batch: each data
        index's share, summed into its rows over the ranks."""
        disp = self.last_disp.float()
        if self.mesh is None:
            return disp
        from msnets_tpu_torch.parallel import mesh as pm
        out = disp.new_zeros((self.cell.mix["batch"],) + disp.shape[1:])
        if self.mesh.index("spatial") == 0 and self.mesh.index("disp") == 0:
            out[self.rows] = disp
        return pm.all_reduce_sum(out, self.mesh.group)

    def warmup(self) -> None:
        """The checked steps: each step's loss, each parameter's first
        gradient as Adam holds it (its first moment over 1 - beta1) and its
        change after the last; then the step time (rank 0's, on a mesh)."""
        tr = self.trainer
        named = dict(tr.model.named_parameters())
        start = {k: p.detach().double().clone() for k, p in named.items()}
        losses, times = [], []
        for i in range(self.cell.mix["checked_steps"]):
            t = time.perf_counter()
            losses.append(self._step(i)["loss"])
            times.append(time.perf_counter() - t)
            if i == 0:
                disp = self._global_disp().cpu()
                beta1 = tr.optimizer.param_groups[0]["betas"][0]
                grad = {}
                for k, p in named.items():
                    st = tr.optimizer.state.get(p, {})
                    grad[k] = (st["exp_avg"].double().norm().item()
                               / (1 - beta1) if "exp_avg" in st else 0.0)
        change = {k: (p.detach().double() - start[k]).norm().item()
                  for k, p in named.items()}
        self.readings = {"loss": losses, "grad": grad, "change": change,
                         "disp": disp}
        self.step_s = statistics.median(times[1:] or times)
        if self.ahead_s is not None:
            probe = self._ahead(self.next, self.PROBE_STEPS, None)
            self.step_s = probe["seconds"] / probe["attempted"]
            self.next = probe["next"]
        if self.mesh is not None:
            from msnets_tpu_torch.parallel import mesh as pm
            self.step_s = pm.broadcast_int(round(self.step_s * 1e6),
                                           self.mesh.group) / 1e6
        self.watch.sync()

    def window(self, seconds: float, first: int = 0) -> dict:
        n, bad = 0, 0
        i = first or self.next
        steps = (None if self.mesh is None
                 else max(1, round(seconds / max(self.step_s, 1e-6))))
        if self.ahead_s is not None:
            return self._ahead(i, steps, seconds)
        t0 = time.perf_counter()
        while (n < steps if steps is not None
               else time.perf_counter() - t0 < seconds):
            m = self._step(i + n)
            if not all(math.isfinite(v) for v in m.values()):
                bad += 1
            n += 1
        return {"attempted": n, "failed": bad,
                "seconds": time.perf_counter() - t0, "next": i + n}

    def _ahead(self, i: int, steps: Optional[int], seconds) -> dict:
        """``steps`` steps from ``i`` (else as many as ``seconds`` allows),
        dispatched ahead (class docstring); the seconds run from the first
        send to the end of the last step sent."""
        depth = max(1, math.ceil(self.ahead_s / max(self.step_s, 1e-3)))
        sent: List = []
        n, bad = 0, 0

        def read(m):
            return 0 if all(math.isfinite(v) for v in m.values()) else 1

        t0 = time.perf_counter()
        while (n < steps if steps is not None
               else time.perf_counter() - t0 < seconds):
            sent.append(self._dispatch(i + n))
            n += 1
            if len(sent) > depth:
                bad += read(self._await(sent.pop(0)))
        for s in sent:
            bad += read(self._await(s))
        self.watch.sync()
        return {"attempted": n, "failed": bad,
                "seconds": time.perf_counter() - t0, "next": i + n}

    def layer_ms(self, layer: str, n: int = 10) -> Optional[float]:
        if layer != "features":
            return None
        b = self.batches[0]
        il = torch.from_numpy(b["iml"]).to(self.device)
        ir = torch.from_numpy(b["imr"]).to(self.device)
        geo = (b["board_h"], b["board_w_left"], b["board_w_right"])
        return self.watch.mean_ms(lambda: self.trainer.features(il, ir, *geo),
                                  n)


def make_sut(cell: Cell, seed: int, device, variant=None, mesh=None):
    if cell.kind == "train":
        return TrainSUT(cell, seed, device, variant, mesh)
    if mesh is not None:
        raise NotImplementedError("a serving cell runs on one card")
    return ServeSUT(cell, seed, device, variant)


# ---------------------------------------------------------------------------
# the profiled sub-window


@dataclasses.dataclass
class Trace:
    busy_s: float
    window_s: float
    kernels: Dict[str, List[float]]     # name -> [seconds, launches]
    idle_by_host: Dict[str, float]      # host op -> idle seconds under it
    events: List[dict] = dataclasses.field(default_factory=list, repr=False)

    def kernel(self, part: str):
        """(seconds, launches) of the kernels whose name holds ``part``."""
        hits = [v for k, v in self.kernels.items() if part in k]
        return sum(v[0] for v in hits), sum(v[1] for v in hits)

    def breakdown(self) -> dict:
        ops = sorted(self.kernels.items(), key=lambda kv: -kv[1][0])[:10]
        gaps = sorted(self.idle_by_host.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[k[:120], v[0]] for k, v in ops],
                "idle_gaps": [[k[:120], v] for k, v in gaps]}


DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "python_function")
WINDOW_SPAN = "bench.window"


def read_trace(events: List[dict]) -> Trace:
    """Busy and idle time of the device inside the ``bench.window`` span of
    a Chrome trace: the union of kernel, copy and memset intervals; each
    idle gap charged to the innermost host op running at its middle."""
    win = [e for e in events if e.get("name") == WINDOW_SPAN
           and e.get("cat") in HOST_CATS]
    if not win:
        raise RuntimeError("the trace holds no bench.window span")
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    dev, kernels = [], {}
    for e in events:
        if e.get("cat") not in DEVICE_CATS or "dur" not in e:
            continue
        a, b = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        a, b = max(a, w0), min(b, w1)
        if b <= a:
            continue
        dev.append((a, b))
        k = kernels.setdefault(e["name"], [0.0, 0])
        k[0] += (b - a) / 1e6
        k[1] += 1
    dev.sort()
    busy, gaps, cur = 0.0, [], w0
    for a, b in dev:
        if a > cur:
            gaps.append((cur, a))
        if b > cur:
            busy += b - max(a, cur)
            cur = b
    if cur < w1:
        gaps.append((cur, w1))
    host = sorted(((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                    e["name"]) for e in events
                   if e.get("cat") in HOST_CATS and "dur" in e
                   and e.get("name") != WINDOW_SPAN),
                  key=lambda t: t[0])
    starts = np.array([h[0] for h in host]) if host else np.zeros(0)
    idle: Dict[str, float] = {}
    for a, b in gaps:
        mid = 0.5 * (a + b)
        j = int(np.searchsorted(starts, mid, side="right"))
        inner = None
        for h in reversed(host[max(0, j - 400):j]):
            if h[1] >= mid and (inner is None or h[1] - h[0] < inner[1] - inner[0]):
                inner = h
        label = inner[2] if inner else "host outside any op"
        idle[label] = idle.get(label, 0.0) + (b - a) / 1e6
    return Trace(busy / 1e6, (w1 - w0) / 1e6, kernels, idle, events)


def profiled_window(sut, seconds: float, first: int) -> Trace:
    """``sut.window(seconds, first)`` under the profiler, inside a
    ``WINDOW_SPAN`` span: its ``Trace``, which keeps the events for the
    readers of the program's spans (``spans.py``)."""
    from torch.profiler import ProfilerActivity, profile, record_function
    acts = [ProfilerActivity.CPU]
    if sut.device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    sut.watch.sync()
    with profile(activities=acts) as prof:
        with record_function(WINDOW_SPAN):
            sut.window(seconds, first)
            sut.watch.sync()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return read_trace(events)


# ---------------------------------------------------------------------------
# the check


class fp32:
    """TF32 off for the reference (cuDNN and matmul), restored after."""

    def __enter__(self):
        self.prev = (torch.backends.cudnn.allow_tf32,
                     torch.backends.cuda.matmul.allow_tf32)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False

    def __exit__(self, *exc):
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = self.prev


def disparity_gaps(got: torch.Tensor, ref: torch.Tensor) -> Dict[str, float]:
    """|got - ref| in px over a disparity map: its mean, 99th percentile
    (of every 7th pixel) and largest."""
    gap = (got - ref).abs().flatten()
    return {"mean_abs_px": gap.mean().item(),
            "p99_abs_px": torch.quantile(gap[::7], 0.99).item(),
            "max_abs_px": gap.max().item()}


def serve_readings(cell: Cell, state_dict, traffic, sample,
                   device, control: bool = False) -> Dict[str, float]:
    """Reference disparities of the sample of the finished requests
    (``Sample``, drawn from the seed) and the gaps of the served ones
    (``disparity_gaps``), the worst request's of each, through the
    configuration's reference system. ``gap_ratio`` is a request's mean
    gap over the mean gap that rounding the reference's feature volume to
    bfloat16 causes: the gap in units of the seed's weights' sensitivity
    to rounding, which is steady from seed to seed where the gap in px
    follows the weights' logit scale. With ``control`` the reference in
    fp8 stands in the program's place."""
    system = reference.build(cell.config, device)
    system.load_state_dict(state_dict)
    if control:
        system_c = reference.build(cell.config, device)
        system_c.load_state_dict(state_dict)
        RC.fp8_convs(system_c)
    worst = {"bad_shape": 0.0}
    each = []
    with torch.no_grad(), fp32():
        for i, got in sample:
            l, r = traffic.pair(i)
            h, w = l.shape[:2]
            if got.shape != (h, w) or not np.isfinite(got).all():
                worst["bad_shape"] += 1
                continue
            pl, pr = loads.pad_to_bucket(l, r,
                                         cell.config["model"]["encoder_ds"])
            vol = system.serve_features(torch.from_numpy(pl).to(device),
                                        torch.from_numpy(pr).to(device))
            crop = (0, slice(pl.shape[0] - h, None), slice(0, w))
            ref = system(vol[None])[crop]
            yard = system(vol[None].bfloat16().float())[crop]
            got = (system_c(system_c.serve_features(
                       torch.from_numpy(pl).to(device),
                       torch.from_numpy(pr).to(device))[None])[crop]
                   if control else torch.from_numpy(got).to(device))
            g = disparity_gaps(got, ref)
            g["gap_ratio"] = g["mean_abs_px"] / max(
                (yard - ref).abs().mean().item(), 1e-30)
            for k, v in g.items():
                worst[k] = max(worst.get(k, 0.0), v)
            each.append(f"{i}:{h}x{w}:{g['mean_abs_px']:.4g}/"
                        f"{g['p99_abs_px']:.4g}/{g['gap_ratio']:.3g}")
            del vol, ref
    worst["compared"] = float(len(sample))
    worst["requests"] = " ".join(each)
    return worst


def _leaf_gaps(got: Dict[str, float], want: Dict[str, float], keys
               ) -> Dict[str, float]:
    """Each leaf's |norm - reference norm| over the larger of the reference
    norm and the median reference norm."""
    med = statistics.median(want[k] for k in keys)
    return {k: abs(got[k] - want[k]) / max(want[k], med, 1e-30)
            for k in keys}


def train_readings(cell: Cell, state_dict, traffic, program,
                   device) -> Dict[str, float]:
    """The reference's first steps against the program's: each step's loss
    gap (relative) and the worst; the worst and the median leaf's
    first-gradient gap and change gap after the last step
    (``_leaf_gaps``); the first step's disparity (``disparity_gaps``).
    Leaves whose reference gradient is under a thousandth of the median
    leaf's (nought to rounding, such as a bias under a softmax) stay out
    of the change."""
    with fp32():
        ref = RT.steps(reference.build(cell.config, device), state_dict,
                       traffic.batches, cell.config["train"]["lr"],
                       cell.mix["checked_steps"])
    keys = sorted(ref["grad"])
    med = statistics.median(ref["grad"][k] for k in keys)
    moved = [k for k in keys if ref["grad"][k] >= 1e-3 * med]
    gaps = [abs(a - b) / max(abs(b), 1e-30)
            for a, b in zip(program["loss"], ref["loss"])]
    out = {f"loss_gap_step{k + 1}": g for k, g in enumerate(gaps)}
    out["loss_gap"] = max(gaps)
    for name, leaves in (("grad", keys), ("change", moved)):
        g = _leaf_gaps(program[name], ref[name], leaves)
        worst = max(g, key=g.get)
        out[f"{name}_gap"] = g[worst]
        out[f"{name}_gap_median"] = statistics.median(g.values())
        out[f"{name}_worst_leaf"] = worst
    out.update({f"disp_{k}": v for k, v in disparity_gaps(
        program["disp"].to(device), ref["disp"]).items()})
    out["leaves_left_out"] = float(len(keys) - len(moved))
    out["ref_loss_step1"] = ref["loss"][0]
    return out


def judge(readings: Dict[str, float], checks: dict):
    """(correct, {number: {"value", "limit"}}) of the cell's compared
    numbers; a number with no limit yet fails."""
    out, ok = {}, True
    for name, c in checks["numbers"].items():
        v, lim = readings.get(name), c.get("limit")
        passed = v is not None and lim is not None and v <= lim
        ok = ok and passed
        out[name] = {"value": v, "limit": lim}
    return ok, out


# ---------------------------------------------------------------------------
# a run


@dataclasses.dataclass
class Context:
    """What a per-layer reader may read."""
    cell: Cell
    sut: object
    trace: Optional[Trace]
    items: int                  # pairs or steps finished in the window
    window_s: float
    flops_per_item: float

    def layer_ms(self, layer: str) -> Optional[float]:
        return self.sut.layer_ms(layer)

    def kernel_bound_s(self, kernel: str) -> float:
        """The least time of one launch of ``kernel`` at its launch shape
        in the cell (``counts.kernels.KERNELS``)."""
        count, shape = KC.KERNELS[kernel]
        return count(*shape(self.cell))["bound_s"]


def read_metric(name: str, ctx: Context) -> Optional[float]:
    spec = _json(BENCH / "metrics" / f"{name}.json")
    reader = importlib.import_module(f"{__package__}.readers.{spec['reader']}")
    return reader.read(ctx, **spec.get("args", {}))


def end_to_end(cell: Cell, win: dict, setup_s: float) -> Dict[str, float]:
    out = {"setup_s": setup_s}
    if cell.kind == "closed_loop":
        lat = [x if x is not None else win["seconds"] for x in win["latency_s"]]
        out["latency_p95_ms"] = float(np.percentile(lat, 95)) * 1e3
        out["latency_p50_ms"] = float(np.percentile(lat, 50)) * 1e3
    elif cell.kind == "stream":
        out["pairs_per_s"] = win["done"] / win["seconds"]
    else:
        out["train_step_ms"] = win["seconds"] / max(win["attempted"], 1) * 1e3
    return out


def power_limit() -> str:
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=30)
        return r.stdout.strip().splitlines()[0] if r.returncode == 0 else ""
    except (OSError, subprocess.TimeoutExpired, IndexError):
        return ""


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _over_ranks(mesh, values, op: str) -> List[float]:
    """``values`` summed (``op="sum"``) or maximised over the mesh's ranks
    (after a window, never inside one)."""
    from msnets_tpu_torch.parallel import mesh as pm
    dev = (torch.device("cuda", torch.cuda.current_device())
           if torch.distributed.get_backend(mesh.group) == "nccl"
           else torch.device("cpu"))
    t = torch.tensor(values, dtype=torch.float64, device=dev)
    reduce = pm.all_reduce_sum if op == "sum" else pm.all_reduce_max
    return reduce(t, mesh.group).tolist()


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             t_start: float, variant: Optional[str] = None,
             profile_s: float = 3.0, mesh=None) -> Optional[dict]:
    """One run; returns the result object (``checks`` last) and the
    readings under ``"readings"``, which ``run.py`` drops.

    With a ``mesh`` this is one of the cell's rank processes (``ranks.py``,
    ``TrainSUT``): every rank runs the set-up, the window and, with
    ``trace``, the profiled sub-window, each profiling its own; the peak
    memory is the fullest card's, ``busy_s`` and ``window_s`` the ranks'
    means. Once every rank has freed its state, rank 0 alone runs the
    check against the reference over the global batch and returns the
    result; the other ranks return None."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    if cuda:                # a process that runs several (calibrate.py)
        torch.cuda.reset_peak_memory_stats(device)
    sut = make_sut(cell, seed, device, variant, mesh)
    if variant is not None and variant.startswith("fault:"):
        from . import faults
        faults.plant(variant[6:], sut)
    sut.warmup()
    setup_s = time.time() - t_start
    lead = mesh is None or mesh.rank == 0
    if mesh is not None:
        log(f"{READY} rank {mesh.rank}")
    win = sut.window(seconds)
    sut.watch.sync()
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    if mesh is not None:
        peak = int(_over_ranks(mesh, [peak], "max")[0])
    e2e = end_to_end(cell, win, setup_s)
    if cell.kind == "closed_loop":
        log(f"latency: median {e2e['latency_p50_ms']:.4f} ms, p95 "
            f"{e2e['latency_p95_ms']:.4f} ms over {len(win['latency_s'])} "
            f"requests")
    items = win.get("done", win["attempted"] - win["failed"])
    log(f"window: {items} done of {win['attempted']} in "
        f"{win['seconds']:.4f} s; setup {setup_s:.4f} s; peak memory "
        f"{peak} bytes ({peak / 2**30:.3f} GiB)")
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
                   "count": cell.chips, "memory_peak_bytes": int(peak)}
    result: Dict = {"correct": False, "attempted": win["attempted"],
                    "failed": win["failed"]}
    breakdown = None
    if trace:
        tr = profiled_window(sut, profile_s, win["next"])
        if mesh is not None:
            busy, span = _over_ranks(mesh, [tr.busy_s, tr.window_s], "sum")
            tr.busy_s, tr.window_s = busy / mesh.num_devices, \
                span / mesh.num_devices
        metrics = {}
        if lead:
            ctx = Context(cell, sut, tr, items, win["seconds"],
                          flops_per_item(cell))
            for m in cell.per_layer:
                v = read_metric(m["name"], ctx)
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}
            del ctx
            log(f"power: {power_limit()}")
        device_info.update(busy_s=tr.busy_s, window_s=tr.window_s)
        breakdown = tr.breakdown()
        del tr
    else:
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    sample = sut.sample.items() if hasattr(sut, "sample") else []
    program = getattr(sut, "readings", None)
    state_dict, traffic = sut.state_dict, sut.traffic
    del sut                 # the program's state, before the reference runs
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    if mesh is not None:
        from msnets_tpu_torch.parallel import mesh as pm
        pm.barrier(mesh.group)          # every rank has freed its state
        if not lead:
            return None
    bad = forbidden_modules()
    if bad:
        raise SystemExit(f"modules of {bad} are loaded; the port and the "
                         "benchmark must run without them")
    t_check = time.time()
    if cell.kind == "train":
        if variant == "control":
            with fp32():
                program = RT.steps(reference.build(cell.config, device),
                                   state_dict, traffic.batches,
                                   cell.config["train"]["lr"],
                                   cell.mix["checked_steps"],
                                   wrap=RC.fp8_convs)
        readings = train_readings(cell, state_dict, traffic, program, device)
    else:
        readings = serve_readings(cell, state_dict, traffic, sample, device,
                                  control=variant == "control")
        readings["unanswered"] = float(win["failed"])
    log(f"check: {time.time() - t_check:.4f} s against the reference; "
        f"process peak {torch.cuda.max_memory_allocated(device) if cuda else 0}"
        " bytes")
    correct, checks = judge(readings, cell.checks)
    result["correct"] = bool(correct and win["failed"] == 0
                             and readings.get("bad_shape", 0) == 0)
    result.update(metrics=metrics, device=device_info)
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    result["readings"] = readings
    for k, v in readings.items():
        log(f"reading {k} = {v!r}")
    for k, c in checks.items():
        log(f"check {k} = {c['value']!r} (limit {c['limit']!r})")
    return result
