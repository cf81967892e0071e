"""Runs one cell of ``BENCHMARK.json`` against the port.

A run: set-up (imports, the kernel library, weights from the seed, the
traffic pool, warm-up of the cell's one bucket or crop, and for a train
cell the first steps that the check follows), the measured window of
``seconds``, with ``trace`` a profiled sub-window and the per-layer
probes after it, then the correctness check against the plain reference
once the program's state is freed. Everything a cell is made of is found
by name: ``configs/<config>.json``, ``traffic/<mix>.json``,
``checks/<cell>.json`` and ``metrics/<metric>.json`` (which names its
reader in ``readers/``).
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

from . import loads, weights
from .counts import flops as FL
from .counts import kernels as KC
from .reference import control as RC
from .reference import features as RF
from .reference import models as RM
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

    return Cell(name, _json(ROOT / conf["file"]), loads.load(w["traffic"]),
                w["chips"], mine(spec["end_to_end"]), mine(spec["per_layer"]),
                _json(BENCH / "checks" / f"{name}.json"))


def port_config(cell: Cell, **model):
    """The port's ``Config`` of the cell: the configuration's model,
    matching and train settings, the mix's crop and batch."""
    from msnets_tpu_torch.config import Config
    c, mix = cell.config, cell.mix
    train = dict(c.get("train", {}))
    if cell.kind == "train":
        train.update(crop_height=mix["crop"][0], crop_width=mix["crop"][1],
                     batch_size=mix["batch"])
    return Config.from_json(json.dumps({
        "model": {**c["model"], **model}, "matching": c["matching"],
        "train": train}))


def bucket_of(h: int, w: int, multiple: int):
    return (h + (-h) % multiple, w + (-w) % multiple)


def census_launch_shape(cell: Cell):
    """[H, W, D] of each ``census_aml`` launch of the cell: the half-res
    bucket with its 10-px border when serving, the half-res crop with its
    margins in training."""
    m, mc = cell.config["matching"], cell.config["model"]
    s, D = m["ds_scale"], mc["max_disp"] // m["ds_scale"]
    if cell.kind == "train":
        ch, cw = cell.mix["crop"]
        return ((ch + 2 * m["board_h"]) // s, (cw + mc["max_disp"]) // s, D)
    (bh, bw), = {bucket_of(h, w, mc["encoder_ds"])
                 for h, w, _ in cell.mix["sizes"]}
    return (bh // s + 2 * RF.BORDER, bw // s + 2 * RF.BORDER, D)


def flops_per_item(cell: Cell) -> float:
    """Model FLOPs of one served pair or one train step."""
    mc, m = cell.config["model"], cell.config["matching"]
    if cell.kind == "train":
        return FL.train_step_flops(mc, m, cell.mix["batch"],
                                   tuple(cell.mix["crop"]))
    (hw,), = [{bucket_of(h, w, mc["encoder_ds"])
               for h, w, _ in cell.mix["sizes"]}]
    return FL.forward_flops(mc, m, 1, hw)


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
        self.state_dict = weights.make(cell.config["model"], seed, self.device)
        self.traffic = loads.make(cell.mix, seed, cell.config)
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
        l, r = RF.pad_to_bucket(l, r, mc["encoder_ds"])
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
    the check follows."""

    def __init__(self, cell: Cell, seed: int, device, variant=None):
        from msnets_tpu_torch.engine import Trainer
        self.cell, self.device = cell, torch.device(device)
        self.cfg = port_config(cell)
        self.state_dict = weights.make(cell.config["model"], seed, self.device)
        self.traffic = loads.make(cell.mix, seed, cell.config)
        self.trainer = Trainer(self.cfg, device=self.device)
        self.trainer.model.load_state_dict(_clone(self.state_dict))
        b = self.traffic.batches[0]
        self.fn = self.trainer.step_fn(b["board_h"], b["board_w_left"],
                                       b["board_w_right"])
        self.lr = cell.config["train"]["lr"]
        self.watch = Stopwatch(self.device)
        self.readings: Dict = {}
        self.variant = variant

    def _step(self, i: int) -> Dict[str, float]:
        b = self.traffic.batches[i % len(self.traffic.batches)]
        metrics, self.last_disp = self.fn(b["iml"], b["imr"], b["disp"],
                                          self.lr)
        return {k: float(v) for k, v in metrics.items()}

    def warmup(self) -> None:
        """The checked steps: each step's loss, each parameter's first
        gradient as Adam holds it (its first moment over 1 - beta1) and its
        change after the last."""
        tr = self.trainer
        named = dict(tr.model.named_parameters())
        start = {k: p.detach().double().clone() for k, p in named.items()}
        losses = []
        for i in range(self.cell.mix["checked_steps"]):
            losses.append(self._step(i)["loss"])
            if i == 0:
                disp = self.last_disp.float().cpu()
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
        self.watch.sync()

    def window(self, seconds: float, first: int = 0) -> dict:
        n, bad = 0, 0
        i = first or self.cell.mix["checked_steps"]
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            m = self._step(i + n)
            if not all(math.isfinite(v) for v in m.values()):
                bad += 1
            n += 1
        return {"attempted": n, "failed": bad,
                "seconds": time.perf_counter() - t0, "next": i + n}

    def layer_ms(self, layer: str, n: int = 10) -> Optional[float]:
        if layer != "features":
            return None
        b = self.traffic.batches[0]
        il = torch.from_numpy(b["iml"]).to(self.device)
        ir = torch.from_numpy(b["imr"]).to(self.device)
        geo = (b["board_h"], b["board_w_left"], b["board_w_right"])
        return self.watch.mean_ms(lambda: self.trainer.features(il, ir, *geo),
                                  n)


def make_sut(cell: Cell, seed: int, device, variant=None):
    cls = TrainSUT if cell.kind == "train" else ServeSUT
    return cls(cell, seed, device, variant)


# ---------------------------------------------------------------------------
# the profiled sub-window


@dataclasses.dataclass
class Trace:
    busy_s: float
    window_s: float
    kernels: Dict[str, List[float]]     # name -> [seconds, launches]
    idle_by_host: Dict[str, float]      # host op -> idle seconds under it

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
    return Trace(busy / 1e6, (w1 - w0) / 1e6, kernels, idle)


def profiled_window(sut, seconds: float, first: int) -> Trace:
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
    (``disparity_gaps``),
    the worst request's of each. ``gap_ratio`` is a request's mean gap
    over the mean gap that rounding the reference's feature volume to
    bfloat16 causes: the gap in units of the seed's weights' sensitivity
    to rounding, which is steady from seed to seed where the gap in px
    follows the weights' logit scale. With
    ``control`` the reference in fp8 stands in the program's place."""
    mc, m = cell.config["model"], cell.config["matching"]
    model = RM.build(mc, device)
    model.load_state_dict(state_dict)
    if control:
        model_c = RM.build(mc, device)
        model_c.load_state_dict(state_dict)
        RC.fp8_convs(model_c)
    worst = {"bad_shape": 0.0}
    each = []
    with torch.no_grad(), fp32():
        for i, got in sample:
            l, r = traffic.pair(i)
            h, w = l.shape
            if got.shape != (h, w) or not np.isfinite(got).all():
                worst["bad_shape"] += 1
                continue
            pl, pr = RF.pad_to_bucket(l, r, mc["encoder_ds"])
            vol = RF.features_test(torch.from_numpy(pl).to(device),
                                   torch.from_numpy(pr).to(device),
                                   mc["max_disp"], m)
            crop = (0, slice(pl.shape[0] - h, None), slice(0, w))
            ref = model(vol[None])[crop]
            yard = model(vol[None].bfloat16().float())[crop]
            got = (model_c(vol[None])[crop] if control
                   else torch.from_numpy(got).to(device))
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
    n = cell.mix["checked_steps"]
    with fp32():
        ref = RT.steps(cell.config, state_dict, traffic.batches,
                       cell.config["train"]["lr"], device, n)
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
        return KC.KERNELS[kernel](*census_launch_shape(self.cell))["bound_s"]


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


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             t_start: float, variant: Optional[str] = None,
             profile_s: float = 3.0) -> dict:
    """One run; returns the result object (``checks`` last) and the
    readings under ``"readings"``, which ``run.py`` drops."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    sut = make_sut(cell, seed, device, variant)
    if variant is not None and variant.startswith("fault:"):
        from . import faults
        faults.plant(variant[6:], sut)
    sut.warmup()
    setup_s = time.time() - t_start
    win = sut.window(seconds)
    sut.watch.sync()
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
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
        ctx = Context(cell, sut, tr, items, win["seconds"],
                      flops_per_item(cell))
        metrics = {}
        for m in cell.per_layer:
            v = read_metric(m["name"], ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        del ctx
        device_info.update(busy_s=tr.busy_s, window_s=tr.window_s)
        breakdown = tr.breakdown()
        log(f"power: {power_limit()}")
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
    bad = forbidden_modules()
    if bad:
        raise SystemExit(f"modules of {bad} are loaded; the port and the "
                         "benchmark must run without them")
    if cell.kind == "train":
        if variant == "control":
            with fp32():
                program = RT.steps(cell.config, state_dict, traffic.batches,
                                   cell.config["train"]["lr"], device,
                                   cell.mix["checked_steps"],
                                   wrap=RC.fp8_convs)
        readings = train_readings(cell, state_dict, traffic, program, device)
    else:
        readings = serve_readings(cell, state_dict, traffic, sample, device,
                                  control=variant == "control")
        readings["unanswered"] = float(win["failed"])
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
