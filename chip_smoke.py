#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (msnets_tpu_torch) on one NVIDIA GPU and check it.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, each of which fails the run on error:
  1. device     the card's name and power limit (nvidia-smi);
  2. build      nvcc builds every kernel of msnets_tpu_torch/csrc/, all at once;
  3. kernel     census_aml against its plain PyTorch version (cost exact, AML
                atol 1e-6) and census against its plain version (exact), at
                the serving path's shapes and at edge shapes; then each
                kernel's time, its plain version's time and its bound;
  4. features   a known-disparity pair through ms_features on the card, 8 and
                16 channels: the census-AML channels (left 4, right 12) must
                peak at the true disparity;
  5. serve      StereoServer with the default configuration (MS-GCNet,
                max_disp 192, F=32, bfloat16, 8 channels) and seeded random
                weights answers 3 requests at 256x512 and one at 375x1242;
                census_aml must launch once per request and census never;
                then ms/pair and the features/model split, and a profile;
  6. precision  the bfloat16 server against a float32 run (TF32 off);
  7. serve16    the same with the 16-channel matching space (in_channels 16):
                census once per request, census_aml never; timings, a
                profile and bfloat16 against float32;
  8. serve_raw  the raw-intensity volume (in_channels 2), one request at each
                size: no kernel launches.
Then a {"kernels": [...]} line, and as the last line
{"ok": true, "device": {...}}. Without CUDA, or without the package beside
this file, it exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

# H100 SXM data-sheet peaks (dense): HBM bandwidth and float32 outside the
# tensor cores. The bound of a kernel is the larger of bytes/HBM and ops/F32.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

MAIN_SHAPE = (148, 276, 96)         # half-res 128x256 + 10-px pad, D=192/2
TIMED_SHAPES = [MAIN_SHAPE, (212, 644, 96)]    # the 256x512 and 384x1248 buckets
KERNEL_CASES = [                    # name, H, W, ndisp, wsize, sigma
    ("main 148x276 D96", 148, 276, 96, 11, 128.0),
    ("kitti 212x644 D96", 212, 644, 96, 11, 128.0),
    ("ragged 45x131 D40", 45, 131, 40, 11, 64.0),
    ("ndisp>W 30x20 D32", 30, 20, 32, 11, 128.0),
    ("W=8 12x8 D4", 12, 8, 4, 11, 128.0),
    ("wsize5 33x70 D17", 33, 70, 17, 5, 32.0),
]
AML_ATOL = 1e-6
# bf16 vs f32 disparity: bf16 keeps 8 significant bits (0.4% per rounding);
# over 18 conv layers the logits move by ~1%, which moves the soft-argmin
# expectation by a small fraction of a pixel on average. A mean drift of a
# full pixel would mean the bf16 path is wrong, not rounded.
PRECISION_MEAN_PX = 1.0


def log(*a):
    print(*a, flush=True)


def cuda_time_ms(fn, n: int) -> float:
    """Mean ms per call of ``fn`` over ``n`` calls, from CUDA events."""
    import torch
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def device_kernel_ms(fn, n: int, names) -> dict:
    """Device time per call of ``fn`` spent in kernels whose name contains
    each of ``names``, from torch.profiler (0.0 where it saw none)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    us = dict.fromkeys(names, 0.0)
    for e in prof.key_averages():
        for k in names:
            if k in e.key:
                us[k] += getattr(e, "device_time_total", 0.0) or getattr(
                    e, "cuda_time_total", 0.0)
    return {k: v / 1e3 / n for k, v in us.items()}


def textured_pair(h: int, w: int, shift: int, seed: int):
    """A random texture and its copy shifted by ``shift`` px (left image
    sees x, right image sees x - shift)."""
    base = np.random.default_rng(seed).integers(0, 256, (h, w + shift),
                                                dtype=np.uint8)
    return (np.ascontiguousarray(base[:, shift:]),
            np.ascontiguousarray(base[:, :w]))


def phase_device(state):
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    state["smi"] = smi[0].strip()
    log("nvidia-smi:", state["smi"])
    log("torch", torch.__version__, "cuda", torch.version.cuda, "device",
        torch.cuda.get_device_name(0), "count", torch.cuda.device_count())


def phase_build(state):
    from msnets_tpu_torch.ops.cuda import _build
    t0 = time.perf_counter()
    built = _build.build()
    log(f"build: {len(built)} kernel libraries in "
        f"{time.perf_counter() - t0:.2f} s")
    for name, info in built.items():
        log(f"  {name}: {info['seconds']:.2f} s -> {info['path']}")
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                log("   ", line.strip())


def phase_kernel(state):
    import torch
    from msnets_tpu_torch.config import INVALID
    from msnets_tpu_torch.ops.cuda.census import census, census_reference
    from msnets_tpu_torch.ops.cuda.census_aml import (census_aml,
                                                      census_aml_reference)
    rng = np.random.default_rng(0)
    worst = {"census_aml": 0.0, "census": 0.0}
    for name, H, W, D, wsize, sigma in KERNEL_CASES:
        a = torch.from_numpy(rng.integers(0, 256, (H, W), dtype=np.uint8)).cuda()
        b = torch.from_numpy(rng.integers(0, 256, (H, W), dtype=np.uint8)).cuda()
        cost, aml = census_aml(a, b, D, wsize, sigma)
        rc, ra = census_aml_reference(a, b, D, wsize, sigma)
        raw = census(a, b, D, wsize)
        rr = census_reference(a, b, D, wsize)
        torch.cuda.synchronize()
        cost_err = (cost - rc).abs().max().item()
        aml_err = (aml - ra).abs().max().item()
        raw_err = (raw - rr).abs().max().item()
        worst["census_aml"] = max(worst["census_aml"], cost_err, aml_err)
        worst["census"] = max(worst["census"], raw_err)
        log(f"kernel {name} w{wsize}: census_aml cost max|d|={cost_err:.3g} "
            f"aml max|d|={aml_err:.3g}; census max|d|={raw_err:.3g}")
        assert cost.shape == aml.shape == raw.shape == (D, H, W)
        assert torch.equal(cost, rc), f"{name}: cost channel not exact"
        assert aml_err <= AML_ATOL, f"{name}: AML off by {aml_err}"
        assert torch.equal(raw, rr), f"{name}: census not exact"
        if W < wsize:
            assert bool((cost == 1.0).all()) and bool((aml == 0).all())
            assert bool((raw == INVALID).all())
    state["max_abs_err"] = worst
    for kernel in ("census_aml", "census"):
        for shape in TIMED_SHAPES:
            t = _time_kernel(kernel, *shape, rng)
            split = ", ".join(f"{k} {v:.4f}" for k, v in t["by_kernel"].items())
            log(f"{kernel} {shape[0]}x{shape[1]} D{shape[2]}: device "
                f"{t['ms_device']:.4f} ms/call (profiler: {split}), events "
                f"{t['ms_events']:.4f} ms/call (host launches included); "
                f"plain {t['plain_ms']:.4f} ms; bound {t['bound_ms']:.4f} ms "
                f"by {t['bound_by']} ({t['bytes'] / 1e6:.1f} MB, "
                f"{t['ops'] / 1e6:.1f} Mop); {t['ms'] / t['bound_ms']:.2f}x "
                f"the bound [{state['smi']}]")
            if shape == MAIN_SHAPE:
                state[kernel] = t


def _time_kernel(kernel: str, H: int, W: int, D: int, rng) -> dict:
    """A kernel's time (profiler device time, else CUDA events), its plain
    version's time and its bound, on random uint8 images of [H, W]."""
    import torch
    from msnets_tpu_torch.ops.cuda import census as C, census_aml as CA
    a = torch.from_numpy(rng.integers(0, 256, (H, W), dtype=np.uint8)).cuda()
    b = torch.from_numpy(rng.integers(0, 256, (H, W), dtype=np.uint8)).cuda()
    if kernel == "census_aml":
        run = lambda: CA.census_aml(a, b, D)                # noqa: E731
        plain = lambda: CA.census_aml_reference(a, b, D)    # noqa: E731
        names = ("census_aml_planes", "pack_descriptors")
        # uint8 in, 2x f32 out; per (d, pixel): xor+popc+add over 4 words
        # (12), AML sub/mul/mul/exp/add/div (6), cost clip/mul (3)
        out_planes, ops_per = 2, 21
    else:
        run = lambda: C.census(a, b, D)                     # noqa: E731
        plain = lambda: C.census_reference(a, b, D)         # noqa: E731
        names = ("census_cost_planes", "pack_descriptors")
        out_planes, ops_per = 1, 12     # uint8 in, f32 out; xor+popc+add
    for _ in range(5):
        run()
        plain()
    t = {"ms_events": cuda_time_ms(run, 100),
         "by_kernel": device_kernel_ms(run, 50, names),
         "plain_ms": cuda_time_ms(plain, 10)}
    t["ms_device"] = sum(t["by_kernel"].values())
    t["ms"] = t["ms_device"] or t["ms_events"]
    t["bytes"] = 2 * H * W + out_planes * D * H * W * 4
    # the integer and exp operations are counted at the float32 rate, the
    # only non-tensor-core rate published
    t["ops"] = ops_per * D * H * W
    bytes_ms = t["bytes"] / HBM_BYTES_PER_S * 1e3
    ops_ms = t["ops"] / F32_OPS_PER_S * 1e3
    t["bound_ms"] = max(bytes_ms, ops_ms)
    t["bound_by"] = "bytes" if bytes_ms >= ops_ms else "operations"
    return t


def phase_features(state):
    import torch
    from msnets_tpu_torch.config import MatchingConfig
    from msnets_tpu_torch.ops.features import ms_features
    base = np.random.default_rng(0).integers(0, 256, (48, 103), dtype=np.uint8)
    L = torch.from_numpy(np.ascontiguousarray(base[:, :96])).cuda()
    R = torch.from_numpy(np.ascontiguousarray(base[:, 7:])).cuda()
    f = ms_features(L, R, 16, MatchingConfig(), 5, 20, 0, True)
    acc = (f[4].argmax(0)[8:-8, 8:-8] == 7).float().mean().item()
    log(f"features: shape {tuple(f.shape)}, census-AML argmax accuracy "
        f"{acc:.4f} at true disparity 7")
    assert tuple(f.shape) == (8, 16, 38, 76) and bool(torch.isfinite(f).all())
    assert acc > 0.99, acc
    f = ms_features(L, R, 16, MatchingConfig(num_channels=16), 5, 20, 0, False)
    assert tuple(f.shape) == (16, 16, 38, 76) and bool(torch.isfinite(f).all())
    acc_l = (f[4].argmax(0)[8:-8, 8:-8] == 7).float().mean().item()
    # right pixel j sees left pixel j + 7: keep the columns whose left pixel
    # lies inside the same interior
    acc_r = (f[12].argmax(0)[8:-8, 8:76 - 8 - 7] == 7).float().mean().item()
    log(f"features 16ch: census-AML argmax accuracy left {acc_l:.4f}, right "
        f"{acc_r:.4f} at true disparity 7")
    assert acc_l > 0.99 and acc_r > 0.99, (acc_l, acc_r)


def _random_state_dict(cfg, seed: int):
    import torch
    from msnets_tpu_torch.models import build_model
    g = torch.Generator().manual_seed(seed)
    m = build_model(cfg.model, "cpu", generator=g)
    with torch.no_grad():                       # non-identity BN to fold
        for bn in m.modules():
            if isinstance(bn, torch.nn.BatchNorm3d):
                c = bn.num_features
                bn.weight.copy_(0.5 + torch.rand(c, generator=g))
                bn.bias.copy_(0.2 * torch.randn(c, generator=g))
                bn.running_mean.copy_(0.3 * torch.randn(c, generator=g))
                bn.running_var.copy_(0.5 + 1.5 * torch.rand(c, generator=g))
    return m.state_dict()


def _check_disp(d, shape, max_disp):
    assert d.shape == shape, (d.shape, shape)
    assert d.dtype == np.float32 and np.isfinite(d).all()
    assert d.min() >= 0 and d.max() < max_disp, (d.min(), d.max())


def _counts():
    from msnets_tpu_torch.ops.cuda.census import census
    from msnets_tpu_torch.ops.cuda.census_aml import census_aml
    return {"census_aml": census_aml.launches, "census": census.launches}


def _reset_counts():
    from msnets_tpu_torch.ops.cuda.census import census
    from msnets_tpu_torch.ops.cuda.census_aml import census_aml
    census_aml.launches = 0
    census.launches = 0


def _serve(state, tag, cfg, requests, per_request, timed_runs):
    """Serve ``requests`` with seeded random weights and check each result,
    the buckets and the kernel launches (``per_request``: launches of each
    kernel per request); then ms/pair at 256x512 and 375x1242
    (``timed_runs`` calls each) and the 256x512 features/model split and
    peak memory."""
    from msnets_tpu_torch.serve import exact_bucket
    import torch
    from msnets_tpu_torch import StereoServer
    sd = _random_state_dict(cfg, 0)
    server = StereoServer(cfg, sd)                  # default device: the GPU
    assert server.device.type == "cuda"
    t0 = time.perf_counter()
    server.warmup([(256, 512), (375, 1242)])
    log(f"{tag}: warmup of 2 buckets {time.perf_counter() - t0:.2f} s")

    _reset_counts()                                 # main path starts here
    outs = [server.predict(l, r) for l, r in requests]
    launches = _counts()                            # main path ends here
    for (l, _), d in zip(requests, outs):
        _check_disp(d, l.shape, cfg.model.max_disp)
        log(f"{tag}: request {l.shape} -> disparity mean {d.mean():.3f} "
            f"range [{d.min():.3f}, {d.max():.3f}]")
    want = {k: n * len(requests) for k, n in per_request.items()}
    st = server.stats()
    log(f"{tag}: kernel launches in the main path: {launches} for "
        f"{len(requests)} requests; stats {st}")
    assert launches == want, (launches, want)
    hits = {}
    for l, _ in requests:
        b = exact_bucket(*l.shape)
        hits[b] = hits.get(b, 0) + 1
    assert st["frames"] == len(requests) and st["bucket_hits"] == hits, st

    for (h, w), n in zip(((256, 512), (375, 1242)), timed_runs):
        l, r = textured_pair(h, w, 32, 10)
        ms = cuda_time_ms(lambda: server.predict(l, r), n)
        log(f"{tag} {h}x{w}: {ms:.3f} ms/pair, {1e3 / ms:.2f} pairs/s "
            f"(batch 1, predict incl. host pad and copies) [{state['smi']}]")
        state[f"{tag}_{h}x{w}_ms"] = ms
    il, ir = (torch.from_numpy(x).cuda() for x in textured_pair(256, 512, 32, 11))
    with torch.inference_mode():
        feats = server.features(il, ir)
        f_ms = cuda_time_ms(lambda: server.features(il, ir), 10)
        m_ms = cuda_time_ms(lambda: server.model(feats[None]), 10)
    log(f"{tag} 256x512 split: features {f_ms:.3f} ms, model {m_ms:.3f} ms "
        f"(volume {tuple(feats.shape)} {feats.dtype}) [{state['smi']}]")
    torch.cuda.reset_peak_memory_stats()
    server.forward(il, ir)
    torch.cuda.synchronize()
    log(f"{tag} 256x512 peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
        f"[{state['smi']}]")
    return server, sd, launches, il, ir


def phase_serve(state):
    from msnets_tpu_torch import Config
    cfg = Config()
    assert (cfg.model.name, cfg.model.max_disp, cfg.model.base_filters,
            cfg.model.compute_dtype) == ("MS-GCNet", 192, 32, "bfloat16")
    requests = [textured_pair(256, 512, 24 + 8 * i, i) for i in range(3)]
    requests.append(textured_pair(375, 1242, 40, 3))
    server, sd, launches, il, ir = _serve(
        state, "serve", cfg, requests, {"census_aml": 1, "census": 0},
        (20, 5))
    state["launches"] = {"census_aml": launches["census_aml"]}
    state["state_dict"] = sd
    state["server"] = server
    _profile("serve", server, il, ir)


def _profile(tag, server, il, ir):
    """Device time by kernel for one 256x512 forward, and the device's busy
    share of the wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        server.forward(il, ir)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0.0) or getattr(
            e, "self_cuda_time_total", 0.0)
        if us > 0 and e.device_type.name == "CUDA":
            rows.append((us, e.count, e.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows) / 1e3
    log(f"{tag} profile 256x512 forward: device busy {busy:.3f} ms of "
        f"{wall_ms:.3f} ms wall (profiler on), {len(rows)} kernel names")
    for us, cnt, key in rows[:12]:
        log(f"  {us / 1e3:9.3f} ms  x{cnt:<5d} {key[:90]}")


def _precision(tag, server, sd):
    """The bf16 ``server`` against a float32 server of the same weights
    (TF32 off) on one 256x512 pair."""
    import dataclasses
    from msnets_tpu_torch import StereoServer
    from msnets_tpu_torch.runtime import fp32_reference
    cfg = server.cfg
    cfg32 = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, compute_dtype="float32"))
    l, r = textured_pair(256, 512, 32, 12)
    d16 = server.predict(l, r)
    with fp32_reference():
        d32 = StereoServer(cfg32, sd).predict(l, r)
    diff = np.abs(d16 - d32)
    log(f"{tag} 256x512: bf16 vs f32 (TF32 off) |d disparity| max "
        f"{diff.max():.4f} px, mean {diff.mean():.4f} px, "
        f"median {np.median(diff):.4f} px")
    assert np.isfinite(d32).all()
    assert diff.mean() < PRECISION_MEAN_PX, diff.mean()


def phase_precision(state):
    _precision("precision", state.pop("server"), state["state_dict"])


def phase_serve16(state):
    from msnets_tpu_torch import Config, MatchingConfig, ModelConfig
    cfg = Config(matching=MatchingConfig(num_channels=16),
                 model=ModelConfig(in_channels=16))
    assert (cfg.model.name, cfg.model.max_disp, cfg.model.base_filters,
            cfg.model.compute_dtype) == ("MS-GCNet", 192, 32, "bfloat16")
    requests = [textured_pair(256, 512, 24 + 8 * i, 20 + i) for i in range(3)]
    requests.append(textured_pair(375, 1242, 40, 23))
    server, sd, launches, il, ir = _serve(
        state, "serve16", cfg, requests, {"census_aml": 0, "census": 1},
        (20, 5))
    state["launches"]["census"] = launches["census"]
    _profile("serve16", server, il, ir)
    _precision("precision16", server, sd)


def phase_serve_raw(state):
    from msnets_tpu_torch import Config, MatchingConfig, ModelConfig
    cfg = Config(matching=MatchingConfig(features_mode="raw"),
                 model=ModelConfig(in_channels=2))
    requests = [textured_pair(256, 512, 32, 30), textured_pair(375, 1242, 40, 31)]
    _serve(state, "serve_raw", cfg, requests, {"census_aml": 0, "census": 0},
           (10, 3))


def main() -> int:
    import torch
    if not __debug__:
        print("chip_smoke: its checks are asserts; run it without -O",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    if not (ROOT / "msnets_tpu_torch" / "__init__.py").is_file():
        print(f"chip_smoke: msnets_tpu_torch not found beside {__file__}; "
              "run it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    state = {}
    phases = [phase_device, phase_build, phase_kernel, phase_features,
              phase_serve, phase_precision, phase_serve16, phase_serve_raw]
    for phase in phases:
        t0 = time.perf_counter()
        log(f"== {phase.__name__[6:]}")
        try:
            phase(state)
        except Exception:
            traceback.print_exc()
            print(f"chip_smoke: phase {phase.__name__[6:]} FAILED",
                  file=sys.stderr, flush=True)
            return 1
        log(f"== {phase.__name__[6:]} ok ({time.perf_counter() - t0:.1f} s)")

    sources = {
        "census_aml": ("msnets_tpu_torch/csrc/census_aml.cu",
                       "msnets_tpu/ops/pallas/census_aml_pallas.py:94"),
        "census": ("msnets_tpu_torch/csrc/census.cu",
                   "msnets_tpu/ops/pallas/census_pallas.py:79"),
    }
    kernels = []
    for name, (source, replaces) in sources.items():
        t = state[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": state["launches"][name],
            "max_abs_err": state["max_abs_err"][name], "ms": t["ms"],
            "kernel_ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": None,
        })
    log(state["smi"])
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
