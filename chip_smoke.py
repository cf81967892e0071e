#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (msnets_tpu_torch) on one NVIDIA GPU and check it.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, each of which fails the run on error:
  1. device     the card's name, power limit and maximum SM clock
                (nvidia-smi);
  2. build      nvcc builds every kernel of msnets_tpu_torch/csrc/, and each
                again with -DMSN_PHASES=1 for phase 9, all at once;
  3. kernel     census_aml against its plain PyTorch version (cost exact, AML
                atol 1e-6) and census against its plain version (exact), at
                the serving and training paths' shapes and at the tiling's
                edge shapes;
                then each kernel's profiler device time (the profiler must
                see the kernel), its plain version's time and its bound
                (bytes at HBM rate; popc and exp at 16/clock/SM, the rest
                at the float32 rate);
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
                size: no kernel launches;
  9. phases     each kernel's mean time a block in each of its phases
                (staging, descriptors, passes), from the marks its
                -DMSN_PHASES=1 build records;
 10. train      the reference recipe, Config() (MS-GCNet, F=32, max_disp
                192, crop 256x512 with margins: 280x704 uint8 crops, batch
                2, bfloat16, Adam lr 1e-3), seeded random weights, 8 steps on
                one synthetic batch of known disparity: every loss finite,
                the last below the first, census_aml twice a step; ms/step
                (CUDA events, median of steps 3-8) and peak memory. Then one
                step of the 16-channel configuration at batch 1 (census
                once) and one with grad_accum=2 at batch 2;
 11. checkpoint a step checkpoint written in the background while the next
                step runs, loaded into a fresh Trainer: parameters, BN
                statistics, Adam moments and steps equal bit for bit; one
                step after the resume equals the step the trainer took
                (cuDNN's deterministic algorithms on for this phase);
                StereoServer.from_checkpoint of an epoch file serves a
                256x512 pair as the server of the same state_dict does;
 12. stream     predict_stream over 16 requests at 256x512, depth 2: each
                result equals predict's, census_aml once a request; pairs/s
                of the stream and of a predict loop;
 13. serve_psmnet
                StereoServer with ModelConfig(name="MS-PSMNet") (max_disp
                192, F=32, bfloat16, 8 channels), seeded random weights:
                3 requests at 256x512 and one at 375x1242, census_aml once a
                request and census never; ms/pair, the features/model
                split, a profile, the peak memory of one forward, and
                bfloat16 against float32 (TF32 off);
 14. train_psmnet
                Config() with MS-PSMNet (crop 256x512 with margins, batch 2,
                Adam 1e-3): 8 steps on one synthetic batch of known
                disparity (every loss finite, the last below the first,
                census_aml twice a step; ms/step, median of steps 3-8, and
                peak memory); one step of the CLI's default for batch 2
                (grad_accum=2, no remat); then, from one seed and under
                cuDNN's deterministic algorithms, one step without remat
                and one with remat at remat_scope "all" and at "hourglass":
                the peak memory of each, each remat loss equal to the plain
                one to 1e-3 relative, the BN running statistics equal;
 15. cli        python -m msnets_tpu_torch.cli's main() on a synthetic
                KITTI-2015 tree of 3 frames at 375x1242 (ground truth as
                PFM; the frames reach the pipeline through its read_gray
                and read_rgb seam, the card's machine having no OpenCV):
                --mode train (MS-GCNet, 2 steps at a 128x256 crop), --mode
                test on the checkpoint it wrote (colour PNGs off), --mode
                eval-badx; census_aml once a step and once a frame; the
                PFMs equal StereoServer.predict's of the same frames and
                weights bit for bit (cuDNN's deterministic algorithms), and
                eval-badx gives the test's averages.
Then a {"kernels": [...]} line, and as the last line
{"ok": true, "device": {...}}. Without CUDA, or without the
package beside this file, it exits non-zero and prints no result.
"""
from __future__ import annotations

import ctypes
import dataclasses
import json
import re
import shutil
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

# H100 SXM data-sheet peaks (dense): HBM bandwidth and float32 outside the
# tensor cores; __popc and the exponential issue at 16 per clock per SM
# (CUDA C++ Programming Guide, throughput table, compute capability 9.0), at
# the SM clock nvidia-smi reports. A kernel's bound is the larger of
# bytes/HBM and its operations at their rates.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
SFU_OPS_PER_CLOCK_PER_SM = 16

MAIN_SHAPE = (148, 276, 96)         # half-res 128x256 + 10-px pad, D=192/2
TIMED_SHAPES = [MAIN_SHAPE, (212, 644, 96)]    # the 256x512 and 384x1248 buckets
KERNEL_CASES = [                    # name, H, W, ndisp, wsize, sigma
    ("main 148x276 D96", 148, 276, 96, 11, 128.0),
    ("kitti 212x644 D96", 212, 644, 96, 11, 128.0),
    ("ds1 148x276 D192", 148, 276, 192, 11, 128.0),
    # the train path: 280x704 crops (8ch) and 280x896 (16ch) at half res
    ("train 140x352 D96", 140, 352, 96, 11, 128.0),
    ("train16 140x448 D96", 140, 448, 96, 11, 128.0),
    ("ragged 45x131 D40", 45, 131, 40, 11, 64.0),
    ("ragged 37x301 D95 sigma1e18", 37, 301, 95, 11, 1e18),
    ("D17 21x97", 21, 97, 17, 11, 128.0),
    ("two chunks 16x400 D300", 16, 400, 300, 11, 1e18),
    ("past kept 13x600 D560", 13, 600, 560, 11, 128.0),
    ("ndisp>W 30x20 D32", 30, 20, 32, 11, 128.0),
    ("H=1 1x64 D16", 1, 64, 16, 11, 128.0),
    ("W=12 one valid col 13x12 D8", 13, 12, 8, 11, 128.0),
    ("W=11 no valid col 9x11 D8", 9, 11, 8, 11, 128.0),
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


def device_kernels_ms(fn, n: int) -> dict:
    """Device time of ``n`` calls of ``fn`` by kernel name, from
    torch.profiler: {name: (ms per recorded launch, launches recorded)}."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", 0.0) or getattr(
            e, "self_cuda_time_total", 0.0)
        if t > 0 and e.device_type.name == "CUDA":
            ms, count = out.get(e.key, (0.0, 0))
            out[e.key] = (ms + t / 1e3, count + e.count)
    return {k: (ms / count, count) for k, (ms, count) in out.items()}


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
    clock = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60, check=True).stdout.split()[0]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    state["sfu_ops_per_s"] = SFU_OPS_PER_CLOCK_PER_SM * sms * float(clock) * 1e6
    log(f"SMs {sms}, max SM clock {clock} MHz: __popc and exp at "
        f"{state['sfu_ops_per_s'] / 1e12:.2f} T/s")
    log("torch", torch.__version__, "cuda", torch.version.cuda, "device",
        torch.cuda.get_device_name(0), "count", torch.cuda.device_count())


def phase_build(state):
    """Every kernel of csrc/, and each again with -DMSN_PHASES=1 for the
    "phases" phase: one nvcc per library, all started together."""
    from concurrent.futures import ThreadPoolExecutor
    from msnets_tpu_torch.ops.cuda import _build
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        jobs = [pool.submit(_build.build, None, d) for d in ((), PHASE_DEFINES)]
        built = [(name + "".join(f" -D{x}" for x in d), info)
                 for d, job in zip(((), PHASE_DEFINES), jobs)
                 for name, info in job.result().items()]
    log(f"build: {len(built)} kernel libraries in "
        f"{time.perf_counter() - t0:.2f} s")
    for name, info in built:
        log(f"  {name}: {info['seconds']:.2f} s -> {info['path']}")
        for line in info["log"].splitlines():
            entry = re.search(r"Compiling entry .*?((?:census_aml|census)_tile)ILi(\d+)E", line)
            if entry:
                log(f"    {entry[1]}<{entry[2]}>:")
            elif "registers" in line or "spill" in line or "error" in line:
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
        if _valid_entries(H, W, D, wsize)[1] == 0:        # all INVALID
            assert bool((cost == 1.0).all()) and bool((aml == 0).all())
            assert bool((raw == INVALID).all())
    state["max_abs_err"] = worst
    for kernel in ("census_aml", "census"):
        for shape in TIMED_SHAPES:
            t = _time_kernel(kernel, *shape, rng, state["sfu_ops_per_s"])
            split = ", ".join(f"{k} {v:.4f}" for k, v in t["by_kernel"].items())
            log(f"{kernel} {shape[0]}x{shape[1]} D{shape[2]}: device "
                f"{t['ms']:.4f} ms/call (profiler: {split}), events "
                f"{t['ms_events']:.4f} ms/call (host launches included); "
                f"plain {t['plain_ms']:.4f} ms; bound {t['bound_ms']:.4f} ms "
                f"by {t['bound_by']}: bytes {t['bytes_ms']:.4f} ms "
                f"({t['bytes'] / 1e6:.1f} MB), operations {t['ops_ms']:.4f} ms "
                f"({t['sfu_ops'] / 1e6:.1f} M popc+exp at 16/clk/SM, "
                f"{t['alu_ops'] / 1e6:.1f} M other at the float32 rate); "
                f"{t['ms'] / t['bound_ms']:.2f}x the bound [{state['smi']}]")
            if shape == MAIN_SHAPE:
                state[kernel] = t


PHASE_DEFINES = ("MSN_PHASES=1",)
PHASES = {"census": ("staged", "built", "written"),
          "census_aml": ("staged", "built", "pass 1", "sum", "written")}


def phase_phases(state):
    """Both kernels built with -DMSN_PHASES=1, called through their C
    functions (the wrappers' counts stay as they are) five times at each
    timed shape; from the last call's %globaltimer marks
    (census_common.cuh), each phase's mean time over the blocks and the
    launch's span from the first block's start to the last block's end."""
    import torch
    from msnets_tpu_torch.ops.cuda import _build, census as C, census_aml as CA
    rng = np.random.default_rng(2)
    stream = torch.cuda.current_stream().cuda_stream
    inv_sigma = float(np.float32(1) / np.float32(128.0))
    for kernel, names in PHASES.items():
        lib = _build.load(kernel, PHASE_DEFINES)
        fn = (CA if kernel == "census_aml" else C)._bind(lib)
        read = getattr(lib, f"msn_{kernel}_phases")
        read.argtypes, read.restype = [ctypes.c_void_p], ctypes.c_int
        for H, W, D in TIMED_SHAPES:
            a, b = (torch.from_numpy(rng.integers(0, 256, (H, W), dtype=np.uint8)).cuda()
                    for _ in range(2))
            out = torch.empty((2, D, H, W), dtype=torch.float32, device="cuda")
            if kernel == "census_aml":
                args = (out[0].data_ptr(), out[1].data_ptr(), H, W, D, 11,
                        inv_sigma, stream)
            else:
                args = (out[0].data_ptr(), H, W, D, 11, stream)
            for _ in range(5):
                assert fn(a.data_ptr(), b.data_ptr(), *args) == 0
            torch.cuda.synchronize()
            marks = np.zeros((8, 16384), np.uint64)
            assert read(marks.ctypes.data) == 0
            m = marks[:len(names) + 1].astype(np.int64)
            t = m - m[0]
            # blocks that built descriptors in this call (every mark set)
            fresh = (m[0] > 0) & (t[1:] > 0).all(axis=0)
            assert fresh.any(), f"{kernel}: no block recorded its phases"
            steps = []
            for i, name in enumerate(names, 1):
                steps.append(f"{name} {np.mean(t[i][fresh] - t[i - 1][fresh]) / 1e3:.2f}")
            log(f"phases {kernel} {H}x{W} D{D}: mean us a block: "
                + ", ".join(steps) + f"; span {np.ptp(m[:, fresh]) / 1e3:.2f} us "
                f"over the {fresh.sum()} blocks that built descriptors "
                f"[{state['smi']}]")


def _valid_entries(H: int, W: int, D: int, wsize: int = 11):
    """(valid pixels, valid (d, pixel) entries) of the reference mask: rows
    and cols [wc, n - wsize + wc), d <= c - wc."""
    rows, cols = max(0, H - wsize), max(0, W - wsize)
    per_row = sum(min(D, k) for k in range(1, cols + 1))
    return rows * cols, rows * per_row


def _time_kernel(kernel: str, H: int, W: int, D: int, rng,
                 sfu_ops_per_s: float) -> dict:
    """A kernel's profiler device time (it must see the kernel), its CUDA-event
    time, its plain version's time and its bound, on random uint8 images of
    [H, W]."""
    import torch
    from msnets_tpu_torch.ops.cuda import census as C, census_aml as CA
    a = torch.from_numpy(rng.integers(0, 256, (H, W), dtype=np.uint8)).cuda()
    b = torch.from_numpy(rng.integers(0, 256, (H, W), dtype=np.uint8)).cuda()
    pixels, entries = _valid_entries(H, W, D)
    if kernel == "census_aml":
        run = lambda: CA.census_aml(a, b, D)                # noqa: E731
        plain = lambda: CA.census_aml_reference(a, b, D)    # noqa: E731
        name = "census_aml_tile"
        # uint8 in, 2x f32 out. 4 popc per valid entry, one exp per entry of
        # a pixel with a valid minimum; 4 xor + 3 add per valid entry, and
        # per output entry clip (2) and scale (1), AML sub/mul/mul/add/div (5)
        out_planes = 2
        sfu = 4 * entries + D * pixels
        alu = 7 * entries + 8 * D * H * W
    else:
        run = lambda: C.census(a, b, D)                     # noqa: E731
        plain = lambda: C.census_reference(a, b, D)         # noqa: E731
        name = "census_tile"
        # uint8 in, f32 out; 4 popc, 4 xor + 3 add + convert per valid entry
        out_planes, sfu, alu = 1, 4 * entries, 8 * entries
    for _ in range(5):
        run()
        plain()
    t = {"ms_events": cuda_time_ms(run, 100),
         "plain_ms": cuda_time_ms(plain, 10)}
    # the median of three profiler sessions that recorded at least 45 of the
    # 50 launches (a session now and then records none or only some)
    times = []
    for _ in range(6):
        seen = device_kernels_ms(run, 50)
        ours = [(ms, c) for k, (ms, c) in seen.items() if name in k]
        if len(ours) == 1 and ours[0][1] >= 45:
            times.append(ours[0][0])
            t["by_kernel"] = {k: ms for k, (ms, _) in seen.items()}
        if len(times) == 3:
            break
    assert times, f"no profiler session recorded 45 of 50 {name} launches: {seen}"
    t["ms"] = float(np.median(times))
    t["bytes"] = 2 * H * W + out_planes * D * H * W * 4
    t["sfu_ops"], t["alu_ops"] = sfu, alu
    t["bytes_ms"] = t["bytes"] / HBM_BYTES_PER_S * 1e3
    t["ops_ms"] = max(sfu / sfu_ops_per_s, alu / F32_OPS_PER_S) * 1e3
    t["bound_ms"] = max(t["bytes_ms"], t["ops_ms"])
    t["bound_by"] = "bytes" if t["bytes_ms"] >= t["ops_ms"] else "operations"
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
    state["launches_by_path"]["serve"] = launches
    state["state_dict"] = sd
    state["server"] = server
    _profile("serve 256x512 forward", lambda: server.forward(il, ir))


def _profile(tag, fn):
    """Device time by kernel for one call of ``fn``, and the device's busy
    share of the wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
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
    log(f"{tag} profile: device busy {busy:.3f} ms of "
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
    state["launches_by_path"]["serve16"] = launches
    _profile("serve16 256x512 forward", lambda: server.forward(il, ir))
    _precision("precision16", server, sd)


def phase_serve_raw(state):
    from msnets_tpu_torch import Config, MatchingConfig, ModelConfig
    cfg = Config(matching=MatchingConfig(features_mode="raw"),
                 model=ModelConfig(in_channels=2))
    requests = [textured_pair(256, 512, 32, 30), textured_pair(375, 1242, 40, 31)]
    _, _, launches, _, _ = _serve(state, "serve_raw", cfg, requests,
                                  {"census_aml": 0, "census": 0}, (10, 3))
    state["launches_by_path"]["serve_raw"] = launches


CKPT_DIR = ROOT / "build" / "chip_smoke_checkpoints"
TRAIN_STEPS = 8
TRAIN_SHIFT = 24          # the synthetic batch's disparity, px


def _train_cfg(**train):
    """Config() with its checkpoints under build/ and ``train`` replaced."""
    from msnets_tpu_torch import Config
    cfg = Config()
    return dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, checkpoint_dir=str(CKPT_DIR), **train))


def _train_batch(cfg, seed):
    from msnets_tpu_torch.data.pipeline import synthetic_train_batch
    t = cfg.train
    return synthetic_train_batch(t.crop_height, t.crop_width,
                                 cfg.model.max_disp, cfg.matching,
                                 t.batch_size, TRAIN_SHIFT, seed,
                                 cfg.matching.left_only)


def _step(trainer, batch, lr=1e-3):
    fn = trainer.step_fn(batch["board_h"], batch["board_w_left"],
                         batch["board_w_right"])
    return fn(batch["iml"], batch["imr"], batch["disp"], lr)


def _one_step(state, tag, cfg, want):
    """One step of a fresh trainer of ``cfg``; checks the loss and the
    launches of each kernel (``want``)."""
    import torch
    from msnets_tpu_torch.engine import Trainer
    tr = Trainer(cfg, seed=1)
    batch = _train_batch(cfg, 5)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    m, d = _step(tr, batch)
    loss = float(m["loss"])
    launches = _counts()
    log(f"{tag}: crops {batch['iml'].shape} uint8, loss {loss:.4f}, "
        f"disparity {tuple(d.shape)}, launches {launches}, peak device "
        f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
        f"[{state['smi']}]")
    assert np.isfinite(loss) and tuple(d.shape) == batch["disp"].shape
    assert launches == want, (launches, want)
    return launches


def phase_train(state):
    import torch
    from msnets_tpu_torch.engine import Trainer
    cfg = _train_cfg()
    t, mdl = cfg.train, cfg.model
    assert (mdl.name, mdl.max_disp, mdl.base_filters, mdl.compute_dtype,
            t.crop_height, t.crop_width, t.batch_size, t.lr, t.grad_accum) == \
        ("MS-GCNet", 192, 32, "bfloat16", 256, 512, 2, 1e-3, 1)
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    tr = Trainer(cfg, seed=0)                       # default device: the GPU
    assert tr.device.type == "cuda"
    batch = _train_batch(cfg, 4)
    assert batch["iml"].shape == (2, 280, 704), batch["iml"].shape
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses = []
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(TRAIN_STEPS)]
    _reset_counts()                                 # main path starts here
    for start, end in events:
        start.record()
        m, _ = _step(tr, batch)
        end.record()
        losses.append(float(m["loss"]))
    launches = _counts()                            # main path ends here
    torch.cuda.synchronize()
    ms = [s.elapsed_time(e) for s, e in events]
    peak = torch.cuda.max_memory_allocated() / 2**30
    log("train: losses " + ", ".join(f"{x:.4f}" for x in losses))
    log("train: ms/step " + ", ".join(f"{x:.1f}" for x in ms))
    step_ms = float(np.median(ms[2:]))
    log(f"train 256x512 batch 2 bf16: {step_ms:.3f} ms/step (median of steps "
        f"3-{TRAIN_STEPS}, CUDA events), peak device memory {peak:.2f} GiB, "
        f"kernel launches {launches} in {TRAIN_STEPS} steps "
        f"({launches['census_aml'] / TRAIN_STEPS:g} census_aml a step) "
        f"[{state['smi']}]")
    assert np.isfinite(losses).all(), losses
    assert losses[-1] < losses[0], losses
    assert launches == {"census_aml": 2 * TRAIN_STEPS, "census": 0}, launches
    _profile("train step 256x512 batch 2", lambda: _step(tr, batch))
    state.update(trainer=tr, train_batch=batch)
    state["launches_by_path"]["train"] = launches

    from msnets_tpu_torch import MatchingConfig, ModelConfig
    cfg16 = dataclasses.replace(
        _train_cfg(batch_size=1), matching=MatchingConfig(num_channels=16),
        model=ModelConfig(in_channels=16))
    state["launches_by_path"]["train16"] = _one_step(
        state, "train16 batch 1", cfg16, {"census_aml": 0, "census": 1})
    state["launches_by_path"]["train_accum2"] = _one_step(
        state, "train grad_accum=2 batch 2", _train_cfg(grad_accum=2),
        {"census_aml": 2, "census": 0})


def _state_equal(a, b) -> bool:
    """Bitwise equality of two Trainers' state: every model tensor (BN
    statistics and num_batches_tracked too), the Adam moments and steps, and
    the step count."""
    import torch
    sa, sb = a.state(), b.state()
    if sa["step"] != sb["step"] or sa["state_dict"].keys() != sb["state_dict"].keys():
        return False
    for k, v in sa["state_dict"].items():
        if not torch.equal(v, sb["state_dict"][k]):
            log(f"  differs: {k}")
            return False
    oa, ob = sa["optimizer"]["state"], sb["optimizer"]["state"]
    return oa.keys() == ob.keys() and all(
        torch.equal(oa[i][k].cpu(), ob[i][k].cpu()) for i in oa for k in oa[i])


def phase_checkpoint(state):
    import copy
    import torch
    from msnets_tpu_torch import StereoServer
    from msnets_tpu_torch.engine import Trainer
    tr, batch = state.pop("trainer"), state.pop("train_batch")
    cfg = tr.cfg
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        saved = Trainer(cfg, seed=2)
        saved.model.load_state_dict(tr.model.state_dict())
        saved.optimizer.load_state_dict(copy.deepcopy(tr.optimizer.state_dict()))
        saved.step = n = tr.step
        t0 = time.perf_counter()
        path = tr.save_step(1, n)
        save_ms = (time.perf_counter() - t0) * 1e3
        m_next, _ = _step(tr, batch)              # in place, during the write
        loss_next = float(m_next["loss"])
        t0 = time.perf_counter()
        tr.finish_checkpoints()
        log(f"checkpoint: save_step returned in {save_ms:.2f} ms, the write "
            f"finished {(time.perf_counter() - t0) * 1e3:.2f} ms after the "
            f"next step; {Path(path).name} {Path(path).stat().st_size / 2**20:.1f} MiB")
        fresh = Trainer(cfg, seed=3)
        meta = fresh.resume(path)
        assert meta == {"epoch": 1, "iteration": n}, meta
        assert _state_equal(saved, fresh), "resumed state is not the saved one"
        assert int(fresh.model.conv3dbn_1[1].num_batches_tracked) == n
        log(f"checkpoint: resumed state equals the saved one bit for bit "
            f"(step {fresh.step}, {len(fresh.optimizer.state)} Adam states)")
        m_res, _ = _step(fresh, batch)
        loss_res = float(m_res["loss"])
        same = _state_equal(tr, fresh)
        log(f"checkpoint: the step after the resume: loss {loss_res:.6f} "
            f"against {loss_next:.6f}; state bit for bit equal: {same}")
        assert loss_res == loss_next and same
    finally:
        torch.backends.cudnn.deterministic = prev

    path = tr.maybe_save(2, {"loss": loss_next, "epe": 0.0, "accu3": 0.0,
                             "batches": 1})
    tr.finish_checkpoints()
    l, r = textured_pair(256, 512, 32, 40)
    got = StereoServer.from_checkpoint(cfg, path).predict(l, r)
    want = StereoServer(cfg, tr.model.state_dict()).predict(l, r)
    _check_disp(got, (256, 512), cfg.model.max_disp)
    log(f"checkpoint: from_checkpoint({Path(path).name}) serves 256x512, "
        f"max |d disparity| against the trainer's state_dict "
        f"{np.abs(got - want).max():.3g} px")
    assert np.array_equal(got, want)
    shutil.rmtree(CKPT_DIR, ignore_errors=True)


STREAM_REQUESTS = 16


def phase_stream(state):
    import torch
    from msnets_tpu_torch import Config, StereoServer
    server = StereoServer(Config(), state["state_dict"], depth=2)
    server.warmup([(256, 512)])
    pairs = [textured_pair(256, 512, 16 + 4 * i, 50 + i)
             for i in range(STREAM_REQUESTS)]
    # cuDNN's transposed-convolution algorithms may sum in a run-dependent
    # order: the stream is held to predict bit for bit with the
    # deterministic ones
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        _reset_counts()                             # main path starts here
        got = list(server.predict_stream(iter(pairs)))
        launches = _counts()                        # main path ends here
        want = [server.predict(l, r) for l, r in pairs]
    finally:
        torch.backends.cudnn.deterministic = prev
    assert launches == {"census_aml": STREAM_REQUESTS, "census": 0}, launches
    state["launches_by_path"]["stream"] = launches
    assert len(got) == STREAM_REQUESTS
    for d, w in zip(got, want):
        _check_disp(d, (256, 512), 192)
        assert np.array_equal(d, w), "stream != predict"
    log(f"stream: {STREAM_REQUESTS} results equal predict's in input order; "
        f"launches {launches}")

    def loop():
        return [server.predict(l, r) for l, r in pairs]

    def stream():
        return list(server.predict_stream(iter(pairs)))

    rates = {"predict": [], "stream": []}
    for name, fn in (("predict", loop), ("stream", stream),
                     ("stream", stream), ("predict", loop)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        rates[name].append(STREAM_REQUESTS / (time.perf_counter() - t0))
    for name, r in rates.items():
        log(f"stream 256x512 {name}: " + ", ".join(f"{x:.2f}" for x in r)
            + f" pairs/s over {STREAM_REQUESTS} requests (host clock, "
            f"depth 2) [{state['smi']}]")


def phase_serve_psmnet(state):
    from msnets_tpu_torch import Config, ModelConfig
    cfg = Config(model=ModelConfig(name="MS-PSMNet"))
    assert (cfg.model.max_disp, cfg.model.base_filters, cfg.model.compute_dtype,
            cfg.matching.num_channels) == (192, 32, "bfloat16", 8)
    requests = [textured_pair(256, 512, 24 + 8 * i, 60 + i) for i in range(3)]
    requests.append(textured_pair(375, 1242, 40, 63))
    server, sd, launches, il, ir = _serve(
        state, "serve_psmnet", cfg, requests, {"census_aml": 1, "census": 0},
        (10, 3))
    state["launches_by_path"]["serve_psmnet"] = launches
    _profile("serve_psmnet 256x512 forward", lambda: server.forward(il, ir))
    _precision("precision_psmnet", server, sd)


def _psmnet_train_cfg(**train):
    from msnets_tpu_torch import ModelConfig
    return dataclasses.replace(_train_cfg(**train),
                               model=ModelConfig(name="MS-PSMNet"))


def phase_train_psmnet(state):
    import torch
    from msnets_tpu_torch.engine import Trainer
    cfg = _psmnet_train_cfg()
    t, mdl = cfg.train, cfg.model
    assert (mdl.max_disp, mdl.base_filters, mdl.compute_dtype, t.crop_height,
            t.crop_width, t.batch_size, t.lr, t.grad_accum, t.remat) == \
        (192, 32, "bfloat16", 256, 512, 2, 1e-3, 1, False)
    tr = Trainer(cfg, seed=0)
    batch = _train_batch(cfg, 6)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses = []
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(TRAIN_STEPS)]
    _reset_counts()                                 # main path starts here
    for start, end in events:
        start.record()
        m, _ = _step(tr, batch)
        end.record()
        losses.append(float(m["loss"]))
    launches = _counts()                            # main path ends here
    torch.cuda.synchronize()
    ms = [s.elapsed_time(e) for s, e in events]
    peak = torch.cuda.max_memory_allocated() / 2**30
    log("train_psmnet: losses " + ", ".join(f"{x:.4f}" for x in losses))
    log("train_psmnet: ms/step " + ", ".join(f"{x:.1f}" for x in ms))
    log(f"train_psmnet 256x512 batch 2 bf16: {float(np.median(ms[2:])):.3f} "
        f"ms/step (median of steps 3-{TRAIN_STEPS}, CUDA events), peak "
        f"device memory {peak:.2f} GiB, kernel launches {launches} in "
        f"{TRAIN_STEPS} steps [{state['smi']}]")
    assert np.isfinite(losses).all(), losses
    assert losses[-1] < losses[0], losses
    assert launches == {"census_aml": 2 * TRAIN_STEPS, "census": 0}, launches
    state["launches_by_path"]["train_psmnet"] = launches
    _profile("train_psmnet step 256x512 batch 2", lambda: _step(tr, batch))
    del tr

    launches = _one_step(state, "train_psmnet CLI default grad_accum=2 batch 2",
                         _psmnet_train_cfg(grad_accum=2),
                         {"census_aml": 2, "census": 0})
    state["launches_by_path"]["train_psmnet"] = {
        k: v + launches[k]
        for k, v in state["launches_by_path"]["train_psmnet"].items()}

    # remat against the plain step, from one seed, on one batch
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        steps = {}
        for tag, kw in (("plain", {}),
                        ("remat all", {"remat": True, "remat_scope": "all"}),
                        ("remat hourglass", {"remat": True,
                                             "remat_scope": "hourglass"})):
            tr = Trainer(_psmnet_train_cfg(**kw), seed=1)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            m, _ = _step(tr, batch)
            end.record()
            torch.cuda.synchronize()
            stats = {k: v.float().cpu() for k, v in tr.model.state_dict().items()
                     if "running" in k}
            steps[tag] = (float(m["loss"]), stats)
            log(f"train_psmnet {tag}: one step, loss {steps[tag][0]:.6f}, "
                f"{start.elapsed_time(end):.1f} ms (first step of its "
                f"trainer), peak device memory "
                f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
                f"[{state['smi']}]")
            del tr
    finally:
        torch.backends.cudnn.deterministic = prev
    loss0, stats0 = steps["plain"]
    for tag in ("remat all", "remat hourglass"):
        loss, stats = steps[tag]
        worst = max((stats[k] - v).abs().max().item() for k, v in stats0.items())
        same = all(torch.equal(stats[k], v) for k, v in stats0.items())
        log(f"train_psmnet {tag} against plain: loss relative difference "
            f"{abs(loss - loss0) / abs(loss0):.3g}; running statistics "
            f"max |d| {worst:.3g} (bit for bit: {same})")
        assert abs(loss - loss0) <= 1e-3 * abs(loss0), (tag, loss, loss0)
        scale = max(v.abs().max().item() for v in stats0.values())
        assert worst <= 1e-3 * scale, (tag, worst)


CLI_ROOT = ROOT / "build" / "chip_smoke_cli"
CLI_FRAMES = 3


def _write_pgm(path: Path, img: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(b"P5\n%d %d\n255\n" % (img.shape[1], img.shape[0]))
        f.write(np.ascontiguousarray(img, np.uint8).tobytes())


def phase_cli(state):
    """The CLI's train, test and eval-badx modes through main(), as a user
    runs them, on a synthetic KITTI-2015 tree."""
    import torch
    from msnets_tpu_torch import StereoServer, cli, engine
    from msnets_tpu_torch.data import pfm as pfmio
    from msnets_tpu_torch.data import pipeline
    from msnets_tpu_torch.engine.checkpoint import ckpt_path
    shutil.rmtree(CLI_ROOT, ignore_errors=True)
    for d in ("image_0", "image_1", "disp_occ_0_pfm"):
        (CLI_ROOT / d).mkdir(parents=True)
    frames, entries = {}, []
    for i in range(CLI_FRAMES):
        shift = 20 + 8 * i
        left, right = textured_pair(375, 1242, shift, 70 + i)
        name = f"{i:06d}_10.pgm"
        for d, img in (("image_0", left), ("image_1", right)):
            _write_pgm(CLI_ROOT / d / name, img)
            frames[str(CLI_ROOT / d / name)] = img
        gt = np.full((375, 1242), float(shift), np.float32)
        gt[:, :shift] = np.inf                      # no match: masked
        pfmio.write_pfm(str(CLI_ROOT / "disp_occ_0_pfm" / f"{i:06d}_10.pfm"), gt)
        entries.append(name)
    (CLI_ROOT / "train.list").write_text("\n".join(entries[:2]) + "\n")
    (CLI_ROOT / "test.list").write_text("\n".join(entries) + "\n")
    ck_dir, res = CLI_ROOT / "checkpoints", CLI_ROOT / "results"
    data = ["--kitti2015=1", f"--data_path={CLI_ROOT}",
            f"--training_list={CLI_ROOT / 'train.list'}",
            f"--test_list={CLI_ROOT / 'test.list'}"]
    ckpt = ckpt_path(str(ck_dir), "MS-GCNet", 1)

    results = {}
    saved = (cli.args_to_config, cli.run_test, engine.eval_bad_x,
             pipeline.read_gray, pipeline.read_rgb)

    def args_to_config(a):                  # no cv2 here: no colour PNGs
        cfg = saved[0](a)
        return dataclasses.replace(cfg, eval=dataclasses.replace(
            cfg.eval, save_color=False))

    def run_test(cfg, **kw):
        results["test"] = saved[1](cfg, **kw)
        return results["test"]

    def eval_bad_x(cfg, **kw):
        results["eval-badx"] = saved[2](cfg, **kw)
        return results["eval-badx"]

    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    cli.args_to_config, cli.run_test, engine.eval_bad_x = (
        args_to_config, run_test, eval_bad_x)
    pipeline.read_gray = frames.__getitem__
    pipeline.read_rgb = lambda p: np.repeat(frames[p][:, :, None], 3, axis=2)
    try:
        t0 = time.perf_counter()
        _reset_counts()                             # main path starts here
        cli.main(["--mode=train", "--crop_height=128", "--crop_width=256",
                  "--batchSize=1", "--nEpochs=1", "--seed=7", "--threads=2",
                  f"--checkpoint_dir={ck_dir}", "--train_logdir="] + data)
        train_s = time.perf_counter() - t0
        train_launches = _counts()
        t0 = time.perf_counter()
        cli.main(["--mode=test", f"--resume={ckpt}", f"--resultDir={res}"] + data)
        test_s = time.perf_counter() - t0
        cli.main(["--mode=eval-badx", f"--resultDir={res}"] + data)
        launches = _counts()                        # main path ends here

        cfg = saved[0](cli.build_parser().parse_args(data + ["--seed=7"]))
        server = StereoServer.from_checkpoint(cfg, str(ckpt))
        same = []
        for name in entries:
            want = server.predict(frames[str(CLI_ROOT / "image_0" / name)],
                                  frames[str(CLI_ROOT / "image_1" / name)])
            got = pfmio.read_pfm(str(res / (name[:-4] + ".pfm")))
            same.append(bool(np.array_equal(got, want)))
            _check_disp(got, (375, 1242), cfg.model.max_disp)
    finally:
        torch.backends.cudnn.deterministic = prev
        (cli.args_to_config, cli.run_test, engine.eval_bad_x,
         pipeline.read_gray, pipeline.read_rgb) = saved
    test, badx = results["test"], results["eval-badx"]
    log(f"cli: train (2 steps, crop 128x256, MS-GCNet) {train_s:.2f} s "
        f"(launches {train_launches}); test {test['frames']} frames of "
        f"375x1242 {test_s:.2f} s: AVG EPE {test['avg_epe']:.6f}, bad-"
        f"{test['threshold']:.0f} {test['avg_bad']:.6f}; eval-badx AVG EPE "
        f"{badx['avg_epe']:.6f}, bad {badx['avg_bad']:.6f}; PFMs equal "
        f"predict's bit for bit: {same}; launches {launches} [{state['smi']}]")
    assert train_launches == {"census_aml": 2, "census": 0}, train_launches
    assert launches == {"census_aml": 2 + CLI_FRAMES, "census": 0}, launches
    assert test["frames"] == badx["frames"] == CLI_FRAMES
    assert test["threshold"] == 3.0
    assert abs(test["avg_epe"] - badx["avg_epe"]) <= 1e-9, (test, badx)
    assert abs(test["avg_bad"] - badx["avg_bad"]) <= 1e-9, (test, badx)
    assert all(same), same
    state["launches_by_path"]["cli"] = launches
    shutil.rmtree(CLI_ROOT, ignore_errors=True)


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
    state = {"launches_by_path": {}}
    phases = [phase_device, phase_build, phase_kernel, phase_features,
              phase_serve, phase_precision, phase_serve16, phase_serve_raw,
              phase_phases, phase_train, phase_checkpoint, phase_stream,
              phase_serve_psmnet, phase_train_psmnet, phase_cli]
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
        # each main path's launches, counted from 0 just before it
        by_path = {path: n[name]
                   for path, n in state["launches_by_path"].items()}
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": sum(by_path.values()),
            "launches_by_path": by_path,
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
