#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (msnets_tpu_torch) on one NVIDIA GPU and check it.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, each of which fails the run on error:
  1. device     the card's name, power limit and maximum SM clock
                (nvidia-smi);
  2. build      nvcc builds every kernel of msnets_tpu_torch/csrc/ (census,
                census_aml, matchers_aml, int8_conv3d, and int8_quantize.cu's
                int8_quantize and int8_absmax), the census kernels again with
                -DMSN_PHASES=1 for phase 9 and int8_quantize.cu with each
                -DMSN_QUANT_ABLATE for phase 20, all at once;
  3. kernel     census_aml against its plain PyTorch version (cost exact, AML
                atol 1e-6) and census against its plain version (exact), at
                the serving and training paths' shapes and at the tiling's
                edge shapes;
                then each kernel's profiler device time (the profiler must
                see the kernel), its plain version's time and its bound
                (bytes at HBM rate; popc and exp at 16/clock/SM, the rest
                at the float32 rate); then matchers_aml against its plain
                version at the serving shape (212x644, D 96, 10-px margins)
                and the training shape (140x352, D 96, margins 6/96/0), in
                float32 (channels 0-4 exact, 5-7 atol 1e-6) and bfloat16
                (one unit in the last place), and its profiler time, plain
                time and bound at both; subpixel_soft_argmin (the served
                MS-GCNet head) against its plain version in float64 at the
                online cell's decoder output (1x32x96x192x624, stride 2)
                and its quarter_input counterpart (stride 4), max |dd| 1e-3
                px, then its time, the plain version's, the chain it
                replaces (library_ms) and its bound at the online shape;
  4. features   a known-disparity pair through ms_features on the card, 8 and
                16 channels: the census-AML channels (left 4, right 12) must
                peak at the true disparity; matchers_aml launches once on 8
                channels and never on 16;
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
                bfloat16 against float32 (TF32 off); then quarter_input
                (the x4 head) for MS-GCNet and MS-PSMNet at F=32, max_disp
                192 on a 1x8x48x32x64 volume: the card's float32 output
                against the CPU's (2e-3 px), and one train-mode step (loss
                on every head, backward, Adam) with everything finite;
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
 15. cli        first the port's PNG decoder on the committed 375x1242 RGB
                frames cv2.imwrite wrote (tests/data/torch_port/png/): the
                pixels' digests equal cv2.imread's, and the decode's ms;
                then python -m msnets_tpu_torch.cli's main() on synthetic
                KITTI-2015 trees of 3 frames at 375x1242 written as PNG
                files by the port's encoder (ground truth as PFM), one of
                grey frames and one of colour frames, read from disk as a
                user's run reads them (the card's machine has no OpenCV):
                --mode train (MS-GCNet, 2 steps at a 128x256 crop) on the
                grey tree (kept, with its checkpoint, for phase 20),
                --mode test of its checkpoint on both trees with
                the colour PNGs on, --mode eval-badx; census_aml once a
                step and once a frame; the PFMs equal StereoServer.predict's
                of the frames cv2.imread(p, 0) would give bit for bit
                (cuDNN's deterministic algorithms), the dispColor PNGs
                decode to the KT15 colours of the PFMs, and eval-badx gives
                the test's averages;
 16. train_dp   data-parallel training (parallel/mesh.py): (a) an NCCL
                group of one rank, Config() (global batch 2): under cuDNN's
                deterministic algorithms step 1 with the group equals the
                plain Trainer's step 1 bit for bit (loss, every parameter and
                BN statistic, Adam's moments), then 8 steps (losses finite
                and falling, the collectives a step (2: the group's
                data-only mesh of one rank splits nothing), census_aml twice a
                step), then 24 steps of each trainer in turns: ms/step with
                and without the group; (b) two ranks
                sharing the card over gloo (child processes of this script,
                CUDA tensors), one sample each of a global batch of 2, 2
                steps in float32 with TF32 off: the ranks agree bit for bit,
                and with a one-process step on the whole batch (metrics 1e-4
                relative, BN statistics rtol 1e-3 / atol 1e-4, the step-1
                gradient 1e-4 relative L2 or, above it, within the move of
                the one-process gradient under features x (1 + 1e-6
                noise)), census_aml once a step a rank;
                (c) the JAX package's checkpoint committed under
                tests/data/torch_port/: StereoServer.from_checkpoint serves
                its pair as the JAX server did (float32, atol 2e-3), and
                Trainer.resume takes one step from its Adam moments;
 17. serve_mesh the eval forward over a (1, S, P) mesh (parallel/mesh.py,
                parallel/halo.py): (a) Config() (bfloat16) over an NCCL
                group of one rank under make_mesh((1, 1, 1)): 3 requests at
                256x512 bit for bit the plain server's with the head a
                mesh runs (the conv and soft_argmin; cuDNN deterministic),
                the fused head's distance from it, the collectives a
                request, census_aml once a request;
                (b) ranks of this script sharing the card over gloo (CUDA
                tensors), 2 at (1, 2, 1) then (1, 1, 2), then 4 at (1, 2, 2):
                MS-GCNet and MS-PSMNet (max_disp 192, F=32, float32, TF32
                off, cuDNN deterministic) at 256x512 and 375x1242, and one
                16-channel MS-GCNet request at (1, 1, 2); each rank's
                disparities bit for bit the others' and within 1e-3 px of
                the one-process server of the same weights, and one int8
                MS-GCNet request (quant_eval, dynamic, scope "all") at
                256x512 at (1, 2, 2), int8_quantize and int8_conv3d twice
                on each rank;
                census_aml once a request on each rank (census once a
                16-channel request);
                the memory one 375x1242 forward adds on each rank beside one
                process's, and ms a request (the ranks share one card: no
                multi-card speed);
 18. train_mesh training over a (data, spatial, disp) mesh (Trainer(mesh=),
                the halo backward, train BN over the mesh, the split
                soft-argmin's gradient): (a) Config() (bfloat16) over an
                NCCL group of one rank under make_mesh((1, 1, 1)): under
                cuDNN's deterministic algorithms step 1 equals the plain
                Trainer's bit for bit (loss, every parameter and BN
                statistic, Adam's moments), the collectives a step,
                census_aml twice a step; (b) ranks of this script sharing
                the card over gloo (CUDA tensors), 2 at (1, 2, 1) then
                (1, 1, 2), 4 at (1, 2, 2) then (2, 2, 1), 8 at (2, 2, 2):
                Config() widths (F=32, max_disp 192, batch 2, crop 256x512)
                in float32 with TF32 off and cuDNN deterministic, MS-GCNet 2
                steps at every mesh, with remat at (1, 2, 2), MS-PSMNet with
                grad_accum 2 at (1, 2, 2), one 16-channel step at (1, 1, 2):
                every rank's metrics, parameters, BN statistics and Adam
                state bit for bit the others'; against one process on the
                whole batch the loss and EPE within 1e-4 relative, the
                disparity within 2e-2 px, accu3 within the share of pixels
                whose error lies that close to 3 px, BN statistics rtol
                1e-3 / atol 1e-4, the step-1 gradient 1e-4 relative L2 or,
                above it, within the one-process gradient's move under
                features x (1 + 1e-6 noise); census_aml once a sample of
                the rank's data share a step (census once a 16-channel
                sample); each rank's memory and ms for a step beside one
                process's (the ranks share one card: no multi-card speed);
 19. xdom       the paper's cross-domain experiment
                (msnets_tpu_torch/experiments/cross_domain.py) small at the
                recipe's widths: 4 family-A scenes x 1 epoch (crop 256x512,
                max_disp 192, batch 2), the ms and raw arms, seed 3, each
                scored on 2 family-A scenes and 2 family-B KITTI frames at
                375x1242: every score finite, the colour PNGs written,
                census_aml 8 times (the ms arm's 4 samples and 4 frames);
 20. serve_quant int8 eval (models/quant.py): (a) the int8 conv's SASS
                (cuobjdump): int8 tensor-core instructions, no IDP; the
                int8_conv3d kernel, raw (int32) and fused (its
                dequantization in bf16 and float32, per-sample and scalar
                scales), and the int8_quantize and int8_absmax kernels
                against their plain versions (on the host), bit for bit,
                at edge shapes
                (stride 1 and 2, per-dim padding, cin 4, 5, 8, 32, 64 and
                128, cout 8 to 64, odd D, H and W, N = 2, H = 1, a ragged
                third ow tile) and at the production convs' full H x W and
                widths with D cut to 4; then every shape the servers give
                them at full size (conv3dbn_2 and block_3d_1's entry at
                256x512 and at 375x1242, block_3d_2's entry at 375x1242;
                MS-PSMNet's convs share these shapes): bit for bit against
                the plain versions on the card, the profiler's times (fused
                and raw; median of three sessions; int8_quantize,
                int8_absmax and the aminmax pass, its library call, in one
                session), the bounds, the plain versions' times, a bf16
                F.conv3d yardstick and int8_quantize's ablations (loads
                only, no stores, the true division for every value), also
                on the input after a ReLU (half zeros, as the int8 convs
                get it); (b) StereoServer at Config() widths
                (F=32, max_disp 192, bf16), seeded random weights, MS-GCNet
                scope "all" dynamic, scope "stem" dynamic, "all" static
                (calibrated by a "calib" server on one frame of each
                bucket) and MS-PSMNet dynamic: 3 requests at 256x512 and
                one at 375x1242, int8_conv3d and int8_quantize 2/3, 1/1,
                2/3 and 6/9 times a request (int8_absmax as often, but
                never in the static server) and census_aml once; the mean
                and p99 |d disparity| against the float32 server (TF32 off)
                under phase 6's 1 px; ms/pair beside the bf16 server's;
                then one MS-PSMNet packed_eval_outer=False request at
                375x1242 (its int8 count from models.quant_convs) against
                the packed_eval_outer=True server under 1 px;
                (c) the CLI's --mode test --quant_eval 1 --quant_mode
                static on phase 15's grey tree: finite scores, one
                calibration forward (int8_absmax once a flagged conv: 5),
                int8_conv3d and int8_quantize 3 times a frame.
Wherever a phase counts census_aml, matchers_aml must launch as often: the
two launch together, once an 8-channel sample, and never on the 16-channel
and raw paths.
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


def queued_ms(fn, n: int) -> float:
    """Mean device ms per call of ``fn`` over ``n`` calls from CUDA events,
    the calls queued behind a sleep kernel (about 10 ms) so that the
    host's launch time stays out of the reading."""
    import torch
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    torch.cuda._sleep(20_000_000)
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
    """Every kernel of csrc/, the census kernels again with -DMSN_PHASES=1
    for the "phases" phase, and int8_quantize's ablations for phase 20:
    one nvcc per library, all started together."""
    from concurrent.futures import ThreadPoolExecutor
    from msnets_tpu_torch.ops.cuda import _build
    t0 = time.perf_counter()
    builds = ((None, ()), (("census", "census_aml"), PHASE_DEFINES)) + tuple(
        (("int8_quantize",), d) for d in QUANT_ABLATIONS.values())
    with ThreadPoolExecutor(len(builds)) as pool:
        jobs = [pool.submit(_build.build, n, d) for n, d in builds]
        built = [(name + "".join(f" -D{x}" for x in d), info)
                 for (_, d), job in zip(builds, jobs)
                 for name, info in job.result().items()]
    log(f"build: {len(built)} kernel libraries in "
        f"{time.perf_counter() - t0:.2f} s")
    for name, info in built:
        log(f"  {name}: {info['seconds']:.2f} s -> {info['path']}")
        for line in info["log"].splitlines():
            entry = re.search(r"Compiling entry function '([^']+)'", line)
            if entry:
                log(f"    {entry[1]}:")
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
    _head_kernel(state)
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
    _matchers_kernel(state, rng)


# matchers_aml's shapes: the 384x1248 serving bucket (a 212x644 padded
# half-resolution pair, 10-px margins) and the train crop (280x704 at half
# resolution, margins board_h 6, board_w_left 96)
MATCHERS_SHAPES = [("serve 212x644 D96", 212, 644, 96, (10, 10, 10)),
                   ("train 140x352 D96", 140, 352, 96, (6, 96, 0))]


def _matchers_kernel(state, rng):
    """matchers_aml against its plain version on the card at
    MATCHERS_SHAPES (float32 and bfloat16 out), then its device time
    (``_profiled_ms``), the plain version's time and the bound, in bfloat16
    as the model reads the volume."""
    import torch
    from msnets_tpu_torch.ops.cuda import matchers_aml as MA
    from msnets_tpu_torch.ops.cuda.census_aml import census_aml
    worst, timed = 0.0, {}
    for name, H, W, D, m in MATCHERS_SHAPES:
        a, b = (torch.from_numpy(rng.integers(0, 256, (H, W), dtype=np.uint8)).cuda()
                for _ in range(2))
        cen = census_aml(a, b, D)
        kw = dict(board_h=m[0], board_w_left=m[1], board_w_right=m[2])
        for dtype in (torch.float32, torch.bfloat16):
            got = MA.matchers_aml(a, b, *cen, D, out_dtype=dtype, **kw)
            ref = MA.matchers_aml_reference(a, b, *cen, D, out_dtype=dtype, **kw)
            torch.cuda.synchronize()
            assert got.shape == ref.shape == (8, D, H - 2 * m[0], W - m[1] - m[2])
            assert torch.equal(got[:5], ref[:5]), f"{name}: a cost channel differs"
            if dtype == torch.float32:
                err = (got[5:] - ref[5:]).abs().max().item()
                worst = max(worst, err)
                assert err <= AML_ATOL, f"{name}: AML off by {err}"
            else:
                err = (got[5:].view(torch.int16).int()
                       - ref[5:].view(torch.int16).int()).abs().max().item()
                assert err <= 1, f"{name}: bf16 AML off by {err} ulp"
            log(f"kernel matchers_aml {name} {dtype}: channels 0-4 exact, "
                f"AML max|d| {'%.3g' % err if dtype == torch.float32 else '%d ulp' % err}")
        run = lambda: MA.matchers_aml(a, b, *cen, D, out_dtype=torch.bfloat16, **kw)  # noqa: E731
        plain = lambda: MA.matchers_aml_reference(  # noqa: E731
            a, b, *cen, D, out_dtype=torch.bfloat16, **kw)
        for _ in range(3):
            run()
            plain()
        t = {"ms_events": cuda_time_ms(run, 50), "plain_ms": cuda_time_ms(plain, 5)}
        t["ms"], t["timed_by"] = _profiled_ms({"k": run}, {"k": "matchers_aml_tile"})["k"]
        ho, wo = H - 2 * m[0], W - m[1] - m[2]
        # two images and the trimmed census planes read, the bf16 volume
        # written; 140 operations a valid 5x5 entry (ZSAD 75, SAD-of-Sobel
        # 50, NCC 13, the validity selects 2) and 24 an output (d, pixel):
        # three AMLs and normalizations
        t["bytes"] = 2 * H * W + 2 * D * ho * wo * 4 + 8 * D * ho * wo * 2
        t["alu_ops"] = 140 * _valid_entries(H, W, D, 5, m)[1] + 24 * D * ho * wo
        t["bytes_ms"] = t["bytes"] / HBM_BYTES_PER_S * 1e3
        t["ops_ms"] = t["alu_ops"] / F32_OPS_PER_S * 1e3
        t["bound_ms"] = max(t["bytes_ms"], t["ops_ms"])
        t["bound_by"] = "bytes" if t["bytes_ms"] >= t["ops_ms"] else "operations"
        log(f"matchers_aml {name}: device {t['ms']:.4f} ms/call ({t['timed_by']}), events "
            f"{t['ms_events']:.4f} ms/call (host launch included); plain "
            f"{t['plain_ms']:.3f} ms; bound {t['bound_ms']:.4f} ms by "
            f"{t['bound_by']}: bytes {t['bytes_ms']:.4f} ms "
            f"({t['bytes'] / 1e6:.1f} MB), operations {t['ops_ms']:.4f} ms "
            f"({t['alu_ops'] / 1e9:.2f} G at the float32 rate); "
            f"{t['ms'] / t['bound_ms']:.2f}x the bound [{state['smi']}]")
        timed[name] = t
    state["max_abs_err"]["matchers_aml"] = worst
    state["matchers_aml"] = timed[MATCHERS_SHAPES[0][0]]


# the serving head's shapes: the online cell's decoder output (384x1248,
# D 192 from 96), and its quarter_input counterpart (stride 4)
HEAD_SHAPES = [("online 384x1248 s2", (1, 32, 96, 192, 624), 2),
               ("quarter 384x1248 s4", (1, 32, 24, 48, 156), 4)]


def _head_kernel(state):
    """subpixel_soft_argmin against its plain version in float64 at
    HEAD_SHAPES (max |dd| <= 1e-3 px), then at the online shape its device
    time, the plain version's (float32), the chain it replaces as
    ``library_ms`` (the float32 copy, cuDNN's padded transposed conv and
    ``soft_argmin``: the served head before it) and its bound: bytes (the
    bf16 input read once, the disparity written) at HBM rate against 27
    taps x C channels FMAs a voxel at the float32 rate."""
    import torch
    from msnets_tpu_torch.models.layers import conv_head
    from msnets_tpu_torch.ops.cuda import subpixel_soft_argmin as SA
    worst, g = 0.0, torch.Generator().manual_seed(0)
    for name, shape, s in HEAD_SHAPES:
        x = torch.randn(shape, generator=g).relu().to(
            "cuda", torch.bfloat16, memory_format=torch.channels_last_3d)
        k = (torch.randn((shape[1], 1, 3, 3, 3), generator=g)
             * (2 / 27) ** 0.5).cuda()
        got = SA.subpixel_soft_argmin(x, k, s, s * shape[2])
        err = (got.double() - SA.subpixel_soft_argmin_reference(
            x.double(), k.double(), s)).abs().max().item()
        torch.cuda.synchronize()
        worst = max(worst, err)
        log(f"kernel subpixel_soft_argmin {name}: max|d| {err:.3g} px "
            f"against float64")
        assert err <= 1e-3, f"{name}: disparity off by {err} px"
        if s != 2:
            continue
        run = lambda: SA.subpixel_soft_argmin(x, k, s, s * shape[2])  # noqa: E731
        plain = lambda: SA.subpixel_soft_argmin_reference(x, k, s)   # noqa: E731
        library = lambda: conv_head(x, k, s, s * shape[2])          # noqa: E731
        for _ in range(3):
            run()
            library()
        plain()
        t = {"ms_events": cuda_time_ms(run, 20),
             "plain_ms": cuda_time_ms(plain, 2),
             "library_ms": cuda_time_ms(library, 10)}
        t["ms"], t["timed_by"] = _profiled_ms(
            {"k": run}, {"k": "subpixel_soft_argmin_kernel"})["k"]
        n, c, d, h, w = shape
        t["bytes"] = x.numel() * x.element_size() + got.numel() * 4
        t["alu_ops"] = 2 * 27 * c * n * d * h * w
        t["bytes_ms"] = t["bytes"] / HBM_BYTES_PER_S * 1e3
        t["ops_ms"] = t["alu_ops"] / F32_OPS_PER_S * 1e3
        t["bound_ms"] = max(t["bytes_ms"], t["ops_ms"])
        t["bound_by"] = "bytes" if t["bytes_ms"] >= t["ops_ms"] else "operations"
        log(f"subpixel_soft_argmin {name}: device {t['ms']:.4f} ms/call "
            f"({t['timed_by']}), events {t['ms_events']:.4f} ms/call; plain "
            f"{t['plain_ms']:.3f} ms; library (f32 copy, cuDNN deconv, "
            f"soft_argmin) {t['library_ms']:.3f} ms; bound "
            f"{t['bound_ms']:.4f} ms by {t['bound_by']}: bytes "
            f"{t['bytes_ms']:.4f} ms ({t['bytes'] / 1e6:.1f} MB), operations "
            f"{t['ops_ms']:.4f} ms ({t['alu_ops'] / 1e9:.2f} GFLOP at the "
            f"float32 rate); {t['ms'] / t['bound_ms']:.2f}x the bound "
            f"[{state['smi']}]")
        state["subpixel_soft_argmin"] = t
    state["max_abs_err"]["subpixel_soft_argmin"] = worst


PHASE_DEFINES = ("MSN_PHASES=1",)
# int8_quantize built with one stage of its work taken out
# (csrc/int8_quantize.cu's MSN_QUANT_ABLATE), timed beside the kernel
QUANT_ABLATIONS = {"loads only": ("MSN_QUANT_ABLATE=1",),
                   "no stores": ("MSN_QUANT_ABLATE=2",),
                   "true division": ("MSN_QUANT_ABLATE=3",)}
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


def _valid_entries(H: int, W: int, D: int, wsize: int = 11,
                   margins=(0, 0, 0)):
    """(valid pixels, valid (d, pixel) entries) of the reference mask: rows
    and cols [wc, n - wsize + wc), d <= c - wc; inside the volume that the
    margins (board_h, board_w_left, board_w_right) leave."""
    bh, bwl, bwr = margins
    wc = wsize // 2
    rows = max(0, min(H - bh, H - wsize + wc) - max(bh, wc))
    cols = range(max(bwl, wc), min(W - bwr, W - wsize + wc))
    return rows * len(cols), rows * sum(min(D, c - wc + 1) for c in cols)


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
    _reset_counts()
    f = ms_features(L, R, 16, MatchingConfig(), 5, 20, 0, True)
    assert _counts() == _want(census_aml=1), _counts()
    acc = (f[4].argmax(0)[8:-8, 8:-8] == 7).float().mean().item()
    log(f"features: shape {tuple(f.shape)}, census-AML argmax accuracy "
        f"{acc:.4f} at true disparity 7")
    assert tuple(f.shape) == (8, 16, 38, 76) and bool(torch.isfinite(f).all())
    assert acc > 0.99, acc
    _reset_counts()
    f = ms_features(L, R, 16, MatchingConfig(num_channels=16), 5, 20, 0, False)
    assert _counts() == _want(census=1), _counts()
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


def _counted():
    """The kernel wrappers whose launches the main paths count."""
    from msnets_tpu_torch.ops.cuda.census import census
    from msnets_tpu_torch.ops.cuda.census_aml import census_aml
    from msnets_tpu_torch.ops.cuda.int8_conv3d import int8_conv3d
    from msnets_tpu_torch.ops.cuda.int8_quantize import (int8_absmax,
                                                         int8_quantize)
    from msnets_tpu_torch.ops.cuda.matchers_aml import matchers_aml
    from msnets_tpu_torch.ops.cuda.subpixel_soft_argmin import (
        subpixel_soft_argmin)
    return {"census_aml": census_aml, "census": census,
            "matchers_aml": matchers_aml, "int8_conv3d": int8_conv3d,
            "int8_quantize": int8_quantize, "int8_absmax": int8_absmax,
            "subpixel_soft_argmin": subpixel_soft_argmin}


def _counts():
    return {k: f.launches for k, f in _counted().items()}


def _want(census_aml=0, census=0, int8_conv3d=0, int8_absmax=0, head=0):
    """The kernels' launch counts a path must show: each int8 conv
    quantizes its input once (int8_quantize, then the fused int8_conv3d);
    int8_absmax runs once an int8 conv in dynamic mode, never in static
    mode, and once a flagged conv in a calibration forward; matchers_aml
    launches with census_aml, once an 8-channel sample; the served
    MS-GCNet's head (subpixel_soft_argmin) once a forward of a server (the
    Evaluator's too), never in training, over a mesh or in MS-PSMNet."""
    return {"census_aml": census_aml, "census": census,
            "matchers_aml": census_aml, "int8_conv3d": int8_conv3d,
            "int8_quantize": int8_conv3d, "int8_absmax": int8_absmax,
            "subpixel_soft_argmin": head}


def _reset_counts():
    for f in _counted().values():
        f.launches = 0


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
        state, "serve", cfg, requests, _want(census_aml=1, head=1),
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
        state, "serve16", cfg, requests, _want(census=1, head=1),
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
                                  _want(head=1), (10, 3))
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
    assert launches == _want(census_aml=2 * TRAIN_STEPS), launches
    _profile("train step 256x512 batch 2", lambda: _step(tr, batch))
    state.update(trainer=tr, train_batch=batch)
    state["launches_by_path"]["train"] = launches

    from msnets_tpu_torch import MatchingConfig, ModelConfig
    cfg16 = dataclasses.replace(
        _train_cfg(batch_size=1), matching=MatchingConfig(num_channels=16),
        model=ModelConfig(in_channels=16))
    state["launches_by_path"]["train16"] = _one_step(
        state, "train16 batch 1", cfg16, _want(census=1))
    state["launches_by_path"]["train_accum2"] = _one_step(
        state, "train grad_accum=2 batch 2", _train_cfg(grad_accum=2),
        _want(census_aml=2))


def _state_equal(sa, sb) -> bool:
    """Bitwise equality of two Trainers' states (``Trainer.state()`` or a
    ``_snapshot``): every model tensor (BN statistics and
    num_batches_tracked too), the Adam moments and steps, and the step
    count."""
    import torch
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
        assert _state_equal(saved.state(), fresh.state()), \
            "resumed state is not the saved one"
        assert int(fresh.model.conv3dbn_1[1].num_batches_tracked) == n
        log(f"checkpoint: resumed state equals the saved one bit for bit "
            f"(step {fresh.step}, {len(fresh.optimizer.state)} Adam states)")
        m_res, _ = _step(fresh, batch)
        loss_res = float(m_res["loss"])
        same = _state_equal(tr.state(), fresh.state())
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
    assert launches == _want(census_aml=STREAM_REQUESTS,
                             head=STREAM_REQUESTS), launches
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
        state, "serve_psmnet", cfg, requests, _want(census_aml=1),
        (10, 3))
    state["launches_by_path"]["serve_psmnet"] = launches
    _profile("serve_psmnet 256x512 forward", lambda: server.forward(il, ir))
    _precision("precision_psmnet", server, sd)
    _quarter_input(state)


QUARTER_VOLUME = (1, 8, 48, 32, 64)     # quarter-res volume: D 192, 128x256
QUARTER_ATOL = 2e-3                     # px, the port's parity bound


def _quarter_input(state):
    """quarter_input (the x4 head) for MS-GCNet and MS-PSMNet at Config()
    widths (F=32, max_disp 192): the card's float32 eval output (TF32 off)
    against the port's CPU output on one seeded volume, then one train-mode
    step on the card (bfloat16 forward, smooth-L1 loss on every head,
    backward, Adam) whose loss, gradients and weights are finite."""
    import torch
    import torch.nn.functional as F
    from msnets_tpu_torch import Config, ModelConfig
    from msnets_tpu_torch.models import build_model
    from msnets_tpu_torch.runtime import fp32_reference, resolve_device
    dev = resolve_device(None)
    cv = torch.rand(QUARTER_VOLUME, generator=torch.Generator().manual_seed(90))
    out_hw = (4 * QUARTER_VOLUME[3], 4 * QUARTER_VOLUME[4])
    for name in ("MS-GCNet", "MS-PSMNet"):
        mc = ModelConfig(name=name, quarter_input=True)
        assert (mc.max_disp, mc.base_filters) == (192, 32)
        f32 = dataclasses.replace(mc, compute_dtype="float32")
        sd = _random_state_dict(Config(model=f32), 91)
        t0 = time.perf_counter()
        with fp32_reference(), torch.no_grad():
            cpu = build_model(f32, "cpu")
            cpu.load_state_dict(sd)
            want = cpu(cv)
            gpu = build_model(f32)
            gpu.load_state_dict(sd)
            got = gpu(cv.to(dev)).cpu()
        _check_disp(got.numpy()[0], out_hw, mc.max_disp)
        err = float((got - want).abs().max())
        model = build_model(mc).train()
        opt = torch.optim.Adam(model.parameters(), 1e-3)
        target = torch.full((1,) + out_hw, 40.0, device=dev)
        out = model(cv.to(dev))
        outs = out if isinstance(out, tuple) else (out,)
        loss = sum(F.smooth_l1_loss(o, target) for o in outs)
        loss.backward()
        finite = bool(torch.isfinite(loss)) and all(
            torch.isfinite(p.grad).all() for p in model.parameters()
            if p.grad is not None)
        opt.step()
        finite = finite and all(torch.isfinite(p).all()
                                for p in model.parameters())
        log(f"quarter_input {name}: {tuple(cv.shape)} -> {tuple(got.shape)}, "
            f"card float32 against the CPU max |d| {err:.3e} px (bound "
            f"{QUARTER_ATOL}); train-mode step ({len(outs)} head(s)) loss "
            f"{loss.item():.4f}, finite {finite}; "
            f"{time.perf_counter() - t0:.1f} s [{state['smi']}]")
        assert err <= QUARTER_ATOL, err
        assert finite


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
    assert launches == _want(census_aml=2 * TRAIN_STEPS), launches
    state["launches_by_path"]["train_psmnet"] = launches
    _profile("train_psmnet step 256x512 batch 2", lambda: _step(tr, batch))
    del tr

    launches = _one_step(state, "train_psmnet CLI default grad_accum=2 batch 2",
                         _psmnet_train_cfg(grad_accum=2),
                         _want(census_aml=2))
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
PNG_FIXTURES = ROOT / "tests" / "data" / "torch_port" / "png"


def _decode_fixtures(state):
    """The committed 375x1242 RGB frames that cv2.imwrite wrote (its default
    Sub rows, and libpng's adaptive filters), decoded by the port's codec:
    the pixels' SHA-256 against cv2.imread's (tests/data/torch_port/png/
    png.json), and the decode's ms (median of 5, host clock)."""
    import hashlib
    from msnets_tpu_torch.data import png
    digests = json.loads((PNG_FIXTURES / "png.json").read_text())
    out = {}
    for name, want in digests.items():
        data = (PNG_FIXTURES / name).read_bytes()
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            dec = png.decode(data, name)
            times.append((time.perf_counter() - t0) * 1e3)
        got = {"gray": png.gray(dec, name), "rgb": png.rgb(dec)}
        for k, img in got.items():
            assert hashlib.sha256(img.tobytes()).hexdigest() == want[k], (name, k)
        out[name] = sorted(times)[2]
    log("png decode of a 375x1242 RGB frame cv2.imwrite wrote, median of 5 "
        "(host clock; pixels equal cv2.imread's): "
        + ", ".join(f"{n} {ms:.3f} ms" for n, ms in out.items())
        + f" [{state['smi']}]")
    state["png_decode_ms"] = out


def _cli(argv):
    """cli.main(argv) as a user runs it; its standard output."""
    import contextlib
    import io
    from msnets_tpu_torch import cli
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(argv)
    return buf.getvalue()


def phase_cli(state):
    """The CLI's train, test and eval-badx modes through main(), as a user
    runs them, on synthetic KITTI-2015 trees of PNG files read from disk:
    grey frames, then colour frames (read as grey the way cv2.imread(p, 0)
    reads them), with colour PNGs written."""
    import torch
    from msnets_tpu_torch import StereoServer, cli
    from msnets_tpu_torch.data import pfm as pfmio
    from msnets_tpu_torch.data import pipeline, png
    from msnets_tpu_torch.engine.checkpoint import ckpt_path
    from msnets_tpu_torch.experiments.cross_domain import _scores
    from msnets_tpu_torch.utils.colormap import kt15_false_color
    _decode_fixtures(state)
    shutil.rmtree(CLI_ROOT, ignore_errors=True)
    trees = {"grey": CLI_ROOT / "grey", "colour": CLI_ROOT / "colour"}
    frames, entries = {}, []
    for i in range(CLI_FRAMES):
        shift = 20 + 8 * i
        name = f"{i:06d}_10.png"
        entries.append(name)
        rgb = np.random.default_rng(80 + i).integers(
            0, 256, (375, 1242 + shift, 3), dtype=np.uint8)
        # the grey tree's frames; the colour tree's, and the grey frames
        # cv2.imread(p, 0) makes of them (libpng's rgb_to_gray)
        views = {"grey": textured_pair(375, 1242, shift, 70 + i),
                 "colour": (rgb[:, shift:], rgb[:, :1242])}
        for tree, root in trees.items():
            for d, img in zip(("image_0", "image_1"), views[tree]):
                (root / d).mkdir(parents=True, exist_ok=True)
                png.write_png(str(root / d / name), np.ascontiguousarray(img))
                if img.ndim == 3:
                    img = ((img.astype(np.uint32) @ np.array(
                        png.GRAY_WEIGHTS, np.uint32)) >> 15).astype(np.uint8)
                frames[str(root / d / name)] = img
            gt = np.full((375, 1242), float(shift), np.float32)
            gt[:, :shift] = np.inf                  # no match: masked
            (root / "disp_occ_0_pfm").mkdir(exist_ok=True)
            pfmio.write_pfm(str(root / "disp_occ_0_pfm" / f"{i:06d}_10.pfm"), gt)
    for path, img in frames.items():                # the codec on the card's host
        assert np.array_equal(pipeline.read_gray(path), img), path
    (CLI_ROOT / "train.list").write_text("\n".join(entries[:2]) + "\n")
    (CLI_ROOT / "test.list").write_text("\n".join(entries) + "\n")
    ck_dir = CLI_ROOT / "checkpoints"

    def data(tree):
        return ["--kitti2015=1", f"--data_path={trees[tree]}",
                f"--training_list={CLI_ROOT / 'train.list'}",
                f"--test_list={CLI_ROOT / 'test.list'}"]
    ckpt = ckpt_path(str(ck_dir), "MS-GCNet", 1)

    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    scores, secs = {}, {}
    try:
        t0 = time.perf_counter()
        _reset_counts()                             # main path starts here
        _cli(["--mode=train", "--crop_height=128", "--crop_width=256",
              "--batchSize=1", "--nEpochs=1", "--seed=7", "--threads=2",
              f"--checkpoint_dir={ck_dir}", "--train_logdir="] + data("grey"))
        secs["train"] = time.perf_counter() - t0
        train_launches = _counts()
        for tree in trees:
            res = CLI_ROOT / f"results_{tree}"
            t0 = time.perf_counter()
            scores[tree] = _scores(_cli(["--mode=test", f"--resume={ckpt}",
                                         f"--resultDir={res}"] + data(tree)))
            secs[tree] = time.perf_counter() - t0
        badx = _scores(_cli(["--mode=eval-badx",
                             f"--resultDir={CLI_ROOT / 'results_grey'}"]
                            + data("grey")))
        launches = _counts()                        # main path ends here

        cfg = cli.args_to_config(cli.build_parser().parse_args(
            data("grey") + ["--seed=7"]))
        server = StereoServer.from_checkpoint(cfg, str(ckpt))
        same = {}
        for tree, root in trees.items():
            res = CLI_ROOT / f"results_{tree}"
            for name in entries:
                want = server.predict(frames[str(root / "image_0" / name)],
                                      frames[str(root / "image_1" / name)])
                got = pfmio.read_pfm(str(res / (name[:-4] + ".pfm")))
                same[f"{tree} {name}"] = bool(np.array_equal(got, want))
                _check_disp(got, (375, 1242), cfg.model.max_disp)
                colour = png.rgb(png.decode(
                    (res / "dispColor" / name).read_bytes()))
                assert np.array_equal(
                    colour, kt15_false_color(got).astype(np.uint8)), name
                assert (res / "errDispColor" / name).is_file(), name
    finally:
        torch.backends.cudnn.deterministic = prev
    log(f"cli: train (2 steps, crop 128x256, MS-GCNet) {secs['train']:.2f} s "
        f"(launches {train_launches}); test {CLI_FRAMES} frames of 375x1242 "
        f"read from PNG files, colour PNGs written: grey {secs['grey']:.2f} s "
        f"AVG EPE {scores['grey'][0]}, bad-3 {scores['grey'][1]}; colour "
        f"{secs['colour']:.2f} s AVG EPE {scores['colour'][0]}, bad-3 "
        f"{scores['colour'][1]}; eval-badx {badx}; PFMs equal predict's bit "
        f"for bit: {same}; launches {launches} [{state['smi']}]")
    assert train_launches == _want(census_aml=2), train_launches
    assert launches == _want(census_aml=2 + 2 * CLI_FRAMES,
                             head=2 * CLI_FRAMES), launches
    assert all(np.isfinite(v) for sc in scores.values() for v in sc), scores
    assert badx == scores["grey"], (badx, scores)
    assert all(same.values()), same
    state["launches_by_path"]["cli"] = launches
    # the grey tree and its checkpoint stay for phase 20's int8 test mode,
    # which removes them
    state["cli"] = {"data": data("grey"), "ckpt": str(ckpt),
                    "scores": scores["grey"]}


XDOM_ROOT = ROOT / "build" / "chip_smoke_xdom"


def phase_xdom(state):
    """The cross-domain experiment (experiments/cross_domain.py) small, at
    the recipe's widths: 4 family-A scenes at 320x768 x 1 epoch (crop
    256x512, max_disp 192, batch 2), both arms, seed 3, evaluated on 2
    family-A scenes and 2 family-B KITTI frames at 375x1242."""
    import contextlib
    import io
    from msnets_tpu_torch.data import png
    from msnets_tpu_torch.experiments import cross_domain as X
    shutil.rmtree(XDOM_ROOT, ignore_errors=True)
    buf = io.StringIO()
    t0 = time.perf_counter()
    _reset_counts()                                 # main path starts here
    with contextlib.redirect_stdout(buf):
        res = X.run(4, 1, str(XDOM_ROOT), "MS-GCNet", (3,), ("ms", "raw"),
                    n_eval=2)
    launches = _counts()                            # main path ends here
    secs = time.perf_counter() - t0
    rows = {m: res[m]["seeds"][0] for m in ("ms", "raw")}
    log(f"xdom: 4 scenes x 1 epoch, ms and raw, seed 3, {secs:.1f} s: "
        + "; ".join(f"{m} in-domain (EPE, bad) {r['in_domain_A']} cross-domain "
                    f"{r['cross_domain_B']} train {r['train_s']:.1f} s eval "
                    f"{r['eval_s']:.1f} s" for m, r in rows.items())
        + f"; launches {launches} [{state['smi']}]")
    for m, r in rows.items():
        for k in ("in_domain_A", "cross_domain_B"):
            assert all(v is not None and np.isfinite(v) for v in r[k]), (m, k, r)
        pngs = sorted((XDOM_ROOT / f"resB_{m}_3" / "dispColor").glob("*.png"))
        assert len(pngs) == 2, pngs
        assert png.rgb(png.decode(pngs[0].read_bytes())).shape == (375, 1242, 3)
    # the ms arm: 2 steps of 2 samples, then 2 + 2 frames; raw none; the
    # head: the 2 + 2 frames of each arm
    assert launches == _want(census_aml=8, head=8), launches
    state["launches_by_path"]["xdom"] = launches
    shutil.rmtree(XDOM_ROOT, ignore_errors=True)


DP_STEPS = 8
DP_TIMED = 24             # steps of each arm timed in turns
DP_FIXTURE = ROOT / "tests" / "data" / "torch_port"
DP_OUT = ROOT / "build" / "chip_smoke_train_dp"
DP_SEED = 8               # the global batch of parts (a) and (b)
DP_RTOL = 1e-4            # metrics, relative; the gradient, relative L2


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _snapshot(tr) -> dict:
    """A copy of ``tr.state()`` that later steps leave alone."""
    import copy
    return copy.deepcopy(tr.state())


def _timed_steps(tr, batch, n):
    """``n`` steps of ``tr``: (losses, ms of each step by CUDA events, the
    state after step 1, the collectives of step 3)."""
    import torch
    from msnets_tpu_torch.parallel import mesh as pm
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(n)]
    losses, first, coll = [], None, None
    for i, (start, end) in enumerate(events):
        before = pm.collectives
        start.record()
        m, _ = _step(tr, batch)
        end.record()
        losses.append(float(m["loss"]))
        if i == 0:
            first = _snapshot(tr)
        if i == 2:
            coll = pm.collectives - before
    torch.cuda.synchronize()
    return losses, [s.elapsed_time(e) for s, e in events], first, coll


def _dp_world1(state):
    """(a): the data-parallel step over an NCCL group of one rank against
    the plain step: step 1 bit for bit, then the main path's 8 steps, then
    the two timed in turns."""
    import torch
    import torch.distributed as dist
    from msnets_tpu_torch.engine import Trainer
    from msnets_tpu_torch.parallel import mesh as pm
    world, rank = pm.init_distributed(f"127.0.0.1:{_free_port()}", 1, 0)
    assert (world, rank, dist.get_backend()) == (1, 0, "nccl")
    cfg = _train_cfg()
    batch = _train_batch(cfg, DP_SEED)
    prev = torch.backends.cudnn.deterministic
    try:
        torch.backends.cudnn.deterministic = True
        plain = Trainer(cfg, seed=0)
        p_loss, _, p_first, _ = _timed_steps(plain, batch, 1)
        _reset_counts()                             # main path starts here
        dp = Trainer(cfg, seed=0, group=dist.group.WORLD)
        d_loss, _, d_first, coll = _timed_steps(dp, batch, DP_STEPS)
        launches = _counts()                        # main path ends here
        # in turns (plain, group, group, plain, ...), cuDNN's default
        # algorithms as in phase 10
        torch.backends.cudnn.deterministic = prev
        ms = {"plain": [], "group": []}
        for i in range(DP_TIMED):
            order = ("plain", "group") if i % 2 == 0 else ("group", "plain")
            for arm in order:
                _, t, _, _ = _timed_steps(plain if arm == "plain" else dp,
                                          batch, 1)
                ms[arm] += t
        del plain, dp
    finally:
        torch.backends.cudnn.deterministic = prev
        dist.destroy_process_group()
    same = _state_equal(p_first, d_first)
    p_med, d_med = float(np.median(ms["plain"])), float(np.median(ms["group"]))
    log("train_dp world 1 (NCCL): losses " + ", ".join(f"{x:.4f}" for x in d_loss))
    log(f"train_dp world 1: step 1 loss {d_loss[0]!r} against the plain "
        f"{p_loss[0]!r} (cuDNN deterministic); state after step 1 bit for "
        f"bit equal: {same}; {coll} collectives a step; launches {launches} "
        f"in {DP_STEPS} steps")
    quart = {k: np.percentile(v, [25, 75]) for k, v in ms.items()}
    log(f"train_dp world 1 256x512 batch 2 bf16: {d_med:.3f} ms/step with the "
        f"group, {p_med:.3f} without ({100 * (d_med / p_med - 1):+.2f}%; "
        f"median of {DP_TIMED} steps each, taken in turns after "
        f"{DP_STEPS + 1} and 1 steps, CUDA events; quartiles "
        f"{quart['group'][0]:.1f}-{quart['group'][1]:.1f} and "
        f"{quart['plain'][0]:.1f}-{quart['plain'][1]:.1f}) [{state['smi']}]")
    log("train_dp world 1 ms/step with the group " + ", ".join(
        f"{x:.1f}" for x in ms["group"]) + "; without " + ", ".join(
        f"{x:.1f}" for x in ms["plain"]))
    assert d_loss[0] == p_loss[0] and same
    assert np.isfinite(d_loss).all() and d_loss[-1] < d_loss[0], d_loss
    # the group's data-only mesh of one rank splits nothing: the metrics'
    # and the gradients' all-reduces (41 at 2 ranks, where BN and the
    # masked means reduce over the data axis)
    assert coll == 2, coll
    assert launches == _want(census_aml=2 * DP_STEPS), launches
    state["launches_by_path"]["train_dp"] = launches


def _dp_cfg():
    """Config() in float32 (part (b) runs with TF32 off)."""
    cfg = _train_cfg()
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, compute_dtype="float32"))


def _flat_grads(model):
    import torch
    return torch.cat([(torch.zeros_like(p) if p.grad is None else p.grad)
                      .reshape(-1) for p in model.parameters()]).cpu()


def _stats(model):
    return {k: v.detach().cpu().clone() for k, v in model.state_dict().items()
            if "running" in k}


def dp_rank(rank: int, coordinator: str, out: str) -> int:
    """One rank of phase 16 (b): gloo on CUDA tensors, one sample of the
    global batch, 2 steps; writes its results to ``out``."""
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(ROOT))
    from msnets_tpu_torch.engine import Trainer
    from msnets_tpu_torch.parallel import mesh as pm
    from msnets_tpu_torch.runtime import fp32_reference
    world, r = pm.init_distributed(coordinator, 2, rank, backend="gloo")
    assert (world, r, dist.get_backend()) == (2, rank, "gloo")
    torch.backends.cudnn.deterministic = True
    cfg = _dp_cfg()
    batch = _train_batch(cfg, DP_SEED)
    local = {k: v[rank:rank + 1] if isinstance(v, np.ndarray) else v
             for k, v in batch.items()}
    try:
        with fp32_reference():
            tr = Trainer(cfg, seed=rank, group=dist.group.WORLD)
            assert tr.device.type == "cuda"
            _reset_counts()
            m1, _ = _step(tr, local)
            res = {"metrics": [{k: float(v) for k, v in m1.items()}],
                   "grads": _flat_grads(tr.model), "stats": _stats(tr.model)}
            m2, _ = _step(tr, local)
            res["metrics"].append({k: float(v) for k, v in m2.items()})
            res["launches"] = _counts()
            res["state"] = {k: v.cpu() for k, v in tr.model.state_dict().items()}
        torch.save(res, out)
        log(f"train_dp rank {rank}: metrics {res['metrics']}, launches "
            f"{res['launches']}")
    finally:
        dist.destroy_process_group()
    return 0


def _dp_two_ranks(state):
    """(b): two ranks on the card over gloo against one process."""
    import torch
    from msnets_tpu_torch.runtime import fp32_reference
    shutil.rmtree(DP_OUT, ignore_errors=True)
    DP_OUT.mkdir(parents=True)
    coordinator = f"127.0.0.1:{_free_port()}"
    outs = [DP_OUT / f"rank{r}.pt" for r in range(2)]
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"),
                               "--train-dp-rank", str(r), coordinator,
                               str(outs[r])], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    try:
        texts = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, text) in enumerate(zip(procs, texts)):
        for line in text.splitlines():
            log(f"  [rank {r}] {line}")
        assert p.returncode == 0, f"rank {r} exited {p.returncode}"
    ranks = [torch.load(o, weights_only=False) for o in outs]
    ranks_s = time.perf_counter() - t0

    cfg = _dp_cfg()
    batch = _train_batch(cfg, DP_SEED)
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        with fp32_reference():
            ref = _one_process_steps(cfg, batch)
            # the noise floor: the same step on features x (1 + eps noise)
            floor = {eps: _rel_l2(_one_process_steps(cfg, batch, eps, 1)
                                  ["grads"], ref["grads"])
                     for eps in (1e-7, 1e-6)}
    finally:
        torch.backends.cudnn.deterministic = prev
    r0, r1 = ranks
    same = (r0["metrics"] == r1["metrics"]
            and all(torch.equal(v, r1["state"][k]) for k, v in r0["state"].items()))
    rel = {k: abs(r0["metrics"][0][k] - v) / max(abs(v), 1e-12)
           for k, v in ref["metrics"][0].items()}
    grad_err = _rel_l2(r0["grads"], ref["grads"])
    grad_bound = max(DP_RTOL, floor[1e-6])
    stat_err = max(float(((r0["stats"][k] - v).abs()
                          - 1e-3 * v.abs()).max()) for k, v in ref["stats"].items())
    log(f"train_dp 2 ranks over gloo on one card (Config() in float32, TF32 "
        f"off, cuDNN deterministic, 2 steps, {ranks_s:.1f} s with process "
        f"start): ranks bit for bit equal: {same}; step 1 against one "
        f"process: metrics relative { {k: f'{v:.3g}' for k, v in rel.items()} }, "
        f"gradient relative L2 {grad_err:.3g} (bound {grad_bound:.3g}: 1e-4, "
        f"or the one-process step's own move under features x (1 + eps "
        f"noise): eps 1e-7 {floor[1e-7]:.3g}, eps 1e-6 {floor[1e-6]:.3g}), "
        f"BN statistics max(|d| - 1e-3 |ref|) {stat_err:.3g}; step 2 losses "
        f"{r0['metrics'][1]['loss']!r} / {ref['metrics'][1]['loss']!r}; "
        f"launches {r0['launches']} / {r1['launches']} [{state['smi']}]")
    assert same
    assert max(rel.values()) <= DP_RTOL, rel
    assert grad_err <= grad_bound, (grad_err, floor)
    for k, v in ref["stats"].items():
        assert torch.allclose(r0["stats"][k], v, rtol=1e-3, atol=1e-4), k
    for r in ranks:
        assert r["launches"] == _want(census_aml=2), r["launches"]
    shutil.rmtree(DP_OUT, ignore_errors=True)


def _rel_l2(got, want) -> float:
    got, want = got.double(), want.double()
    return float((got - want).norm() / want.norm())


def _one_process_steps(cfg, batch, eps: float = 0.0, steps: int = 2) -> dict:
    """``steps`` steps of one Trainer (seed 0) on the whole batch: the
    metrics of each, the step-1 gradient and BN statistics. With ``eps``
    the features are multiplied by (1 + eps * seeded normal noise)."""
    import torch
    from msnets_tpu_torch.engine import Trainer
    one = Trainer(cfg, seed=0)
    if eps:
        features = one.features

        def noisy(*a, **k):
            f = features(*a, **k)
            g = torch.Generator(device=f.device).manual_seed(0)
            return f * (1 + eps * torch.randn(f.shape, generator=g,
                                              device=f.device, dtype=f.dtype))
        one.features = noisy
    out = {"metrics": []}
    for i in range(steps):
        m, _ = _step(one, batch)
        out["metrics"].append({k: float(v) for k, v in m.items()})
        if i == 0:
            out["grads"], out["stats"] = _flat_grads(one.model), _stats(one.model)
    return out


def _dp_jax_checkpoint(state):
    """(c): the JAX package's checkpoint served and trained on the card."""
    import torch
    from msnets_tpu_torch import Config, StereoServer
    from msnets_tpu_torch.engine import Trainer
    from msnets_tpu_torch.runtime import fp32_reference
    path = str(DP_FIXTURE / "MS-GCNet" / "model_step_00000002.msgpack")
    pair = np.load(DP_FIXTURE / "pair.npz")
    cfg = Config.from_json(str(pair["config"]))
    with fp32_reference():
        server = StereoServer.from_checkpoint(cfg, path)
        assert server.device.type == "cuda"
        got = server.predict(pair["iml"], pair["imr"])
    err = float(np.abs(got - pair["disp"]).max())
    tr = Trainer(cfg, seed=0)
    meta = tr.resume(path)
    moments = len(tr.optimizer.state)
    m, _ = _step(tr, _dp_fixture_batch(cfg))
    loss = float(m["loss"])
    log(f"train_dp JAX checkpoint {Path(path).name}: served {pair['iml'].shape} "
        f"in float32, max |d disparity| against the JAX server {err:.3g} px "
        f"(atol 2e-3); resumed step {tr.step - 1} with meta {meta} and "
        f"{moments} Adam states, one step: loss {loss:.6f} [{state['smi']}]")
    assert got.shape == pair["disp"].shape and err <= 2e-3, err
    assert meta == {"epoch": 1, "iteration": 2} and moments > 0
    assert tr.step == 3 and np.isfinite(loss), (tr.step, loss)


def _dp_fixture_batch(cfg):
    from msnets_tpu_torch.data.pipeline import synthetic_train_batch
    t = cfg.train
    return synthetic_train_batch(t.crop_height, t.crop_width, cfg.model.max_disp,
                                 cfg.matching, t.batch_size, 6, DP_SEED, True)


def phase_train_dp(state):
    _dp_world1(state)
    _dp_two_ranks(state)
    _dp_jax_checkpoint(state)


MESH_OUT = ROOT / "build" / "chip_smoke_serve_mesh"
MESH_LAUNCHES = {2: [(1, 2, 1), (1, 1, 2)], 4: [(1, 2, 2)]}
MESH_SERVERS = {"gcnet": ("MS-GCNet", 8), "psmnet": ("MS-PSMNet", 8),
                "gcnet16": ("MS-GCNet", 16), "gcnet_int8": ("MS-GCNet", 8)}
# the keys served once, untimed, at one mesh each
MESH_ONCE = {"gcnet16": (1, 1, 2), "gcnet_int8": (1, 2, 2)}
MESH_ATOL_PX = 1e-3
MESH_TIMED = 3            # predicts timed at 375x1242 on each rank


def _mesh_cfg(key):
    """Config() (max_disp 192, F=32) with the model and channels of
    ``key``, in float32 (run with TF32 off)."""
    from msnets_tpu_torch import Config, MatchingConfig
    name, channels = MESH_SERVERS[key]
    cfg = Config(matching=MatchingConfig(num_channels=channels))
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, name=name, in_channels=channels, compute_dtype="float32",
        quant_eval=key == "gcnet_int8"))


def _mesh_requests(key):
    if key == "gcnet16":
        return [textured_pair(256, 512, 24, 42)]
    if key == "gcnet_int8":
        return [textured_pair(256, 512, 24, 43)]
    return [textured_pair(256, 512, 24, 40), textured_pair(375, 1242, 40, 41)]


def _mesh_keys(shape):
    return [k for k in MESH_SERVERS if MESH_ONCE.get(k, shape) == shape]


def _mesh_want(key):
    """A request's launches on each rank of the mesh of ``key``."""
    if key == "gcnet16":
        return _want(census=1)
    # MS-GCNet "all" dynamic at 256x512: conv3dbn_2 and block_3d_1 run int8
    n = 2 if key == "gcnet_int8" else 0
    return _want(census_aml=1, int8_conv3d=n, int8_absmax=n)


def _mesh_serve(server, requests, timed: int) -> dict:
    """The main path's requests through ``server`` (the kernels' counts from
    0), then the memory one forward of the last request adds to what is
    allocated, and ms per request over ``timed`` more (predict returns on
    the host)."""
    import torch
    from msnets_tpu_torch.parallel import mesh as pm
    server.warmup([l.shape for l, _ in requests])
    before = pm.collectives
    _reset_counts()                                 # main path starts here
    disps = [server.predict(l, r) for l, r in requests]
    launches = _counts()                            # main path ends here
    coll = (pm.collectives - before) / len(requests)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    server.predict(*requests[-1])
    peak = torch.cuda.max_memory_allocated() - base
    t0 = time.perf_counter()
    for _ in range(timed):
        server.predict(*requests[-1])
    ms = (time.perf_counter() - t0) * 1e3 / timed if timed else None
    return {"disps": disps, "launches": launches, "collectives": coll,
            "peak_gib": peak / 2**30, "ms": ms}


def _ms(r) -> str:
    return "untimed" if r["ms"] is None else f"{r['ms']:.1f} ms a request"


def serve_mesh_rank(rank: int, world: int, coordinator: str, out: str) -> int:
    """One rank of phase 17 (b): gloo on CUDA tensors, every mesh of
    ``MESH_LAUNCHES[world]`` in turn, each server of it; writes its
    results to ``out``."""
    import gc
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(ROOT))
    from msnets_tpu_torch import StereoServer
    from msnets_tpu_torch.parallel import mesh as pm
    from msnets_tpu_torch.runtime import fp32_reference
    got = pm.init_distributed(coordinator, world, rank, backend="gloo")
    assert got == (world, rank) and dist.get_backend() == "gloo", got
    # gloo all-reduces CUDA tensors of the volumes' dtypes, sum and max
    for dt in (torch.bfloat16, torch.float32):
        t = torch.full((3,), rank + 1.0, dtype=dt, device="cuda")
        tot = pm.all_reduce_sum(t.clone(), dist.group.WORLD)
        top = pm.all_reduce_max(t.clone(), dist.group.WORLD)
        assert tot.eq(world * (world + 1) / 2).all() and top.eq(world).all(), dt
    log(f"serve_mesh rank {rank}: gloo sums and maxes bfloat16 and float32 "
        f"CUDA tensors")
    torch.backends.cudnn.deterministic = True
    res = {}
    try:
        with fp32_reference():
            for shape in MESH_LAUNCHES[world]:
                mesh = pm.make_mesh(shape)
                for key in _mesh_keys(shape):
                    cfg = _mesh_cfg(key)
                    server = StereoServer(cfg, _random_state_dict(cfg, 0),
                                          mesh=mesh)
                    assert server.device.type == "cuda"
                    res[shape, key] = r = _mesh_serve(
                        server, _mesh_requests(key),
                        0 if key in MESH_ONCE else MESH_TIMED)
                    log(f"serve_mesh rank {rank} {shape} {key}: launches "
                        f"{r['launches']}, {r['collectives']:.0f} "
                        f"collectives a request, one forward adds "
                        f"{r['peak_gib']:.3f} GiB, {_ms(r)}")
                    del server
                    gc.collect()
                    torch.cuda.empty_cache()
        torch.save(res, out)
    finally:
        dist.destroy_process_group()
    return 0


def _mesh_world1(state):
    """(a): Config() (bf16) over an NCCL group of one rank under
    make_mesh((1, 1, 1)) against the plain server, under cuDNN's
    deterministic algorithms: bit for bit once the plain server runs the
    head a mesh runs (the conv and ``soft_argmin``); its own fused head's
    distance is logged."""
    import torch
    import torch.distributed as dist
    from msnets_tpu_torch import Config, StereoServer
    from msnets_tpu_torch.models import gcnet
    from msnets_tpu_torch.models.layers import conv_head
    from msnets_tpu_torch.parallel import mesh as pm
    world, rank = pm.init_distributed(f"127.0.0.1:{_free_port()}", 1, 0)
    assert (world, rank, dist.get_backend()) == (1, 0, "nccl")
    cfg, sd = Config(), state["state_dict"]
    requests = [textured_pair(256, 512, 24 + 8 * i, 50 + i) for i in range(3)]
    prev, fused_head = torch.backends.cudnn.deterministic, gcnet.subpixel_soft_argmin
    try:
        torch.backends.cudnn.deterministic = True
        fused = [StereoServer(cfg, sd).predict(l, r) for l, r in requests]
        gcnet.subpixel_soft_argmin = conv_head
        plain = [StereoServer(cfg, sd).predict(l, r) for l, r in requests]
        gcnet.subpixel_soft_argmin = fused_head
        server = StereoServer(cfg, sd, mesh=pm.make_mesh((1, 1, 1)))
        r = _mesh_serve(server, requests, 0)
        del server
    finally:
        gcnet.subpixel_soft_argmin = fused_head
        torch.backends.cudnn.deterministic = prev
        dist.destroy_process_group()
    same = all(np.array_equal(a, b) for a, b in zip(plain, r["disps"]))
    gap = max(float(np.abs(a - b).max()) for a, b in zip(fused, plain))
    log(f"serve_mesh world 1 (NCCL, make_mesh((1, 1, 1)), Config() bf16, "
        f"256x512, cuDNN deterministic): {len(requests)} requests bit for "
        f"bit the plain server's with the conv head: {same}; the plain "
        f"server's fused head max |d disparity| {gap:.3g} px from it (its "
        f"float32 head against cuDNN's TF32 one); {r['collectives']:.0f} "
        f"collectives a request (nothing is split); launches "
        f"{r['launches']}")
    assert same
    assert r["launches"] == _want(census_aml=len(requests)), r
    return r["launches"]


def _mesh_one_process(state) -> dict:
    """The one-process server of each key on the same requests, float32
    with TF32 off, cuDNN deterministic: the disparities, and the memory
    and time of one 375x1242 forward."""
    import gc
    import torch
    from msnets_tpu_torch import StereoServer
    from msnets_tpu_torch.runtime import fp32_reference
    prev = torch.backends.cudnn.deterministic
    refs = {}
    try:
        torch.backends.cudnn.deterministic = True
        with fp32_reference():
            for key in MESH_SERVERS:
                cfg = _mesh_cfg(key)
                server = StereoServer(cfg, _random_state_dict(cfg, 0))
                refs[key] = _mesh_serve(server, _mesh_requests(key),
                                        0 if key in MESH_ONCE else MESH_TIMED)
                del server
                gc.collect()
                torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.deterministic = prev
    return refs


def _script_ranks(flag: str, world: int, out_dir: Path,
                  timeout_s: float = 600) -> list:
    """``world`` ranks of this script (``flag`` RANK WORLD HOST:PORT OUT)
    sharing the card over gloo; each rank's results. A rank that fails or
    outlives ``timeout_s`` fails the phase; every rank is ended."""
    import torch
    out_dir.mkdir(parents=True, exist_ok=True)
    coordinator = f"127.0.0.1:{_free_port()}"
    outs = [out_dir / f"w{world}_rank{r}.pt" for r in range(world)]
    procs = [subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"),
                               flag, str(r), str(world), coordinator,
                               str(outs[r])],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
             for r in range(world)]
    try:
        texts = [p.communicate(timeout=timeout_s)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, text) in enumerate(zip(procs, texts)):
        for line in text.splitlines():
            log(f"  [rank {r}/{world}] {line}")
        assert p.returncode == 0, f"rank {r} of {world} exited {p.returncode}"
    return [torch.load(o, weights_only=False) for o in outs]


def phase_serve_mesh(state):
    """(a) world 1 over NCCL; (b) 2 and 4 gloo ranks on the card against
    the one-process server."""
    shutil.rmtree(MESH_OUT, ignore_errors=True)
    total = dict(_mesh_world1(state))
    refs = _mesh_one_process(state)
    for key, r in refs.items():
        log(f"serve_mesh one process {key}: one forward at "
            f"{_mesh_requests(key)[-1][0].shape} adds {r['peak_gib']:.3f} "
            f"GiB, {_ms(r)} (float32, TF32 off) [{state['smi']}]")
    for world, meshes in MESH_LAUNCHES.items():
        ranks = _script_ranks("--serve-mesh-rank", world, MESH_OUT)
        for shape in meshes:
            for key in _mesh_keys(shape):
                res = [rk[shape, key] for rk in ranks]
                ref = refs[key]
                err = max(float(np.abs(d - w).max())
                          for d, w in zip(res[0]["disps"], ref["disps"]))
                same = all(np.array_equal(a, b) for rk in res[1:]
                           for a, b in zip(rk["disps"], res[0]["disps"]))
                per = _mesh_want(key)
                n = len(ref["disps"])
                peaks = ", ".join(f"{rk['peak_gib']:.3f}" for rk in res)
                log(f"serve_mesh {shape} {key} ({world} gloo ranks sharing "
                    f"one card, float32, TF32 off, cuDNN deterministic): max "
                    f"|d disparity| against one process {err:.3g} px (atol "
                    f"{MESH_ATOL_PX}), ranks bit for bit: {same}; "
                    f"{res[0]['collectives']:.0f} collectives a request; "
                    f"one forward at {_mesh_requests(key)[-1][0].shape} adds "
                    f"{peaks} GiB on the ranks against {ref['peak_gib']:.3f} "
                    f"in one process; {_ms(res[0])} against "
                    f"{_ms(ref)} (ranks sharing one card over gloo: no "
                    f"multi-card speed) [{state['smi']}]")
                assert err <= MESH_ATOL_PX, (shape, key, err)
                assert same, (shape, key)
                for rk in res:
                    assert rk["launches"] == {k: v * n for k, v in per.items()}, \
                        (shape, key, rk["launches"])
                    for k, v in rk["launches"].items():
                        total[k] = total.get(k, 0) + v
    state["launches_by_path"]["serve_mesh"] = total
    shutil.rmtree(MESH_OUT, ignore_errors=True)


TRAIN_MESH_OUT = ROOT / "build" / "chip_smoke_train_mesh"
# the meshes each launch of ranks takes in turn
TRAIN_MESH_LAUNCHES = {2: [(1, 2, 1), (1, 1, 2)], 4: [(1, 2, 2), (2, 2, 1)],
                       8: [(2, 2, 2)]}
# key -> (model, channels, grad_accum, remat, steps)
TRAIN_MESH_CASES = {"gcnet": ("MS-GCNet", 8, 1, False, 2),
                    "gcnet_remat": ("MS-GCNet", 8, 1, True, 2),
                    "psmnet": ("MS-PSMNet", 8, 2, False, 1),
                    "gcnet16": ("MS-GCNet", 16, 1, False, 1)}
TRAIN_MESH_WORLD1_STEPS = 3
TRAIN_MESH_DISP_ATOL = 2e-2     # tests/test_parallel.py's disparity bound
ACCU3_TOL, ACCU3_SEED = 1e-4, 7  # tests/test_parallel.py's metric bound


def _train_mesh_keys(shape):
    keys = ["gcnet"]
    if shape == (1, 2, 2):
        keys += ["gcnet_remat", "psmnet"]
    if shape == (1, 1, 2):
        keys.append("gcnet16")
    return keys


def _train_mesh_cfg(key):
    """Config() (MS-GCNet or MS-PSMNet, F=32, max_disp 192, batch 2, crop
    256x512) with ``key``'s channels, grad_accum and remat, in float32 (run
    with TF32 off)."""
    from msnets_tpu_torch import MatchingConfig
    name, channels, accum, remat, _ = TRAIN_MESH_CASES[key]
    cfg = _train_cfg(grad_accum=accum, remat=remat)
    return dataclasses.replace(
        cfg, matching=MatchingConfig(num_channels=channels),
        model=dataclasses.replace(cfg.model, name=name, in_channels=channels,
                                  compute_dtype="float32"))


def _data_rows(batch: int, data: int, accum: int, d: int) -> list:
    """The rows of a global batch that data index ``d`` takes: micro-batch
    k is rows [(k*data + d)*m, (k*data + d + 1)*m), m = batch // (data *
    accum) (the Trainer's split)."""
    m = batch // (data * accum)
    return [(k * data + d) * m + j for k in range(accum) for j in range(m)]


def _train_mesh_steps(tr, batch, steps: int) -> dict:
    """``steps`` steps of ``tr`` on ``batch`` (the kernels' counts from 0):
    the metrics of each, ms of each (CUDA events), the step-1 disparity,
    gradient, BN statistics and collectives, the memory step 1 adds to
    what was allocated, and the state after the last step."""
    import torch
    from msnets_tpu_torch.parallel import mesh as pm
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    out = {"metrics": [], "ms": []}
    for i in range(steps):
        before = pm.collectives
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        m, d = _step(tr, batch)
        end.record()
        torch.cuda.synchronize()
        out["ms"].append(start.elapsed_time(end))
        out["metrics"].append({k: float(v) for k, v in m.items()})
        if i == 0:
            out.update(disp=d.float().cpu().numpy(), grads=_flat_grads(tr.model),
                       stats=_stats(tr.model),
                       collectives=pm.collectives - before,
                       peak_gib=(torch.cuda.max_memory_allocated() - base)
                       / 2**30)
    out["launches"] = _counts()
    out["state"] = {"state_dict": {k: v.cpu() for k, v in
                                   tr.model.state_dict().items()},
                    "optimizer": tr.optimizer.state_dict(), "step": tr.step}
    return out


def train_mesh_rank(rank: int, world: int, coordinator: str, out: str) -> int:
    """One rank of phase 18 (b): gloo on CUDA tensors, every mesh of
    ``TRAIN_MESH_LAUNCHES[world]`` in turn, each case of it on this rank's
    data share of the global batch; writes its results to ``out``."""
    import gc
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(ROOT))
    from msnets_tpu_torch.engine import Trainer
    from msnets_tpu_torch.parallel import mesh as pm
    from msnets_tpu_torch.runtime import fp32_reference
    got = pm.init_distributed(coordinator, world, rank, backend="gloo")
    assert got == (world, rank) and dist.get_backend() == "gloo", got
    torch.backends.cudnn.deterministic = True
    res = {}
    try:
        with fp32_reference():
            for shape in TRAIN_MESH_LAUNCHES[world]:
                mesh = pm.make_mesh(shape)
                d = mesh.index("data")
                for key in _train_mesh_keys(shape):
                    cfg = _train_mesh_cfg(key)
                    batch = _train_batch(cfg, DP_SEED)
                    rows = _data_rows(cfg.train.batch_size, shape[0],
                                      cfg.train.grad_accum, d)
                    local = {k: v[rows] if isinstance(v, np.ndarray) else v
                             for k, v in batch.items()}
                    tr = Trainer(cfg, seed=rank, mesh=mesh)
                    assert tr.device.type == "cuda"
                    res[shape, key] = r = _train_mesh_steps(
                        tr, local, TRAIN_MESH_CASES[key][4])
                    r["data_index"] = d
                    log(f"train_mesh rank {rank} {shape} {key}: metrics "
                        f"{r['metrics']}, launches {r['launches']}, "
                        f"{r['collectives']} collectives in step 1, step 1 "
                        f"adds {r['peak_gib']:.3f} GiB, ms/step "
                        + ", ".join(f"{x:.1f}" for x in r["ms"]))
                    del tr
                    gc.collect()
                    torch.cuda.empty_cache()
        torch.save(res, out)
    finally:
        dist.destroy_process_group()
    return 0


def _train_mesh_world1(state) -> dict:
    """(a): Config() (bf16) over an NCCL group of one rank under
    make_mesh((1, 1, 1)) against the plain Trainer, under cuDNN's
    deterministic algorithms: step 1 bit for bit; the collectives a step
    and ms/step."""
    import torch
    import torch.distributed as dist
    from msnets_tpu_torch.engine import Trainer
    from msnets_tpu_torch.parallel import mesh as pm
    world, rank = pm.init_distributed(f"127.0.0.1:{_free_port()}", 1, 0)
    assert (world, rank, dist.get_backend()) == (1, 0, "nccl")
    cfg = _train_cfg()
    batch = _train_batch(cfg, DP_SEED)
    prev = torch.backends.cudnn.deterministic
    try:
        torch.backends.cudnn.deterministic = True
        plain = Trainer(cfg, seed=0)
        p_loss, _, p_first, _ = _timed_steps(plain, batch, 1)
        del plain
        _reset_counts()                             # main path starts here
        tr = Trainer(cfg, seed=0, mesh=pm.make_mesh((1, 1, 1)))
        losses, ms, first, coll = _timed_steps(tr, batch,
                                               TRAIN_MESH_WORLD1_STEPS)
        launches = _counts()                        # main path ends here
        del tr
    finally:
        torch.backends.cudnn.deterministic = prev
        dist.destroy_process_group()
    same = _state_equal(p_first, first)
    log(f"train_mesh world 1 (NCCL, make_mesh((1, 1, 1)), Config() bf16, "
        f"cuDNN deterministic): step 1 loss {losses[0]!r} against the plain "
        f"{p_loss[0]!r}; state after step 1 (every parameter, BN statistic "
        f"and Adam moment) bit for bit: {same}; {coll} collectives a step "
        f"(nothing is split: the metrics and the gradients); ms/step "
        + ", ".join(f"{x:.1f}" for x in ms) + f"; launches {launches} "
        f"[{state['smi']}]")
    assert losses[0] == p_loss[0] and same
    assert np.isfinite(losses).all() and coll == 2, (losses, coll)
    want = _want(census_aml=2 * TRAIN_MESH_WORLD1_STEPS)
    assert launches == want, launches
    return launches


def _train_mesh_one_process(state) -> dict:
    """Each case's one-process steps on the global batch (the key's
    steps; gcnet_remat takes gcnet's, the same function), float32 with
    TF32 off, cuDNN deterministic; and the move of its step-1 gradient
    when the features are multiplied by (1 + 1e-6 noise)."""
    import gc
    import torch
    from msnets_tpu_torch.engine import Trainer
    from msnets_tpu_torch.runtime import fp32_reference
    prev = torch.backends.cudnn.deterministic
    refs = {}
    try:
        torch.backends.cudnn.deterministic = True
        with fp32_reference():
            for key in ("gcnet", "psmnet", "gcnet16"):
                cfg = _train_mesh_cfg(key)
                batch = _train_batch(cfg, DP_SEED)
                refs[key] = r = _train_mesh_steps(Trainer(cfg, seed=0), batch,
                                                  TRAIN_MESH_CASES[key][4])
                gc.collect()
                torch.cuda.empty_cache()
                r["floor"] = _rel_l2(_one_process_steps(cfg, batch, 1e-6, 1)
                                     ["grads"], r["grads"])
                log(f"train_mesh one process {key}: metrics {r['metrics']}, "
                    f"step 1 adds {r['peak_gib']:.3f} GiB, ms/step "
                    + ", ".join(f"{x:.1f}" for x in r["ms"])
                    + f"; the step-1 gradient moves {r['floor']:.3g} "
                    f"(relative L2) under features x (1 + 1e-6 noise) "
                    f"[{state['smi']}]")
                gc.collect()
                torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.deterministic = prev
    refs["gcnet_remat"] = refs["gcnet"]
    return refs


def _accu3_slack(cfg, ref, res, data: int):
    """The largest |d disparity| of the ranks' step-1 disparities against
    one process's (each rank holds its data index's rows), and how far
    that lets accu3 move: accu3 counts the valid pixels whose error is at
    most 3 px, so a pixel can change sides only if its one-process error
    lies within that |d disparity| of 3. Returns (|d disparity|, the mean
    over the micro-batches of the share of such pixels)."""
    from msnets_tpu_torch.engine.loss import train_valid_mask
    t = cfg.train
    want = ref["disp"]
    dmax = max(float(np.abs(r["disp"] - want[_data_rows(
        t.batch_size, data, t.grad_accum, r["data_index"])]).max())
        for r in res)
    target = _train_batch(cfg, DP_SEED)["disp"]
    import torch
    valid = train_valid_mask(torch.from_numpy(target),
                             cfg.model.max_disp).numpy()
    near = valid & (np.abs(np.abs(want - target) - 3.0) <= dmax)
    m = t.batch_size // t.grad_accum
    slack = np.mean([near[k:k + m].sum() / max(valid[k:k + m].sum(), 1)
                     for k in range(0, t.batch_size, m)])
    return dmax, float(slack)


def _accu3_spread(cfg, ref, res, data: int) -> float:
    """accu3 of each rank's step-1 disparities against one process's, both
    scored on a target that is not the batch's one constant disparity: the
    one-process disparity plus uniform noise in [-6, 6] px (seeded), so
    that the errors spread evenly over the 3 px threshold. Returns the
    largest difference over the ranks, which ACCU3_TOL bounds without
    regard to this run's |d disparity|."""
    import torch
    from msnets_tpu_torch.engine.loss import train_valid_mask, valid_accu3
    t = cfg.train
    want = ref["disp"]
    valid = train_valid_mask(torch.from_numpy(
        _train_batch(cfg, DP_SEED)["disp"]), cfg.model.max_disp)
    spread = torch.from_numpy(want + np.random.default_rng(ACCU3_SEED).uniform(
        -6.0, 6.0, want.shape).astype(np.float32))
    err = 0.0
    for r in res:
        rows = _data_rows(t.batch_size, data, t.grad_accum, r["data_index"])
        got = valid_accu3(spread[rows], torch.from_numpy(r["disp"]),
                          valid[rows])
        one = valid_accu3(spread[rows], torch.from_numpy(want[rows]),
                          valid[rows])
        err = max(err, abs(float(got) - float(one)))
    return err


def phase_train_mesh(state):
    """(a) world 1 over NCCL; (b) 2, 4 and 8 gloo ranks on the card against
    the one-process step."""
    import torch
    shutil.rmtree(TRAIN_MESH_OUT, ignore_errors=True)
    total = dict(_train_mesh_world1(state))
    refs = _train_mesh_one_process(state)
    for world, meshes in TRAIN_MESH_LAUNCHES.items():
        t0 = time.perf_counter()
        ranks = _script_ranks("--train-mesh-rank", world, TRAIN_MESH_OUT, 300)
        log(f"train_mesh {world} ranks: {time.perf_counter() - t0:.1f} s with "
            f"process start")
        for shape in meshes:
            for key in _train_mesh_keys(shape):
                res = [rk[shape, key] for rk in ranks]
                ref, r0 = refs[key], res[0]
                cfg = _train_mesh_cfg(key)
                same = all(r["metrics"] == r0["metrics"]
                           and _state_equal(r["state"], r0["state"])
                           for r in res[1:])
                rel = {k: abs(r0["metrics"][0][k] - v) / max(abs(v), 1e-12)
                       for k, v in ref["metrics"][0].items() if k != "accu3"}
                dmax, slack = _accu3_slack(cfg, ref, res, shape[0])
                accu3_spread = _accu3_spread(cfg, ref, res, shape[0])
                accu3_err = abs(r0["metrics"][0]["accu3"]
                                - ref["metrics"][0]["accu3"])
                grad_err = _rel_l2(r0["grads"], ref["grads"])
                bound = max(DP_RTOL, ref["floor"])
                stat_err = max(float(((r0["stats"][k] - v).abs()
                                      - 1e-3 * v.abs()).max())
                               for k, v in ref["stats"].items())
                kernel = "census" if TRAIN_MESH_CASES[key][1] == 16 \
                    else "census_aml"
                per_step = cfg.train.batch_size // shape[0]
                want = _want(**{kernel: per_step * TRAIN_MESH_CASES[key][4]})
                peaks = ", ".join(f"{r['peak_gib']:.3f}" for r in res)
                log(f"train_mesh {shape} {key} ({world} gloo ranks sharing "
                    f"one card, Config() widths in float32, TF32 off, cuDNN "
                    f"deterministic): ranks bit for bit: {same}; step 1 "
                    f"against one process: metrics relative "
                    f"{ {k: f'{v:.3g}' for k, v in rel.items()} }, max "
                    f"|d disparity| {dmax:.3g} px (atol {TRAIN_MESH_DISP_ATOL}), "
                    f"accu3 {accu3_err:.3g} (bound {slack:.3g}: the valid "
                    f"pixels whose error lies within {dmax:.3g} px of 3) and "
                    f"{accu3_spread:.3g} on a target spread over the 3 px "
                    f"threshold (bound {ACCU3_TOL}), gradient "
                    f"relative L2 {grad_err:.3g} (bound {bound:.3g}: 1e-4 or "
                    f"the 1e-6-noise move), BN statistics max(|d| - 1e-3 "
                    f"|ref|) {stat_err:.3g}; {r0['collectives']} collectives "
                    f"in step 1; step 1 adds {peaks} GiB on the ranks against "
                    f"{ref['peak_gib']:.3f} in one process; ms/step on rank 0 "
                    + ", ".join(f"{x:.1f}" for x in r0["ms"])
                    + " against " + ", ".join(f"{x:.1f}" for x in ref["ms"])
                    + f" in one process (the ranks share one card over gloo: "
                    f"no multi-card speed); launches a rank "
                    f"{[r['launches'][kernel] for r in res]} [{state['smi']}]")
                assert same, (shape, key)
                assert max(rel.values()) <= DP_RTOL, (shape, key, rel)
                assert dmax <= TRAIN_MESH_DISP_ATOL, (shape, key, dmax)
                assert accu3_err <= slack + 1e-7, (shape, key, accu3_err, slack)
                assert accu3_spread <= ACCU3_TOL, (shape, key, accu3_spread)
                assert grad_err <= bound, (shape, key, grad_err, bound)
                for k, v in ref["stats"].items():
                    assert torch.allclose(r0["stats"][k], v, rtol=1e-3,
                                          atol=1e-4), (shape, key, k)
                for r in res:
                    assert r["launches"] == want, (shape, key, r["launches"])
                    for k, v in r["launches"].items():
                        total[k] = total.get(k, 0) + v
    state["launches_by_path"]["train_mesh"] = total
    shutil.rmtree(TRAIN_MESH_OUT, ignore_errors=True)


# H100 SXM data-sheet peak of dense int8 tensor-core operations
INT8_OPS_PER_S = 1979e12
# the int8 conv kernel against its plain version: name, xq [N, D, H, W,
# Cin], Cout, stride, padding; sample 1 of N = 2 spans all of int8 and
# sample 0 a tenth of it (as two samples of unequal scales quantize)
INT8_CASES = [
    ("s1 cin8 odd dims", (1, 5, 7, 9, 8), 16, 1, (1, 1, 1)),
    ("s2 cin4 N2 odd dims", (2, 7, 9, 11, 4), 8, 2, (1, 1, 1)),
    ("s1 cin8 N2 pad 011", (2, 6, 8, 10, 8), 16, 1, (0, 1, 1)),
    ("s2 cin4 pad 101", (1, 6, 9, 8, 4), 8, 2, (1, 0, 1)),
    ("s2 cin8 pad 011 odd dims", (1, 7, 9, 11, 8), 24, 2, (0, 1, 1)),
    ("H=1 cin8", (1, 4, 1, 6, 8), 16, 1, (1, 1, 1)),
    ("cin5 zero-padded", (1, 4, 5, 6, 5), 12, 1, (1, 1, 1)),
    ("cin64 s2", (1, 6, 10, 12, 64), 64, 2, (1, 1, 1)),
    ("cin32 cout40 N2 ragged third ow tile", (2, 3, 4, 300, 32), 40, 1,
     (1, 1, 1)),
    ("cin128 cout40 s2 pad 010", (1, 4, 5, 140, 128), 40, 2, (0, 1, 0)),
    # the production convs at the 256x512 bucket's full H x W and widths,
    # D cut to 4 planes so that the float64 plain version on the host
    # stays seconds long
    ("conv3dbn_2 D4", (1, 4, 128, 256, 32), 32, 1, (1, 1, 1)),
    ("block_3d_1 entry D4", (1, 4, 128, 256, 32), 64, 2, (1, 1, 1)),
]
# every shape the servers give the kernel, at full size (D_in 96; the
# 256x512 bucket, then the 384x1248 one of 375x1242), timed and held
# exactly against the plain version: MS-PSMNet's dres0_2 and dres1_* have
# conv3dbn_2's shape, its hourglass conv1 block_3d_1's and conv3
# block_3d_2's
INT8_TIMED = [("conv3dbn_2", (1, 96, 128, 256, 32), 32, 1),
              ("block_3d_1.convbn_3d_1", (1, 96, 128, 256, 32), 64, 2),
              ("conv3dbn_2 375x1242", (1, 96, 192, 624, 32), 32, 1),
              ("block_3d_1.convbn_3d_1 375x1242", (1, 96, 192, 624, 32),
               64, 2),
              ("block_3d_2.convbn_3d_1 375x1242", (1, 48, 96, 312, 64),
               64, 2)]
# server: model, quant_scope, quant_mode, int8 convs a request at 256x512
# and at 375x1242 (models/quant.py's coverage)
QUANT_SERVERS = {"gcnet_all": ("MS-GCNet", "all", "dynamic", (2, 3)),
                 "gcnet_stem": ("MS-GCNet", "stem", "dynamic", (1, 1)),
                 "gcnet_static": ("MS-GCNet", "all", "static", (2, 3)),
                 "psmnet": ("MS-PSMNet", "all", "dynamic", (6, 9))}


def _int8_operands(shape, cout, rng):
    import torch
    xq = rng.integers(-127, 128, shape, dtype=np.int8)
    if shape[0] == 2:
        xq[0] //= 10
    wq = rng.integers(-127, 128, (cout, 3, 3, 3, shape[-1]), dtype=np.int8)
    return torch.from_numpy(xq), torch.from_numpy(wq)


def _dequant_operands(n, cout, rng):
    """A scale a sample (or one for all when ``n`` is 0), kernel scales and
    a bias, float32."""
    import torch
    f = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa: E731
    sx = f(rng.uniform(1e-3, 5e-2, n)) if n else f(np.float32(0.02))
    return sx, f(rng.uniform(1e-4, 1e-2, cout)), f(rng.standard_normal(cout))


def _padded(xq):
    """An int8 volume's channels zero-padded as int8_quantize writes them."""
    import torch.nn.functional as F
    from msnets_tpu_torch.ops.cuda.int8_conv3d import padded_channels
    c = xq.shape[-1]
    return F.pad(xq, (0, padded_channels(c) - c)).contiguous()


def _int8_sass(state):
    """The int8 conv library's SASS (cuobjdump): int8 tensor-core
    instructions (IMMA, or IGMMA for wgmma) and no IDP (__dp4a)."""
    from collections import Counter
    from msnets_tpu_torch.ops.cuda import _build
    tool = Path(_build.find_nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(tool), "-sass",
                           str(_build.library_path("int8_conv3d"))],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout
    ops = Counter(re.findall(r"\b((?:IMMA|IGMMA|HGMMA|IDP)[.\w]*)", sass))
    log(f"int8_conv3d SASS (cuobjdump -sass): {dict(ops)}")
    assert any(k.startswith(("IMMA", "IGMMA")) for k in ops), ops
    assert not any(k.startswith("IDP") for k in ops), ops
    state["int8_sass"] = dict(ops)


def _profiled_ms(runs: dict, patterns: dict) -> dict:
    """Device ms of one launch of each kernel: ``runs[k]()`` launches the
    kernel whose profiler name matches ``patterns[k]`` once; a profiler
    session calls each 10 times, and each kernel's time is the median of
    up to three sessions that record at least 9 of its launches. Where no
    session of six records them (the profiler now and then drops
    launches), CUDA events time the calls, the host's launch included.
    ``{k: (ms, "profiler" or "events")}``."""
    got = {k: [] for k in runs}
    for _ in range(6):
        seen = device_kernels_ms(lambda: [f() for f in runs.values()], 10)
        for k, pat in patterns.items():
            hits = [(v, c) for name, (v, c) in seen.items()
                    if re.search(pat, name)]
            if len(hits) == 1 and hits[0][1] >= 9 and len(got[k]) < 3:
                got[k].append(hits[0][0])
        if all(len(v) == 3 for v in got.values()):
            break
    return {k: (float(np.median(got[k])), "profiler") if got[k] else
            (cuda_time_ms(f, 10), "events") for k, f in runs.items()}


def _activation_ms(x, sx) -> dict:
    """Device ms of one call each of int8_quantize, int8_absmax (its
    kernel, and the memset that zeroes its output) and the aminmax pass
    (torch.aminmax over each sample, the max-abs kernel's library call), all
    in one profiler session of 10 calls each; the median of up to three
    sessions that record at least 9 launches of each. Where none of six
    does, ``queued_ms`` times each call (the memset inside the max-abs)."""
    import torch
    from msnets_tpu_torch.ops.cuda.int8_quantize import (int8_absmax,
                                                         int8_quantize)
    flat = x.reshape(x.shape[0], -1)
    runs = {"quantize": lambda: int8_quantize(x, sx),
            "absmax": lambda: int8_absmax(x),
            "library": lambda: torch.aminmax(flat, dim=1)}

    def bucket(name):
        return ("quantize" if "int8_quantize_tile" in name else
                "absmax" if "int8_absmax" in name else
                "zero" if name.startswith("Memset") else "library")

    got = {k: [] for k in ("quantize", "absmax", "zero", "library")}
    for _ in range(6):
        seen = device_kernels_ms(lambda: [f() for f in runs.values()], 10)
        per = {k: [] for k in got}
        for name, (ms, count) in seen.items():
            per[bucket(name)].append((ms, count))
        if all(per[k] and max(c for _, c in per[k]) >= 9 for k in runs):
            for k, hits in per.items():
                calls = max([c for _, c in hits], default=1)
                got[k].append(sum(ms * c for ms, c in hits) / calls)
        if len(got["quantize"]) == 3:
            break
    if got["quantize"]:
        out = {k: float(np.median(v)) for k, v in got.items()}
        out["timing"] = "profiler"
        return out
    log("activation path: no profiler session recorded every kernel; the "
        "last one saw " + ", ".join(f"{k} {len(v)} kernels, "
                                    f"{max([c for _, c in v], default=0)} "
                                    f"launches" for k, v in per.items()))
    out = {k: queued_ms(f, 10) for k, f in runs.items()}
    out.update(zero=0.0, timing="queued events")
    return out


def _quant_ablations(x, sx) -> dict:
    """int8_quantize's ablations (QUANT_ABLATIONS) on ``x``: each variant's
    C function called directly (the wrapper's count stays as it is), its
    profiler device time as ``_profiled_ms`` gives it; {label: (ms, how)}."""
    import torch
    from msnets_tpu_torch.ops.cuda import _build
    from msnets_tpu_torch.ops.cuda import int8_quantize as Q
    from msnets_tpu_torch.ops.cuda.int8_conv3d import padded_channels
    n, c, d, h, w = x.shape
    out = torch.empty((n, d, h, w, padded_channels(c)), dtype=torch.int8,
                      device=x.device)
    stream = torch.cuda.current_stream().cuda_stream
    res = {}
    for label, defines in QUANT_ABLATIONS.items():
        fn = Q._bind(_build.load("int8_quantize", defines))
        args = (x.data_ptr(), sx.data_ptr(), int(sx.numel() > 1),
                out.data_ptr(), Q._DTYPES[x.dtype], n, c, d, h, w,
                out.shape[-1], stream)
        assert fn(*args) == 0, label
        res[label] = _profiled_ms({"k": lambda: fn(*args)},
                                  {"k": r"int8_quantize_tile<"})["k"]
    return res


def _bound(t):
    """``t``'s bound from its "bytes" and "ops" (with their rate)."""
    t["bytes_ms"] = t["bytes"] / HBM_BYTES_PER_S * 1e3
    t["ops_ms"] = t["ops"] / t.pop("ops_rate") * 1e3
    t["bound_ms"] = max(t["bytes_ms"], t["ops_ms"])
    t["bound_by"] = "bytes" if t["bytes_ms"] >= t["ops_ms"] else "operations"
    return t


def _int8_kernel(state):
    """(a) int8_absmax, int8_quantize and int8_conv3d, raw and fused,
    against their plain versions: at the edge shapes exactly (raw int32
    equality; fused bfloat16 and float32, int8_quantize and int8_absmax bit
    for bit) against the plain versions computed on the host CPU; then at
    every shape the servers give the conv at full size (where the
    persistent blocks walk many tiles) exactly against the plain versions
    on the card, with each kernel's profiler time, its bound, its plain
    version's time and, for the conv, a bf16 F.conv3d of the same shape as
    a yardstick, for the max-abs the aminmax pass; int8_quantize's
    ablations; and the conv's SASS."""
    import torch
    import torch.nn.functional as F
    from msnets_tpu_torch.models.quant import sample_absmax_reference
    from msnets_tpu_torch.ops.cuda.int8_conv3d import (
        dequantize_reference, int8_conv3d, int8_conv3d_dequant,
        int8_conv3d_reference, pack_weights, padded_channels)
    from msnets_tpu_torch.ops.cuda.int8_quantize import (
        int8_absmax, int8_absmax_reference, int8_quantize,
        int8_quantize_reference)

    def same_bits(a, b):
        return torch.equal(a.cpu().view(torch.int32),
                           b.cpu().view(torch.int32))
    _int8_sass(state)
    rng = np.random.default_rng(20)
    for name, shape, cout, stride, pad in INT8_CASES:
        xq, wq = _int8_operands(shape, cout, rng)
        t0 = time.perf_counter()
        got = int8_conv3d(xq.cuda(), wq.cuda(), stride, pad)
        torch.cuda.synchronize()
        want = int8_conv3d_reference(xq, wq, stride, pad)
        diff = int((got.cpu().long() - want.long()).abs().max())
        assert got.dtype == torch.int32 and torch.equal(got.cpu(), want), name
        xp, wp = _padded(xq), pack_weights(wq)
        fused = []
        for n in (shape[0], 0):
            sx, sk, b = _dequant_operands(n, cout, rng)
            for dt in (torch.bfloat16, torch.float32):
                y = int8_conv3d_dequant(xp.cuda(), wp.cuda(), sx.cuda(),
                                        sk.cuda(), b.cuda(), stride, pad, dt)
                ok = torch.equal(y.cpu(), dequantize_reference(want, sx, sk,
                                                               b, dt))
                fused.append(ok)
                assert ok, (name, n, dt)
            for dt in (torch.bfloat16, torch.float32):
                x = torch.from_numpy(rng.standard_normal(
                    (shape[0], shape[4]) + shape[1:4]).astype(np.float32)
                    * 9.0).to(dt)
                q = int8_quantize(x.cuda(), sx.cuda())
                assert torch.equal(q.cpu(), int8_quantize_reference(x, sx)), (
                    name, n, dt)
                assert same_bits(int8_absmax(x.cuda()),
                                 int8_absmax_reference(x)), (name, n, dt)
        log(f"int8 {name}: x {shape} cout {cout} stride {stride} padding "
            f"{pad} -> {tuple(got.shape)}: raw max |d| {diff}; fused bf16 "
            f"and float32 ({len(fused)} runs, per-sample and scalar scales), "
            f"int8_quantize and int8_absmax bit for bit, against the plain "
            f"versions on the host ({time.perf_counter() - t0:.2f} s)")
    state["max_abs_err"]["int8_conv3d"] = 0.0
    state["max_abs_err"]["int8_quantize"] = 0.0
    state["max_abs_err"]["int8_absmax"] = 0.0
    gen = torch.Generator(device="cuda").manual_seed(20)
    conv, quant, absmax = {}, {}, {}
    for name, shape, cout, stride in INT8_TIMED:
        xq, wq = (t.cuda() for t in _int8_operands(shape, cout, rng))
        wp = pack_weights(wq)
        sx, sk, b = (t.cuda() for t in _dequant_operands(1, cout, rng))
        xb = xq.permute(0, 4, 1, 2, 3).to(torch.bfloat16).contiguous()
        wb = wq.permute(0, 4, 1, 2, 3).to(torch.bfloat16).contiguous()
        raw = lambda: int8_conv3d(xq, wq, stride)                # noqa: E731
        fused = lambda: int8_conv3d_dequant(                     # noqa: E731
            xq, wp, sx, sk, b, stride, (1, 1, 1), torch.bfloat16)
        plain = lambda: dequantize_reference(                    # noqa: E731
            int8_conv3d_reference(xq, wq, stride), sx, sk, b, torch.bfloat16)
        library = lambda: F.conv3d(xb, wb, None, stride, 1)       # noqa: E731
        library()
        acc = int8_conv3d_reference(xq, wq, stride)
        assert torch.equal(raw(), acc), name
        for dt in (torch.bfloat16, torch.float32):
            assert torch.equal(
                int8_conv3d_dequant(xq, wp, sx, sk, b, stride, (1, 1, 1), dt),
                dequantize_reference(acc, sx, sk, b, dt)), (name, dt)
        log(f"int8_conv3d {name} full size: raw exact, fused bf16 and "
            f"float32 bit for bit against the plain version on the card")
        out = acc.numel()
        del acc
        # the conv's input as the server quantizes it: bf16 [N, C, D, H, W]
        n, d, h, w, c = shape
        x = (torch.randn((n, c, d, h, w), device="cuda", generator=gen)
             * 3.0).to(torch.bfloat16)
        qplain = lambda: int8_quantize_reference(x, sx)          # noqa: E731
        assert torch.equal(int8_quantize(x, sx), qplain()), name
        assert same_bits(int8_absmax(x), int8_absmax_reference(x)), name
        ms = _profiled_ms({"fused": fused, "raw": raw},
                          {"fused": r"int8_conv3d_wgmma<.*, 2>\(",
                           "raw": r"int8_conv3d_wgmma<.*, 0>\("})
        t = _bound({"ms": ms["fused"][0], "timing": ms["fused"][1],
                    "ms_raw": ms["raw"][0],
                    "plain_ms": cuda_time_ms(plain, 2),
                    "library_ms": cuda_time_ms(library, 10),
                    "bytes": xq.numel() + wq.numel() + 2 * out,
                    "ops": 2 * out * 27 * shape[-1],
                    "ops_rate": INT8_OPS_PER_S})
        t["raw_bound_ms"] = max((t["bytes"] + 2 * out) / HBM_BYTES_PER_S * 1e3,
                                t["ops_ms"])
        log(f"int8_conv3d {name} x {shape} cout {cout} stride {stride}: "
            f"fused (bf16 out) {t['ms']:.4f} ms/call, raw (int32 out) "
            f"{t['ms_raw']:.4f} ms ({t['timing']}); plain "
            f"(float64 conv3d and the dequantization on the card) "
            f"{t['plain_ms']:.3f} ms; bf16 F.conv3d yardstick "
            f"{t['library_ms']:.4f} ms; fused bound {t['bound_ms']:.4f} ms "
            f"by {t['bound_by']}: bytes {t['bytes_ms']:.4f} ms "
            f"({t['bytes'] / 1e6:.1f} MB), operations {t['ops_ms']:.4f} ms "
            f"({t['ops'] / 1e9:.1f} G at 1,979 TOPS), "
            f"{t['ms'] / t['bound_ms']:.2f}x; raw bound "
            f"{t['raw_bound_ms']:.4f} ms, {t['ms_raw'] / t['raw_bound_ms']:.2f}x"
            f" [{state['smi']}]")
        conv[name] = t
        act = _activation_ms(x, sx)
        q = _bound({"ms": act["quantize"], "timing": act["timing"],
                    "plain_ms": cuda_time_ms(qplain, 5), "library_ms": None,
                    "bytes": 2 * x.numel() + n * d * h * w * padded_channels(c),
                    "ops": x.numel(), "ops_rate": F32_OPS_PER_S})
        q["ablations"] = _quant_ablations(x, sx)
        # the conv's input as the model gives it: after a ReLU
        relu = x.clamp_min(0)
        assert torch.equal(int8_quantize(relu, sx),
                           int8_quantize_reference(relu, sx)), name
        q["relu_ms"] = _profiled_ms({"k": lambda: int8_quantize(relu, sx)},
                                    {"k": r"int8_quantize_tile<"})["k"]
        q["relu_ablations"] = _quant_ablations(relu, sx)
        del relu
        a = _bound({"ms": act["absmax"] + act["zero"],
                    "kernel_ms": act["absmax"], "zero_ms": act["zero"],
                    "timing": act["timing"],
                    "plain_ms": cuda_time_ms(
                        lambda: sample_absmax_reference(x), 10),
                    "library_ms": act["library"],
                    "bytes": 2 * x.numel() + 4 * n,
                    "ops": x.numel(), "ops_rate": F32_OPS_PER_S})
        ablated = {key: ", ".join(f"{k} {v[0]:.4f} ms ({v[1]})"
                                  for k, v in q[key].items())
                   for key in ("ablations", "relu_ablations")}
        log(f"int8_quantize {name} input bf16 {tuple(x.shape)}: bit for bit "
            f"against the plain version on the card; {q['ms']:.4f} ms/call "
            f"({q['timing']}), plain {q['plain_ms']:.4f} ms, bound "
            f"{q['bound_ms']:.4f} ms by {q['bound_by']} "
            f"({q['bytes'] / 1e6:.1f} MB), {q['ms'] / q['bound_ms']:.2f}x; "
            f"ablations: {ablated['ablations']}; after a ReLU (half zeros, "
            f"bit for bit): {q['relu_ms'][0]:.4f} ms ({q['relu_ms'][1]}), "
            f"{q['relu_ms'][0] / q['bound_ms']:.2f}x, ablations: "
            f"{ablated['relu_ablations']} [{state['smi']}]")
        log(f"int8_absmax {name} input bf16 {tuple(x.shape)}: bit for bit "
            f"against the plain version on the card; {a['ms']:.4f} ms/call "
            f"({a['timing']}: kernel {a['kernel_ms']:.4f}, zeroing memset "
            f"{a['zero_ms']:.4f}), plain (aminmax, maximum, abs) "
            f"{a['plain_ms']:.4f} ms, library (the aminmax pass, same "
            f"session) {a['library_ms']:.4f} ms, bound {a['bound_ms']:.4f} "
            f"ms by {a['bound_by']} ({a['bytes'] / 1e6:.1f} MB), "
            f"{a['ms'] / a['bound_ms']:.2f}x; with int8_quantize "
            f"{a['ms'] + q['ms']:.4f} ms against both bounds "
            f"{a['bound_ms'] + q['bound_ms']:.4f} [{state['smi']}]")
        quant[name], absmax[name] = q, a
        del x, xb, wb, xq, wq
        torch.cuda.empty_cache()
    state["int8_conv3d"] = dict(conv["conv3dbn_2"], by_conv=conv)
    state["int8_quantize"] = dict(quant["conv3dbn_2"], by_conv=quant)
    state["int8_absmax"] = dict(absmax["conv3dbn_2"], by_conv=absmax)


def _serve_quant_cfg(**model):
    """Config() with the model fields ``model``."""
    from msnets_tpu_torch import Config
    cfg = Config()
    return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model,
                                                              **model))


def _quant_server(cfg, sd, stats=None, warm=True):
    from msnets_tpu_torch import StereoServer
    server = StereoServer(cfg, sd, quant_stats=stats)
    if warm:
        server.warmup([(256, 512), (375, 1242)])
    return server


def _quant_servers(state):
    """(b) StereoServer at Config() widths (F=32, max_disp 192, bf16) in
    each int8 configuration: 3 requests at 256x512 and one at 375x1242,
    the launches of each kernel, the mean and p99 |d disparity| against the
    float32 server (TF32 off); then, in turns with the bf16 servers
    (forward order, then reverse), ms/pair of predict and ms of the model
    alone on one 256x512 feature volume, and ms/pair at 375x1242."""
    import gc
    import torch
    from msnets_tpu_torch import StereoServer
    from msnets_tpu_torch.runtime import fp32_reference
    requests = [textured_pair(256, 512, 24 + 8 * i, 90 + i) for i in range(3)]
    requests.append(textured_pair(375, 1242, 40, 93))
    l, r = textured_pair(256, 512, 32, 12)
    kl, kr = textured_pair(375, 1242, 40, 14)
    ref, sds, servers, total = {}, {}, {}, _want()
    for model in ("MS-GCNet", "MS-PSMNet"):
        cfg = _serve_quant_cfg(name=model)
        sds[model] = sd = _random_state_dict(cfg, 0)
        with fp32_reference():
            ref[model] = StereoServer(dataclasses.replace(
                cfg, model=dataclasses.replace(
                    cfg.model, compute_dtype="float32")), sd).predict(l, r)
        servers[model] = server = _quant_server(cfg, sd)
        diff = np.abs(server.predict(l, r) - ref[model])
        log(f"serve_quant bf16 {model} (no int8): |d disparity| against "
            f"float32 mean {diff.mean():.4f} px, p99 "
            f"{np.percentile(diff, 99):.4f} px")
        gc.collect()
        torch.cuda.empty_cache()
    for key, (model, scope, mode, per) in QUANT_SERVERS.items():
        cfg = _serve_quant_cfg(name=model, quant_eval=True,
                               quant_mode=mode, quant_scope=scope)
        stats = None
        if mode == "static":
            # one "calib" forward of a frame of each bucket, as the
            # Evaluator calibrates each new shape
            calib = _quant_server(dataclasses.replace(
                cfg, model=dataclasses.replace(cfg.model,
                                               quant_mode="calib")),
                sds[model], warm=False)
            for pair in (textured_pair(256, 512, 28, 95),
                         textured_pair(375, 1242, 36, 96)):
                calib.predict(*pair)
            stats = calib.quant_stats(recorded=True)
            log(f"serve_quant {key}: calibrated absmax {stats}")
            del calib
        servers[key] = server = _quant_server(cfg, sds[model], stats)
        _reset_counts()                             # main path starts here
        outs = [server.predict(a, b) for a, b in requests]
        launches = _counts()                        # main path ends here
        for (a, _), d in zip(requests, outs):
            _check_disp(d, a.shape, cfg.model.max_disp)
        n_int8 = 3 * per[0] + per[1]
        want = _want(census_aml=len(requests), int8_conv3d=n_int8,
                     int8_absmax=n_int8 if mode == "dynamic" else 0,
                     head=len(requests) if model == "MS-GCNet" else 0)
        diff = np.abs(server.predict(l, r) - ref[model])
        m = cfg.model
        log(f"serve_quant {key} ({model}, quant_scope {scope}, {mode}, "
            f"{m.compute_dtype}, F={m.base_filters}, max_disp {m.max_disp}): "
            f"launches {launches} for 3 requests at 256x512 and one at "
            f"375x1242 (int8_conv3d {per[0]} and {per[1]} a request); "
            f"|d disparity| against float32 (TF32 off) mean "
            f"{diff.mean():.4f} px, p99 {np.percentile(diff, 99):.4f} px, "
            f"max {diff.max():.4f} px")
        assert launches == want, (key, launches, want)
        assert diff.mean() < PRECISION_MEAN_PX, (key, diff.mean())
        total = {k: v + launches[k] for k, v in total.items()}
        state[f"serve_quant_{key}"] = {
            "mean_px": float(diff.mean()),
            "p99_px": float(np.percentile(diff, 99))}
    il, ir = (torch.from_numpy(x).cuda() for x in (l, r))
    _profile("serve_quant gcnet_all 256x512 forward",
             lambda: servers["gcnet_all"].forward(il, ir))
    times = {k: [] for k in servers}
    order = list(servers)
    with torch.inference_mode():
        for turn in (order, order[::-1]):
            for key in turn:
                server = servers[key]
                feats = server.features(il, ir)[None]
                times[key].append((
                    cuda_time_ms(lambda: server.predict(l, r), 10),
                    cuda_time_ms(lambda: server.model(feats), 10),
                    cuda_time_ms(lambda: server.predict(kl, kr), 3)))
    for key, t in times.items():
        pred, model_ms, kitti = (sorted(x) for x in zip(*t))
        base = key if key in sds else QUANT_SERVERS[key][0]
        log(f"serve_quant {key}: predict {pred[0]:.3f}-{pred[1]:.3f} ms/pair "
            f"at 256x512, the model alone {model_ms[0]:.3f}-"
            f"{model_ms[1]:.3f} ms, predict {kitti[0]:.3f}-{kitti[1]:.3f} "
            f"ms/pair at 375x1242 (two turns, against the bf16 {base} "
            f"server's in the same turns) [{state['smi']}]")
        state.setdefault(f"serve_quant_{key}", {}).update(
            predict_ms=pred, model_ms=model_ms, kitti_ms=kitti)
    extra = _psmnet_full_outer(state, servers, sds)
    total = {k: v + extra[k] for k, v in total.items()}
    servers.clear()
    gc.collect()
    torch.cuda.empty_cache()
    return total


# the volume of a 375x1242 request (its 384x1248 bucket at max_disp 192)
KITTI_VOLUME = (1, 8, 96, 192, 624)


def _psmnet_full_outer(state, servers, sds):
    """One dynamic MS-PSMNet request at 375x1242 with packed_eval_outer=False
    (dres3's and dres4's conv1 read the full layout and run int8 past the
    stride-2 gate): the int8 convs models.quant_convs gives, and the
    disparity against the packed_eval_outer=True server's."""
    from msnets_tpu_torch.models import quant_convs
    cfg = _serve_quant_cfg(name="MS-PSMNet", quant_eval=True,
                           packed_eval_outer=False)
    n_int8 = sum(quant_convs("MS-PSMNet", cfg.model, KITTI_VOLUME).values())
    server = _quant_server(cfg, sds["MS-PSMNet"], warm=False)
    kl, kr = textured_pair(375, 1242, 40, 14)
    server.predict(kl, kr)                      # warm the bucket
    _reset_counts()                             # main path starts here
    d = server.predict(kl, kr)
    launches = _counts()                        # main path ends here
    _check_disp(d, kl.shape, cfg.model.max_disp)
    diff = np.abs(d - servers["psmnet"].predict(kl, kr))
    log(f"serve_quant psmnet packed_eval_outer=False: one request at "
        f"375x1242, launches {launches} (int8 convs {n_int8} by "
        f"quant_convs); |d disparity| against the packed_eval_outer=True "
        f"server mean {diff.mean():.4g} px, max {diff.max():.4g} px")
    assert launches == _want(census_aml=1, int8_conv3d=n_int8,
                             int8_absmax=n_int8), launches
    assert diff.mean() < PRECISION_MEAN_PX, diff.mean()
    state["serve_quant_psmnet_full_outer"] = {"mean_px": float(diff.mean())}
    return launches


def _quant_cli(state):
    """(c) The CLI's --mode test --quant_eval 1 --quant_mode static on phase
    15's grey tree and checkpoint: one calibration forward (int8_absmax once
    a flagged conv), then the frames in int8 (375x1242: 3 int8 convs
    each); finite scores."""
    from msnets_tpu_torch.config import ModelConfig
    from msnets_tpu_torch.experiments.cross_domain import _scores
    from msnets_tpu_torch.models import quant_convs
    flagged = len(quant_convs("MS-GCNet", ModelConfig(quant_eval=True),
                              KITTI_VOLUME))
    c = state.pop("cli")
    _reset_counts()                                 # main path starts here
    t0 = time.perf_counter()
    scores = _scores(_cli(["--mode=test", "--quant_eval=1",
                           "--quant_mode=static", f"--resume={c['ckpt']}",
                           f"--resultDir={CLI_ROOT / 'results_int8'}"]
                          + c["data"]))
    secs = time.perf_counter() - t0
    launches = _counts()                            # main path ends here
    log(f"serve_quant cli: --mode test --quant_eval 1 --quant_mode static, "
        f"{CLI_FRAMES} frames of 375x1242: {secs:.2f} s, AVG EPE "
        f"{scores[0]}, bad-3 {scores[1]} (bf16 without int8: "
        f"{c['scores'][0]}, {c['scores'][1]}); launches {launches} "
        f"(the calibration forward's {flagged} flagged convs) "
        f"[{state['smi']}]")
    assert all(np.isfinite(v) for v in scores), scores
    assert launches == _want(census_aml=CLI_FRAMES + 1,
                             int8_conv3d=3 * CLI_FRAMES,
                             int8_absmax=flagged,
                             head=CLI_FRAMES + 1), launches
    shutil.rmtree(CLI_ROOT, ignore_errors=True)
    return launches


def phase_serve_quant(state):
    """int8 eval (models/quant.py) with its kernel: (a) the kernel, (b) the
    servers, (c) the CLI's static test mode."""
    _int8_kernel(state)
    served = _quant_servers(state)
    cli = _quant_cli(state)
    state["launches_by_path"]["serve_quant"] = {
        k: v + cli[k] for k, v in served.items()}


def main() -> int:
    import torch
    if len(sys.argv) == 5 and sys.argv[1] == "--train-dp-rank":
        return dp_rank(int(sys.argv[2]), sys.argv[3], sys.argv[4])
    if len(sys.argv) == 6 and sys.argv[1] == "--serve-mesh-rank":
        return serve_mesh_rank(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
                               sys.argv[5])
    if len(sys.argv) == 6 and sys.argv[1] == "--train-mesh-rank":
        return train_mesh_rank(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
                               sys.argv[5])
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
              phase_serve_psmnet, phase_train_psmnet, phase_cli,
              phase_train_dp, phase_serve_mesh, phase_train_mesh, phase_xdom,
              phase_serve_quant]
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
        # no Pallas kernel: the XLA matchers, AMLs and assembly
        "matchers_aml": ("msnets_tpu_torch/csrc/matchers_aml.cu",
                         "msnets_tpu/ops/matchers.py (ncc_nister, zsad, "
                         "sadsob, extract_aml; XLA), "
                         "msnets_tpu/ops/features.py (_normalize_stack)"),
        # no Pallas kernels: the XLA int8 convolutions of the quantized
        # lowerings, and _quant_act, which quantizes their inputs
        "int8_conv3d": ("msnets_tpu_torch/csrc/int8_conv3d.cu",
                        "msnets_tpu/models/layers.py:218-272, 333-381, "
                        "483-540 (XLA int8 convolutions)"),
        "int8_quantize": ("msnets_tpu_torch/csrc/int8_quantize.cu",
                          "msnets_tpu/models/layers.py:89 (_quant_act, "
                          "XLA)"),
        "int8_absmax": ("msnets_tpu_torch/csrc/int8_quantize.cu",
                        "msnets_tpu/models/layers.py:111 (_quant_act's "
                        "max pass, XLA), 859 (the calibration's)"),
        # no Pallas kernel: SubpixelSoftArgminHead's XLA math
        "subpixel_soft_argmin": ("msnets_tpu_torch/csrc/"
                                 "subpixel_soft_argmin.cu",
                                 "msnets_tpu/models/layers.py:1414 "
                                 "(SubpixelSoftArgminHead, XLA)"),
    }
    kernels = []
    for name, (source, replaces) in sources.items():
        t = state[name]
        # each main path's launches, counted from 0 just before it
        by_path = {path: n[name]
                   for path, n in state["launches_by_path"].items()
                   if name in n}
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": state["max_abs_err"][name], "ms": t["ms"],
            "kernel_ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t.get("library_ms"),
        })
    log(state["smi"])
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
