"""Readings of a cell's correctness check over many seeds, from which its
limits are set (``checks/<cell>.json``): the program's, its control's
(the port's int8 path for serving, the reference in fp8 for training) and
each planted fault's, all in one process, or in one process a card for a
cell on several cards (``ranks.py``; rank 0 writes). The benchmark's own
runs never run this.

    python3 benchmark/calibrate.py --workload gcnet-kitti-online \
        --seeds 11,12,13 --variant program --seconds 3 --out readings.jsonl

``--variant`` is ``program``, ``control`` or ``fault:<name>``
(``faults.py``); each run appends one JSON line of its readings.
"""
import argparse
import json
import os
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
RUN_S = 120.0           # each run's allowance past the window, on ranks


def runs(cell, args, device, mesh=None):
    """Every variant at every seed; the lines of rank 0 (or of the one
    process) are written and printed."""
    from benchmark import harness
    seeds = [int(s) for s in args.seeds.split(",")]
    for variant in args.variant or ["program"]:
        for seed in seeds:
            t = time.time()
            r = harness.run_cell(cell, seed, args.seconds, False, device, t,
                                 None if variant == "program" else variant,
                                 mesh=mesh)
            if r is None:
                continue
            line = {"workload": args.workload, "variant": variant,
                    "seed": seed, "readings": r["readings"],
                    "correct": r["correct"], "metrics": r["metrics"],
                    "seconds": time.time() - t}
            with open(args.out, "a") as out:
                out.write(json.dumps(line) + "\n")
            print(json.dumps(line), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--variant", action="append", default=None)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out", required=True)
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch
    from benchmark import harness, ranks
    cell = harness.load_cell(args.workload)
    if args.rank is not None:
        device = torch.device("cuda", args.rank)
        try:
            runs(cell, args, device, ranks.join(cell, device))
            code = 0
        except BaseException:
            traceback.print_exc()
            code = 1
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(code)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"calibrate.py needs {cell.chips} CUDA device(s)",
              file=sys.stderr)
        return 1
    if cell.chips == 1:
        runs(cell, args, "cuda")
        return 0
    argv = list(sys.argv[1:] if argv is None else argv)
    n = len(args.seeds.split(",")) * len(args.variant or ["program"])
    done = ranks.launch(
        [[sys.executable, str(Path(__file__).resolve()), *argv, "--rank",
          str(i)] for i in range(cell.chips)], args.seconds,
        after_s=n * (args.seconds + RUN_S))
    for i, lines in enumerate(done.err):
        sys.stderr.writelines(f"[rank {i}] {s}" for s in lines)
    sys.stdout.writelines(done.out[0])
    if done.failure is not None:
        print(f"calibration failed: {done.failure}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
