"""Readings of a cell's correctness check over many seeds, from which its
limits are set (``checks/<cell>.json``): the program's, its control's
(the port's int8 path for serving, the reference in fp8 for training) and
each planted fault's, all in one process. The benchmark's own runs never
run this.

    python3 benchmark/calibrate.py --workload gcnet-kitti-online \
        --seeds 11,12,13 --variant program --seconds 3 --out readings.jsonl

``--variant`` is ``program``, ``control`` or ``fault:<name>``
(``faults.py``); each run appends one JSON line of its readings.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--variant", action="append", default=None)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch
    from benchmark import harness
    if not torch.cuda.is_available():
        print("calibrate.py needs a CUDA device", file=sys.stderr)
        return 1
    seeds = [int(s) for s in args.seeds.split(",")]
    with open(args.out, "a") as out:
        for variant in args.variant or ["program"]:
            for seed in seeds:
                cell = harness.load_cell(args.workload)
                t = time.time()
                r = harness.run_cell(cell, seed, args.seconds, False, "cuda",
                                     t, None if variant == "program"
                                     else variant)
                line = {"workload": args.workload, "variant": variant,
                        "seed": seed, "readings": r["readings"],
                        "correct": r["correct"], "metrics": r["metrics"],
                        "seconds": time.time() - t}
                out.write(json.dumps(line) + "\n")
                out.flush()
                print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
