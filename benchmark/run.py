"""Run one cell of the port's benchmark on this machine's GPUs.

    python3 benchmark/run.py --workload gcnet-kitti-online --seed 7 \
        --seconds 51 --trace 0

From the root of a checkout. With ``--trace 0`` the last line of standard
output is the cell's end-to-end metrics, with ``--trace 1`` its per-layer
metrics (and the device's busy time and a breakdown), each as one JSON
object; the numbers the correctness check compared, each beside its
limit, are the last lines of standard error. Without a GPU, or with fewer
than the cell asks for, it exits with code 1 and prints no result.
"""
import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cache = ROOT / "build" / "benchmark_cache"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    sys.path.insert(0, str(ROOT))
    import torch
    from benchmark import harness
    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); "
              f"torch.cuda.is_available()={torch.cuda.is_available()}, "
              f"device_count={torch.cuda.device_count()}", file=sys.stderr)
        return 1
    result = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                              "cuda", T_START)
    result.pop("readings")
    bad = harness.forbidden_modules()
    if bad:
        print(f"loaded modules {bad}: the benchmark runs without them",
              file=sys.stderr)
        return 1
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
