"""Run one cell of the port's benchmark on this machine's GPUs.

    python3 benchmark/run.py --workload gcnet-kitti-online --seed 7 \
        --seconds 51 --trace 0

From the root of a checkout. With ``--trace 0`` the last line of standard
output is the cell's end-to-end metrics, with ``--trace 1`` its per-layer
metrics (and the device's busy time and a breakdown), each as one JSON
object; the numbers the correctness check compared, each beside its
limit, are the last lines of standard error. Without a GPU, or with fewer
than the cell asks for, it exits with code 1 and prints no result.

A cell on several cards runs one rank process a card (``ranks.py``): this
process starts them (this script again, with ``--rank``), waits for them
against a deadline, and prints the other ranks' standard error, then rank
0's, then rank 0's result; if a rank fails or the deadline passes, it
kills them all and exits with code 1.
"""
import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def emit(result: dict) -> int:
    """Print the result line (its readings dropped); 1 without it when a
    forbidden module is loaded."""
    from benchmark import harness
    result.pop("readings")
    bad = harness.forbidden_modules()
    if bad:
        print(f"loaded modules {bad}: the benchmark runs without them",
              file=sys.stderr)
        return 1
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


def rank_main(cell, args, device, variant=None) -> None:
    """One rank of a cell on several cards; rank 0 prints the result. The
    process ends here, at once, whatever happened: a failure reaches the
    launcher without waiting on the other ranks, and no rank waits on
    another to tear the group down."""
    from benchmark import harness, ranks
    try:
        mesh = ranks.join(cell, device)
        result = harness.run_cell(cell, args.seed, args.seconds,
                                  bool(args.trace), device, args.t_start,
                                  variant, mesh=mesh)
        code = 0 if result is None else emit(result)
    except BaseException:
        traceback.print_exc()
        code = 1
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(code)


def rank_commands(args, world: int, script=None, extra=()) -> list:
    """The command line of each rank: ``script`` (this one) with the run's
    arguments, its ``--rank`` and this process's start time."""
    return [[sys.executable, str(script or Path(__file__).resolve()),
             "--workload", args.workload, "--seed", str(args.seed),
             "--seconds", repr(args.seconds), "--trace", str(args.trace),
             "--rank", str(i), "--t-start", repr(args.t_start), *extra]
            for i in range(world)]


def run_ranks(commands, seconds: float, **limits) -> int:
    """Launch the ranks and print what they printed (module docstring)."""
    from benchmark import harness, ranks
    done = ranks.launch(commands, seconds, **limits)
    world = len(commands)
    for i in list(range(1, world)) + [0]:
        tag = f"[rank {i}] " if i else ""
        lines = [tag + s for s in done.out[i]] if i else []
        sys.stderr.writelines(lines + [tag + s for s in done.err[i]])
    if done.failure is None and not any(s.strip() for s in done.out[0]):
        done.failure = "rank 0 printed no result"
    bad = harness.forbidden_modules()
    if bad:
        done.failure = f"loaded modules {bad}: the benchmark runs without them"
    if done.failure is not None:
        print(f"the run failed: {done.failure}; every rank was stopped",
              file=sys.stderr, flush=True)
        return 1
    sys.stderr.flush()
    sys.stdout.writelines(done.out[0])
    sys.stdout.flush()
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--t-start", type=float, default=T_START,
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    cache = ROOT / "build" / "benchmark_cache"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    sys.path.insert(0, str(ROOT))
    import torch
    from benchmark import harness
    cell = harness.load_cell(args.workload)
    if args.rank is not None:
        return rank_main(cell, args, torch.device("cuda", args.rank))
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); "
              f"torch.cuda.is_available()={torch.cuda.is_available()}, "
              f"device_count={torch.cuda.device_count()}", file=sys.stderr)
        return 1
    if cell.chips > 1:
        return run_ranks(rank_commands(args, cell.chips), args.seconds)
    return emit(harness.run_cell(cell, args.seed, args.seconds,
                                 bool(args.trace), "cuda", T_START))


if __name__ == "__main__":
    sys.exit(main())
