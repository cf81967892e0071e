"""One rank of a tiny cell on several cards (``bench_port_tiny``: 2 ranks)
on the CPU over gloo, through ``run.py``'s rank code; the tests start the
ranks with ``run.run_ranks``:

    python bench_port_rank.py --workload gcnet-train-sf-dp4 --seed S \\
        --seconds 0.5 --trace 0 --rank I --t-start T \\
        [--variant fault:half_batch] [--kill-rank R | --hang-rank R]

``--variant`` plants a fault or runs the control (``harness.run_cell``);
``--kill-rank`` and ``--hang-rank`` make that rank die (SIGKILL) or hang
where its window would start.
"""
import argparse
import os
import signal
import time

from bench_port_tiny import harness, tiny

from benchmark import run


def main() -> None:
    ap = argparse.ArgumentParser()
    for k in ("--workload", "--variant"):
        ap.add_argument(k)
    for k in ("--seed", "--trace", "--rank", "--kill-rank", "--hang-rank"):
        ap.add_argument(k, type=int)
    for k in ("--seconds", "--t-start"):
        ap.add_argument(k, type=float)
    args = ap.parse_args()
    if args.rank in (args.kill_rank, args.hang_rank):
        def stop(self, *a, **k):
            if args.rank == args.kill_rank:
                os.kill(os.getpid(), signal.SIGKILL)
            time.sleep(3600)

        harness.TrainSUT.window = stop
    run.rank_main(tiny(args.workload), args, "cpu", args.variant)


if __name__ == "__main__":
    main()
