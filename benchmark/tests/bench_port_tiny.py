"""Tiny versions of the benchmark's cells for the CPU tests: the same
files, the same code paths, widths and frames cut so that a run takes
seconds on a CPU (serving max_disp 32, F 4, 64x128 frames; training
max_disp 64, F 8, 64x128 crops: at F 4 the bf16 gradients of the first
BN leaves stray past the limits set at F 32). A cell on several cards
runs on 2 ranks (gloo, ``bench_port_rank.py``), 2 samples a rank."""
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import harness  # noqa: E402

CELLS = ("gcnet-kitti-online", "psmnet-kitti-eval", "gcnet-train-sf")
RANKED = ("gcnet-train-sf-dp4",)
SEED = 2**31 + 11


def tiny(name: str) -> harness.Cell:
    c = harness.load_cell(name)
    if c.kind == "train":
        c.config["model"].update(max_disp=64, base_filters=8)
        c.mix.update(crop=[64, 128], pool=4, disparity_px=[0, 62])
        if "mesh" in c.mix:
            c.mix.update(mesh=[2, 1, 1], batch=4)
            c.chips = 2
    else:
        c.config["model"].update(max_disp=32, base_filters=4)
        c.mix.update(frame=[64, 128], sizes=[[64, 128, 3], [62, 126, 1]],
                     pool=3, sample=2, disparity_px=[0, 30])
    return c


def run(name: str, variant=None, trace=False, seconds=0.5, cell=None,
        seed=SEED):
    c = cell or tiny(name)
    return harness.run_cell(c, seed, seconds, trace, "cpu", time.time(),
                            variant, profile_s=0.3)
