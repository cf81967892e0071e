"""The GC-Net cell, ``gcnet-kendall-train-sf``, at a tiny size on the CPU
(a tower 8 wide with its 8 blocks, base_filters 8, max_disp 32, 64x128 RGB
crops, batch 4): a sound run passes the committed limits, the planted
faults and the fp8 control are refused or stand apart, the FLOP counts
are the configuration's sizing, and the reference system loads nothing
of the port."""
import json
import math
import subprocess
import sys

import pytest

from bench_port_tiny import ROOT, SEED, harness, run
from benchmark.counts import flops

CELL = "gcnet-kendall-train-sf"


def tiny() -> harness.Cell:
    c = harness.load_cell(CELL)
    c.config["model"].update(max_disp=32, in_channels=16, base_filters=8)
    c.mix.update(crop=[64, 128], pool=4, disparity_px=[0, 30],
                 dispatch_ahead_s=0.05)
    return c


def test_a_sound_run_is_correct():
    """Correct under the committed limits. Of the leaves at most deconv5's
    bias, nought under the softmax but for rounding, stays out of the
    change: at this size it reads 1.06e-3 of the median leaf's gradient,
    at the threshold of 1e-3."""
    r = run(CELL, cell=tiny())
    assert r["correct"], r["checks"]
    assert r["readings"]["leaves_left_out"] <= 1.0


def test_a_step_that_changes_nothing_is_refused():
    r = run(CELL, "fault:unchanged", cell=tiny())
    assert not r["correct"]
    assert r["readings"]["change_gap"] == pytest.approx(1.0)


def test_half_the_batch_is_refused():
    """The step on the first 2 of 4 crops: its disparity has 2 rows where
    the reference's has 4, which the check's gap cannot broadcast, so the
    run fails before it gives a result; a check that compared would refuse
    it too."""
    try:
        r = run(CELL, "fault:half_batch", cell=tiny())
    except RuntimeError as e:
        assert "size of tensor" in str(e)
    else:
        assert not r["correct"]


def test_the_control_stands_apart():
    """The fp8 control at this size: refused by the committed limits, or
    its disparity at least 3 times as far from the reference as the
    program's. The disparity is what refuses it at full size too (4.4
    times the program's widest reading there); through the tower's 8
    residual blocks its gradients sit within 2 times the bf16 program's
    at every tiny size tried (tower 8 to 32 wide)."""
    sound = run(CELL, cell=tiny())["readings"]
    control = run(CELL, "control", cell=tiny())
    assert (not control["correct"]
            or control["readings"]["disp_mean_abs_px"]
            >= 3 * sound["disp_mean_abs_px"])


def test_the_traced_run_reads_the_cells_metrics():
    """On the CPU the profiler sees no device time: the span metrics of the
    new spans are left out of the line, the rest are read."""
    r = run(CELL, trace=True, cell=tiny())
    names = set(r["metrics"])
    assert {"features.busy_ms.train", "features.idle_ms.train",
            "regularizer.busy_ms.train", "regularizer.idle_ms.train",
            "trainer.busy_ms.train", "trainer.idle_ms.train",
            "features.ms.train", "device.idle_pct.train",
            "step.mfu_pct.train"} <= names
    assert all(math.isfinite(v["value"]) for v in r["metrics"].values())


def test_flops_of_a_step():
    """10.32 TFLOP a step of 4 crops at 256x512: 0.860 TFLOP a crop's
    forward, 40.5% of it the 64-channel entry conv and 2.4% the tower,
    whose first conv (both views) needs no input gradient."""
    cell = harness.load_cell(CELL)
    assert harness.flops_per_item(cell) == 10318793146368.0
    macs = flops.train_macs(cell.config, 1, (256, 512), 3)
    total = sum(m for _, m, _ in macs)
    assert 2 * total == 860004286464
    share = {n: m / total for n, m, _ in macs}
    assert share["conv3dbn_1.0"] == pytest.approx(0.4045, abs=1e-4)
    tower = sum(m for n, m, _ in macs if n.startswith("unary."))
    assert tower / total == pytest.approx(0.0242, abs=1e-4)
    assert [g for n, _, g in macs if n == "unary.conv1.0"] == [False]


def test_the_reference_loads_nothing_of_the_port():
    code = ("import json, sys; sys.path.insert(0, {root!r}); "
            "import benchmark.reference.gcnet_kendall; "
            "print(json.dumps(sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'msnets_tpu', "
            "'msnets_tpu_torch'))))").format(root=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
