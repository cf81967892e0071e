"""A cell on several cards at a tiny size on the CPU: 2 gloo ranks of
``gcnet-train-sf-dp4`` (``bench_port_tiny``), started, watched and printed
by ``run.py``'s launcher (``run.run_ranks``), each rank through
``run.rank_main`` (``bench_port_rank.py``). A sound run is correct and
prints one result; the check refuses each fault the cell can have and the
control; a rank that dies or hangs makes the launch fail within its
deadline, with no result printed."""
import argparse
import json
import os
import re
import time
from pathlib import Path

import pytest

from bench_port_tiny import SEED
from benchmark import run

HELPER = Path(__file__).with_name("bench_port_rank.py")
CELL = "gcnet-train-sf-dp4"


@pytest.fixture(autouse=True)
def _few_threads(monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "2")


def launch(capsys, *extra, trace=0, seconds=0.5, seed=SEED, **limits):
    args = argparse.Namespace(workload=CELL, seed=seed, seconds=seconds,
                              trace=trace, t_start=time.time())
    t0 = time.monotonic()
    rc = run.run_ranks(run.rank_commands(args, 2, HELPER, extra), seconds,
                       **limits)
    out, err = capsys.readouterr()
    return rc, out, err, time.monotonic() - t0


def readings(err):
    return {m[1]: float(m[2]) for m in
            re.finditer(r"^reading (\w+) = ([-+.e0-9]+)$", err, re.M)}


@pytest.mark.parametrize("trace", [0, 1])
def test_a_sound_run_on_two_ranks_is_correct(capsys, trace):
    rc, out, err, _ = launch(capsys, trace=trace)
    assert rc == 0, err
    lines = out.strip().splitlines()
    assert len(lines) == 1
    r = json.loads(lines[0])
    assert r["correct"], r["checks"]
    assert r["device"]["count"] == 2 and r["attempted"] >= 1
    assert list(r)[-1] == "checks"
    assert err.rstrip().splitlines()[-1].startswith("check ")
    assert "[rank 1] window:" in err
    if trace:
        assert {"device.idle_pct.dp4", "step.mfu_pct.dp4"} <= set(r["metrics"])
        assert r["device"]["window_s"] > 0
    else:
        assert set(r["metrics"]) == {"train_step_ms", "setup_s"}


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "no_exchange",
                                   "one_rank_left_out"])
def test_each_fault_is_refused(capsys, fault):
    rc, out, err, _ = launch(capsys, "--variant", f"fault:{fault}")
    assert rc == 0, err
    r = json.loads(out.strip().splitlines()[-1])
    assert not r["correct"]
    if fault == "unchanged":
        assert readings(err)["change_gap"] == pytest.approx(1.0)


def test_the_control_stands_apart(capsys):
    """As ``gcnet-train-sf``'s: the fp8 control's first-step disparity gap
    reads 3 times the program's or more at this size."""
    sound = readings(launch(capsys)[2])["disp_mean_abs_px"]
    rc, out, err, _ = launch(capsys, "--variant", "control")
    assert rc == 0, err
    assert readings(err)["disp_mean_abs_px"] >= 3 * sound


@pytest.mark.parametrize("how", ["kill", "hang"])
def test_a_lost_rank_fails_the_launch_in_time(capsys, how):
    """Rank 1 dies (SIGKILL) or hangs where its window starts, while rank 0
    waits for it in the step's collectives: the launcher kills both and
    exits with code 1, without a result, within its deadline (set-up plus
    the window plus ``after_s``)."""
    rc, out, err, took = launch(capsys, f"--{how}-rank", "1",
                                setup_limit_s=120, after_s=5)
    assert rc == 1 and out == ""
    assert "every rank was stopped" in err
    if how == "kill":
        assert "rank 1 exited with code -9" in err
    else:
        assert "the deadline passed" in err
    assert took < 120
    assert not [p for p in os.popen("ps -eo args").read().splitlines()
                if str(HELPER) in p]
