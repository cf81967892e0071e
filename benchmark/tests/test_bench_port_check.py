"""The correctness check refuses the faults a cell can have, planted under
the timed path, and its control, with the committed limits; a sound run of
the same tiny size passes them. The run skips the look for a card."""
import pytest

from bench_port_tiny import run

SERVING = ("gcnet-kitti-online", "psmnet-kitti-eval")


@pytest.mark.parametrize("name", SERVING + ("gcnet-train-sf",))
def test_a_sound_run_is_correct(name):
    r = run(name)
    assert r["correct"], r["checks"]
    assert list(r)[-2:] == ["checks", "readings"]


@pytest.mark.parametrize("name", SERVING)
def test_an_altered_answer_is_refused(name):
    assert not run(name, "fault:altered_answer")["correct"]


@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
def test_train_faults_are_refused(fault):
    r = run("gcnet-train-sf", f"fault:{fault}")
    assert not r["correct"]
    if fault == "unchanged":
        assert r["readings"]["change_gap"] == pytest.approx(1.0)


@pytest.mark.parametrize("name", SERVING)
def test_the_control_is_refused(name):
    assert not run(name, "control")["correct"]


def test_the_train_control_stands_apart():
    """The fp8 control of the train cell. Its limit is set at the cell's
    size (max_disp 192), where the gap reads 0.19-0.29 px against the
    program's 0.03-0.05; at this size both gaps are smaller, and the
    control still reads 3 times the program or more."""
    sound = run("gcnet-train-sf")["readings"]["disp_mean_abs_px"]
    control = run("gcnet-train-sf", "control")["readings"]["disp_mean_abs_px"]
    assert control >= 3 * sound


def _ahead_sut():
    from bench_port_tiny import SEED, harness, tiny
    c = tiny("gcnet-train-sf")
    c.mix["dispatch_ahead_s"] = 0.05
    return c, harness.TrainSUT(c, SEED, "cpu")


def test_the_dispatch_ahead_feed_gives_the_check_the_same_readings():
    """A mix with ``dispatch_ahead_s`` feeds the checked steps through the
    window's own feed; the check reads the same numbers as the plain one."""
    plain = run("gcnet-train-sf")["readings"]
    c, _ = _ahead_sut()
    ahead = run("gcnet-train-sf", cell=c)
    assert ahead["correct"], ahead["checks"]
    assert ahead["readings"] == plain


def test_a_window_dispatched_ahead_reads_every_step_it_sent():
    c, sut = _ahead_sut()
    sut.warmup()
    assert sut.next == c.mix["checked_steps"] + sut.PROBE_STEPS
    fn, calls = sut.fn, []

    def nan_on_the_second(*a):
        metrics, disp = fn(*a)
        calls.append(1)
        if len(calls) == 2:
            metrics = dict(metrics, loss=metrics["loss"] * float("nan"))
        return metrics, disp

    sut.fn = nan_on_the_second
    w = sut._ahead(sut.next, 5, None)
    assert (w["attempted"], w["failed"], len(calls)) == (5, 1, 5)
    assert w["next"] == sut.next + 5 and w["seconds"] > 0
    w = sut.window(0.2)
    assert w["attempted"] >= 1 and w["failed"] == 0
