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
