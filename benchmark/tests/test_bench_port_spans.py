"""The span attribution (``spans.py``) on a hand-made trace, against the
harness's own busy and window time of the same events; the new per-layer
metrics on tiny traced runs; and a program without spans, whose run
leaves them out and does not fail."""
import contextlib
import json

import pytest

from bench_port_tiny import harness, run
from benchmark import spans

US = 1e-6


def _span(name, a, b, tid=1):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": a,
            "dur": b - a, "tid": tid}


def _op(a, b, corr=None, cat="kernel"):
    e = {"ph": "X", "cat": cat, "name": f"op{a}", "ts": a, "dur": b - a,
         "tid": 7}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _launch(corr, t, tid):
    return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
            "ts": t, "dur": 0.1, "tid": tid, "args": {"correlation": corr}}


def _events():
    """Window [0, 100] us. Thread 1: server.predict [0, 90] holding
    features [10, 40] (with features.ncc [15, 25]) and regularizer
    [40, 80]; thread 3: trainer.loss [42, 48] and trainer.step [95, 100];
    thread 2 (a backward thread) holds no span."""
    return [
        _span("bench.window", 0, 100),
        _span("msn.server.launch", -20, -15),        # before the window
        _span("msn.server.predict", 0, 90),
        _span("msn.features", 10, 40),
        _span("msn.features.ncc", 15, 25),
        _span("msn.regularizer", 40, 80),
        _span("msn.trainer.loss", 42, 48, tid=3),
        _span("msn.trainer.step", 95, 100, tid=3),
        {"ph": "X", "cat": "gpu_user_annotation", "name": "msn.features",
         "ts": 22, "dur": 8, "tid": 7},
        _op(-10, 5, 0), _launch(0, -12, 1),          # clipped; no span
        _op(22, 30, 1), _launch(1, 16, 1),           # features.ncc
        _op(30, 50, 2), _launch(2, 45, 2),           # any thread: innermost
        _op(60, 70, 3, "gpu_memcpy"), _launch(3, 58, 2),
        _op(65, 75, 4), _launch(4, 62, 1),           # overlaps the copy
        _op(92, 96, 5), _launch(5, 91, 1),           # no span anywhere
        _op(97, 98, None, "gpu_memset"),             # no launch: its start
        _op(98.5, 99, 7), _launch(7, 85, 1),
    ]


def test_attribution_of_a_hand_made_trace():
    tr = spans.attribute(_events())
    busy = {k: v / US for k, v in tr.busy_s.items()}
    idle = {k: v / US for k, v in tr.idle_s.items()}
    assert busy == pytest.approx({
        "outside": 5 + 4,                    # before any span; after all
        "features.ncc": 8,                   # the launching thread's
        "trainer.loss": 20,                  # thread 2 has none: shortest
        "regularizer": 10 + 10,              # of thread 1 and thread 3
        "trainer.step": 1,                   # the memset at its start
        "server.predict": 0.5})
    assert idle == pytest.approx({
        "features": 17,                      # [5, 22], ended by thread 1
        "regularizer": 10,                   # [50, 60], thread 2: any
        "server.predict": 17,                # [75, 92]
        "trainer.step": 1 + 0.5 + 1})        # any thread; window's end
    assert tr.roots == 2                     # predict and step, not launch
    assert tr.layer_s("trainer", "busy") / US == pytest.approx(21)
    assert tr.layer_s("server", "idle") / US == pytest.approx(17)
    assert tr.layer_s("outside", "busy") / US == pytest.approx(9)


def test_attribution_agrees_with_the_harness():
    """Every idle second is charged once: the spans' idle plus outside is
    the window less the harness's busy time; the busy charges add the
    copy's overlap to it."""
    events = _events()
    tr = spans.attribute(events)
    old = harness.read_trace(events)
    assert (old.busy_s / US, old.window_s / US) == pytest.approx((53.5, 100))
    assert tr.device_busy_s == pytest.approx(old.busy_s)
    assert tr.window_s == pytest.approx(old.window_s)
    assert sum(tr.idle_s.values()) == pytest.approx(
        old.window_s - old.busy_s, rel=1e-12)
    assert sum(tr.busy_s.values()) / US == pytest.approx(53.5 + 5)
    assert {k for k, _ in old.breakdown()["idle_gaps"]} >= {
        "msn.features", "msn.server.predict"}


def test_timeline_clips_round_off_and_picks_the_innermost():
    line = spans._Timeline([(0, 10, "a"), (2, 10.0004, "a.b"),
                            (3, 4, "a.b.c"), (12, 13, "d")])
    assert [line.at(t) and line.at(t)[0] for t in
            (-1, 0, 2.5, 3.5, 4, 9.9, 10, 11, 12.5, 14)] == [
        None, "a", "a.b", "a.b.c", "a.b", "a.b", None, None, "d", None]


def test_no_window_span_raises():
    with pytest.raises(RuntimeError, match="bench.window"):
        spans.attribute([_span("msn.features", 0, 1)])


NEW = {"gcnet-kitti-online": 6, "psmnet-kitti-eval": 7, "gcnet-train-sf": 6}


def _new_metrics(result, tag):
    return {k for k in result["metrics"]
            if k.split(".")[1].endswith("_ms") and k.endswith(tag)
            and k.split(".")[1] != "ms"}


@pytest.mark.parametrize("name", list(NEW))
def test_a_traced_run_reports_the_span_metrics(name, capsys):
    """On the CPU the device is idle all through the window: the idle
    split follows the spans at the window's middle, and the run still
    prints each new metric of its cell, read from the harness's own
    profiled sub-window."""
    r = run(name, trace=True)
    assert r["correct"], r["checks"]
    tag = {"gcnet-kitti-online": ".online", "psmnet-kitti-eval": ".eval",
           "gcnet-train-sf": ".train"}[name]
    got = _new_metrics(r, tag)
    assert len(got) == NEW[name], sorted(r["metrics"])
    for k in got:
        assert r["metrics"][k]["value"] >= 0 and r["metrics"][k]["unit"] == \
            "ms"
    logged = [json.loads(line[len("spans: "):]) for line in
              capsys.readouterr().err.splitlines()
              if line.startswith("spans: ")]
    assert len(logged) == 1 and logged[0]["roots"] > 0


def test_a_program_without_spans_leaves_them_out(monkeypatch):
    """As the program before its spans: the readers find no root span and
    return None; the run's other metrics and its check stand."""
    from msnets_tpu_torch import serve
    from msnets_tpu_torch.engine import trainer
    from msnets_tpu_torch.ops import features
    for mod in (serve, trainer, features):
        monkeypatch.setattr(mod, "span",
                            lambda name: contextlib.nullcontext())
    r = run("gcnet-kitti-online", trace=True)
    assert r["correct"]
    assert not _new_metrics(r, ".online")
    assert "device.idle_pct.online" in r["metrics"]
