"""The port's spans (``utils.profiling.span``) and the server's counters on
the CPU: the spans of a request, a stream frame and a train step as the
exported trace holds them, nested as ``utils/profiling.py`` lists them;
``stats()``'s ``cold_frames``, ``slot_waits`` and ``slot_wait_s``."""
import json
import threading
import time

import numpy as np
import pytest
import torch

from msnets_tpu_torch import serve as TS
from msnets_tpu_torch.config import (Config, MatchingConfig, ModelConfig,
                                     TrainConfig)
from msnets_tpu_torch.data.pipeline import synthetic_train_batch
from msnets_tpu_torch.engine import Trainer
from msnets_tpu_torch.models import MSGCNet
from msnets_tpu_torch.utils import profiling as P

MAX_DISP, F = 32, 4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(matching=MatchingConfig(), **train):
    return Config(matching=matching,
                  model=ModelConfig(max_disp=MAX_DISP, base_filters=F,
                                    in_channels=matching.feature_channels,
                                    compute_dtype="float32"),
                  train=TrainConfig(**train))


def _server(matching=MatchingConfig(), **kw):
    m = MSGCNet(MAX_DISP, matching.feature_channels, F,
                generator=torch.Generator().manual_seed(3))
    return TS.StereoServer(_cfg(matching), m.state_dict(), device="cpu", **kw)


def _pair(h, w, seed=0):
    r = np.random.default_rng(seed)
    return (r.integers(0, 256, (h, w), dtype=np.uint8),
            r.integers(0, 256, (h, w), dtype=np.uint8))


def _forest(path):
    """The trace's ``msn.*`` spans as trees: [(name without "msn.",
    [children])], in start order, nested by containment on each thread."""
    events = json.loads(path.read_text())["traceEvents"]
    spans = sorted((e for e in events if e.get("cat") == "user_annotation"
                    and str(e.get("name", "")).startswith("msn.")),
                   key=lambda e: (e["tid"], e["ts"], -e["dur"]))
    roots, stack = [], []
    for e in spans:
        node = (e["name"][4:], [])
        while stack and (stack[-1][0] != e["tid"]
                         or e["ts"] >= stack[-1][1]):
            stack.pop()
        (stack[-1][2][1] if stack else roots).append(node)
        stack.append((e["tid"], e["ts"] + e["dur"], node))
    return roots


def _shape(nodes):
    return [(name, _shape(kids)) for name, kids in nodes]


def _traced(tmp_path, fn):
    with P.trace(str(tmp_path)):
        fn()
    return _shape(_forest(tmp_path / "trace.json"))


def _leaf(*names):
    return [(n, []) for n in names]


MATCHERS = {"8ch": _leaf("features.downsample", "features.census_aml",
                         "features.matchers"),
            "16ch": _leaf("features.downsample", "features.census",
                          "features.ncc", "features.zsad",
                          "features.sobel_sad", "features.assemble"),
            "raw": _leaf("features.downsample")}
# the model with its head (models/gcnet.py) when serving
REGULARIZER = ("regularizer", _leaf("regularizer.head"))
MATCHING = {"8ch": MatchingConfig(),
            "16ch": MatchingConfig(num_channels=16),
            "raw": MatchingConfig(features_mode="raw")}


def test_span_is_the_shared_null_context_when_no_profiler_records():
    a, b = P.span("server.predict"), P.span("features")
    assert a is b
    with a as x:
        assert x is None


def test_span_records_under_msn_and_nests(tmp_path):
    def block():
        with P.span("outer"):
            with P.span("outer.inner"):
                torch.ones(4) + 1
    assert _traced(tmp_path, block) == [("outer", _leaf("outer.inner"))]


def test_span_in_a_thread_started_under_the_profiler_is_not_recorded(
        tmp_path):
    """The documented limit of ``span``: a thread started under the
    profiler records none."""
    seen = {}

    def worker():
        seen["recording"] = torch._C._autograd._profiler_enabled()
        with P.span("thread"):
            torch.ones(4) + 1

    def block():
        t = threading.Thread(target=worker)
        t.start()
        t.join()
        with P.span("main"):
            pass
    assert _traced(tmp_path, block) == _leaf("main")
    assert seen["recording"] is False


@pytest.mark.parametrize("variant", list(MATCHERS))
def test_predict_spans(tmp_path, variant):
    srv = _server(MATCHING[variant])
    pair = _pair(60, 120)
    got = _traced(tmp_path, lambda: srv.predict(*pair))
    assert got == [("server.predict", _leaf("server.pad", "server.h2d")
                    + [("features", MATCHERS[variant]), REGULARIZER]
                    + _leaf("server.d2h", "server.crop"))]


def _slow_finish(srv, seconds):
    finish = srv._finish

    def slow(*a):
        time.sleep(seconds)
        return finish(*a)
    srv._finish = slow


def test_stream_spans_and_slot_waits(tmp_path):
    """Depth 1 and a slow ``_finish`` (a device still busy with the frame
    before): the second frame's launch finishes the first inside its
    ``server.slot_wait`` before it takes the one slot."""
    srv = _server(depth=1)
    _slow_finish(srv, 0.3)
    pairs = [_pair(60, 120, s) for s in range(2)]
    out = []
    got = _traced(tmp_path, lambda: out.extend(srv.predict_stream(pairs)))
    frame = _leaf("server.pad", "server.h2d") + [
        ("features", MATCHERS["8ch"]), REGULARIZER] + _leaf("server.d2h")
    assert got == [("server.launch", frame),
                   ("server.launch", frame[:1] + _leaf("server.slot_wait")
                    + frame[1:])]
    s = srv.stats()
    assert len(out) == 2 and s["frames"] == 2
    assert s["slot_waits"] == 1 and 0.1 < s["slot_wait_s"] < 10


def test_slot_counters_stay_zero_with_a_free_slot():
    srv = _server(depth=2)
    pair = _pair(60, 120)
    list(srv.predict_stream([pair]))
    srv.predict(*pair)
    s = srv.stats()
    assert s["frames"] == 2
    assert s["slot_waits"] == 0 and s["slot_wait_s"] == 0.0


def test_cold_frames_count_unwarmed_buckets_only():
    srv = _server(buckets=[(64, 128)])
    srv.warmup()
    srv.predict(*_pair(60, 120))                 # (64, 128): warmed
    list(srv.predict_stream([_pair(50, 100)]))
    assert srv.stats()["cold_frames"] == 0
    srv.predict(*_pair(70, 130))                 # (96, 160): not warmed
    list(srv.predict_stream([_pair(70, 130)]))
    s = srv.stats()
    assert s["cold_frames"] == 2 and s["frames"] == 4
    assert s["warm_buckets"] == [(64, 128)]


@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_spans(tmp_path, accum):
    """One MS-GCNet step, two samples: each micro-batch's features (a
    feature stage a sample), forward, loss, backward and metrics, then the
    step's metrics and the optimizer; no all-reduce without a mesh."""
    cfg = _cfg(crop_height=32, crop_width=64, batch_size=2,
               grad_accum=accum)
    tr = Trainer(cfg, device="cpu")
    b = synthetic_train_batch(32, 64, MAX_DISP, MatchingConfig(), 2, 5, 0)
    fn = tr.step_fn(b["board_h"], b["board_w_left"], b["board_w_right"])
    got = _traced(tmp_path, lambda: fn(b["iml"], b["imr"], b["disp"], 1e-3))
    per = 2 // accum
    micro = ([("features", MATCHERS["8ch"] * per),
              ("regularizer.forward", _leaf("regularizer.head"))]
             + _leaf("trainer.loss", "regularizer.backward",
                     "trainer.metrics"))
    assert got == [("trainer.step", _leaf("trainer.h2d", "trainer.optimizer")
                    + micro * accum
                    + _leaf("trainer.metrics", "trainer.optimizer"))]
