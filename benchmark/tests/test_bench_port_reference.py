"""The plain reference agrees with the port's CPU path (float32, TF32 not
in play on the CPU) at a tiny size: the feature stage, both models and
the first train steps."""
import numpy as np
import pytest
import torch

from bench_port_tiny import SEED, harness, run, tiny
from benchmark import loads, reference, weights
from benchmark.reference import features as RF

from msnets_tpu_torch.config import MatchingConfig, ModelConfig
from msnets_tpu_torch.models import build_model
from msnets_tpu_torch.ops import features as PF

MATCHING = {"censw": 11, "nccw": 3, "sadw": 5, "sobelw": 5,
            "cens_sigma": 128.0, "ncc_sigma": 0.02, "sad_sigma": 20000.0,
            "ds_scale": 2}


def _pair(h, w, seed=4):
    l, r, _ = loads.slanted_pair(np.random.default_rng(seed), h, w, 0, 14)
    return torch.from_numpy(l), torch.from_numpy(r)


def test_features_test_match_the_port():
    l, r = _pair(64, 96)
    got = PF.ms_features_test(l, r, 32, MatchingConfig())
    want = RF.features_test(l, r, 32, MATCHING)
    assert got.shape == want.shape == (8, 16, 32, 48)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)


def test_features_train_match_the_port():
    l, r = _pair(56, 96)
    got = PF.ms_features_train(l, r, 32, MatchingConfig(), 12, 32, 0)
    want = RF.features_train(l, r, 32, MATCHING, 12, 32, 0)
    assert got.shape == want.shape == (8, 16, 16, 32)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("name", ["MS-GCNet", "MS-PSMNet"])
def test_models_match_the_port(name):
    conf = {"reference": "systems." + name.replace("-", ""),
            "model": {"max_disp": 32, "in_channels": 8, "base_filters": 4},
            "matching": MATCHING}
    sd = weights.make(conf, SEED, "cpu")
    ref = reference.build(conf)
    ref.load_state_dict(sd)
    port = build_model(ModelConfig(name=name, max_disp=32, base_filters=4,
                                   compute_dtype="float32"), "cpu")
    port.load_state_dict(sd)
    x = torch.rand(1, 8, 16, 16, 32, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        torch.testing.assert_close(port(x), ref(x), rtol=0, atol=2e-4)
        ref.train()
        port.train()
        got, want = port(x), ref(x)
        if name == "MS-PSMNet":
            got, want = got[-1], want[-1]
        torch.testing.assert_close(got, want, rtol=0, atol=2e-4)


def test_train_steps_match_the_port_in_float32():
    cell = tiny("gcnet-train-sf")
    cell.config["model"]["compute_dtype"] = "float32"
    sut = harness.make_sut(cell, SEED, "cpu")
    sut.warmup()
    r = harness.train_readings(cell, sut.state_dict, sut.traffic,
                               sut.readings, "cpu")
    # float32 on both sides: the first step agrees to rounding; Adam's
    # steps after it move each leaf by about lr * sign(gradient), which
    # carries the rounding of nearly-zero gradients into the change
    assert r["loss_gap_step1"] < 1e-5 and r["grad_gap"] < 1e-3
    assert r["disp_max_abs_px"] < 1e-3 and r["loss_gap"] < 1e-4
    assert r["change_gap_median"] < 1e-3 and r["change_gap"] < 0.05
    assert r["leaves_left_out"] == 1.0


@pytest.mark.parametrize("name", ["gcnet-kitti-online", "psmnet-kitti-eval"])
def test_serving_matches_the_reference_in_float32(name):
    cell = tiny(name)
    cell.config["model"]["compute_dtype"] = "float32"
    r = run(name, cell=cell)
    assert r["readings"]["compared"] == 2.0
    assert r["readings"]["max_abs_px"] < 1e-3


def test_psmnet_train_steps_match_the_port_in_float32():
    """MS-PSMNet's reference system (its three heads weighted as the
    port's ``psmnet_loss``) against the port's ``Trainer`` on the tiny
    train cell's traffic, both in float32."""
    cell = tiny("gcnet-train-sf")
    conf = harness.load_cell("psmnet-kitti-eval").config
    conf["model"].update(max_disp=64, base_filters=8,
                         compute_dtype="float32")
    cell.config = conf
    sut = harness.make_sut(cell, SEED, "cpu")
    sut.warmup()
    r = harness.train_readings(cell, sut.state_dict, sut.traffic,
                               sut.readings, "cpu")
    assert r["loss_gap_step1"] < 1e-5 and r["grad_gap"] < 1e-3
    assert r["disp_max_abs_px"] < 1e-3 and r["loss_gap"] < 1e-4
    assert r["change_gap_median"] < 1e-3 and r["change_gap"] < 0.05
