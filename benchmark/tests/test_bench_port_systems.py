"""Every model-specific part of the harness comes from the configuration's
reference system, and the cells that were there read what they read
before: their weights equal a frozen copy of the draw that named its
models, their traffic pools and FLOPs the earlier ones, and tiny runs the
same check numbers. A test-only system with a learned 2-D feature stage
goes through the same weights, counts and reference train step."""
import hashlib
import math

import numpy as np
import pytest
import torch
import torch.nn as nn
import torch.nn.functional as F

from bench_port_tiny import SEED, harness, tiny
from benchmark import loads, reference, weights
from benchmark.counts import flops
from benchmark.reference import models as RM
from benchmark.reference import systems
from benchmark.reference import train as RT

CONFIGS = ("msgcnet-8ch", "mspsmnet-8ch")


def _config(name):
    return harness.load_cell({"msgcnet-8ch": "gcnet-kitti-online",
                              "mspsmnet-8ch": "psmnet-kitti-eval"}[name]).config


def _frozen_make(model_cfg, seed, device):
    """The weights as the benchmark drew them while it named its models:
    3-D convolutions and BatchNorm3d of MS-GCNet or MS-PSMNet only."""
    cls = {"MS-GCNet": RM.GCNet, "MS-PSMNet": RM.PSMNet}[model_cfg["name"]]
    with torch.device("meta"):
        model = cls(model_cfg["max_disp"], model_cfg["in_channels"],
                    model_cfg["base_filters"]).eval()
    normal, uniform = [], []
    out = {}
    for mname, mod in model.named_modules():
        p = f"{mname}." if mname else ""
        if isinstance(mod, (nn.Conv3d, nn.ConvTranspose3d)):
            w = mod.weight
            k3 = math.prod(w.shape[2:])
            std = (math.sqrt(1.0 / (k3 * mod.in_channels))
                   if mod.out_channels == 1
                   else math.sqrt(2.0 / (k3 * mod.out_channels)))
            normal.append((p + "weight", w.shape, std, 0.0))
            if mod.bias is not None:
                out[p + "bias"] = torch.zeros(mod.bias.shape, device=device)
        elif isinstance(mod, nn.BatchNorm3d):
            c = (mod.num_features,)
            uniform.append((p + "weight", c, 1.0, 0.5))
            normal.append((p + "bias", c, 0.2, 0.0))
            normal.append((p + "running_mean", c, 0.3, 0.0))
            uniform.append((p + "running_var", c, 1.5, 0.5))
            out[p + "num_batches_tracked"] = torch.zeros(
                (), dtype=torch.long, device=device)
    g = torch.Generator(device=device).manual_seed(int(seed))
    for specs, draw in ((normal, torch.randn), (uniform, torch.rand)):
        total = sum(math.prod(s) for _, s, _, _ in specs)
        flat = draw(total, generator=g, device=device)
        at = 0
        for key, shape, scale, offset in specs:
            n = math.prod(shape)
            out[key] = flat[at:at + n].view(shape) * scale + offset
            at += n
    return {k: out[k] for k in model.state_dict().keys()}


@pytest.mark.parametrize("seed", [SEED, 7])
@pytest.mark.parametrize("name", CONFIGS)
def test_weights_equal_the_frozen_draw(name, seed):
    conf = _config(name)
    got = weights.make(conf, seed, "cpu")
    want = _frozen_make(conf["model"], seed, "cpu")
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k


POOLS = {  # sha256 of each mix's pool at seed 2**31 + 11 before the change
    "kitti-online":
        "7730d40e261603e88f87a3eca2b9de86be77e577af7ece9e1fbc939b6d2f1c59",
    "kitti-stream":
        "7730d40e261603e88f87a3eca2b9de86be77e577af7ece9e1fbc939b6d2f1c59",
    "sceneflow-train":
        "67eece70a7a2f91ccd3c3d23518a4eefc921f53c17cab99db914f33f10a870d3"}


@pytest.mark.parametrize("mix", list(POOLS))
def test_pools_are_byte_identical(mix):
    spec = loads.load(mix)
    t = loads.make(spec, 2**31 + 11, (12, 192, 0))
    h = hashlib.sha256()
    if spec["kind"] == "train":
        for b in t.batches:
            for k in ("iml", "imr", "disp"):
                h.update(b[k].tobytes())
    else:
        for left, right in t.pairs:
            h.update(left.tobytes())
            h.update(right.tobytes())
        h.update(repr([t.request(i) for i in range(50)]).encode())
    assert h.hexdigest() == POOLS[mix]


FLOPS = {"gcnet-kitti-online": 1955174547456.0,     # a pair at 384x1248
         "psmnet-kitti-eval": 6300282912768.0,
         "gcnet-train-sf": 3121518477312.0,         # a step at batch 2
         "gcnet-train-sf-dp4": 4 * 3121518477312.0}  # the global batch 8


@pytest.mark.parametrize("name", list(FLOPS))
def test_flops_are_the_earlier_totals(name):
    assert harness.flops_per_item(harness.load_cell(name)) == FLOPS[name]


TINY_THREADS = 8
TINY = {  # the check's readings of the tiny cells before the change
    "gcnet-kitti-online": {
        "bad_shape": 0.0, "mean_abs_px": 0.0008753373986110091,
        "p99_abs_px": 0.003851608606055379,
        "max_abs_px": 0.008099555969238281, "gap_ratio": 3.883308483007697,
        "compared": 2.0, "requests": "3:64x128:0.0008753/0.003852/3.88 "
                                     "7:62x126:0.0008425/0.003791/3.83"},
    "psmnet-kitti-eval": {
        "bad_shape": 0.0, "mean_abs_px": 0.008165817707777023,
        "p99_abs_px": 0.026428841054439545,
        "max_abs_px": 0.060301780700683594, "gap_ratio": 7.46238214198857,
        "compared": 2.0, "requests": "3:64x128:0.008166/0.0263/7.46 "
                                     "7:62x126:0.007993/0.02643/7.21"},
    "gcnet-train-sf": {
        "loss_gap_step1": 4.399664571489439e-05,
        "loss_gap_step2": 8.083760379011162e-05,
        "loss_gap_step3": 0.0008243307119068138,
        "loss_gap": 0.0008243307119068138, "grad_gap": 0.22998422347268083,
        "grad_gap_median": 0.012708025980416076,
        "grad_worst_leaf": "conv3dbn_1.1.bias",
        "change_gap": 0.21250737049130497,
        "change_gap_median": 0.01258879404249266,
        "change_worst_leaf": "block_3d_1.convbn_3d_1.1.bias",
        "disp_mean_abs_px": 0.015011073090136051,
        "disp_p99_abs_px": 0.07078786194324493,
        "disp_max_abs_px": 0.1958179473876953, "leaves_left_out": 1.0,
        "ref_loss_step1": 11.943513870239258}}


@pytest.mark.parametrize("name", list(TINY))
def test_tiny_check_numbers_are_the_earlier_ones(name):
    """The readings of a tiny cell's set-up and check, on requests 3 and 7
    (serving) or the checked steps: the same program and reference
    arithmetic as before, to the bit. The CPU's reductions split by the
    thread count, so the run takes the 8 threads the readings were taken
    with, whatever ``OMP_NUM_THREADS`` says."""
    threads = torch.get_num_threads()
    torch.set_num_threads(TINY_THREADS)
    try:
        c = tiny(name)
        sut = harness.make_sut(c, SEED, "cpu")
        sut.warmup()
        if c.kind == "train":
            got = harness.train_readings(c, sut.state_dict, sut.traffic,
                                         sut.readings, "cpu")
        else:
            sample = [(i, sut.server.predict(*sut.traffic.pair(i)))
                      for i in (3, 7)]
            got = harness.serve_readings(c, sut.state_dict, sut.traffic,
                                         sample, "cpu")
    finally:
        torch.set_num_threads(threads)
    assert got == TINY[name]


def test_colour_pairs_follow_the_same_planes():
    r = np.random.default_rng(3)
    left, right, d = loads.slanted_pair(r, 20, 300, 0, 190, channels=3)
    assert left.shape == right.shape == (20, 300, 3) and d.shape == (20, 300)
    y, x = 10, 250
    k = int(round(d[y, x]))
    if abs(d[y, x] - k) < 1e-6 and x - k >= 0:
        assert np.array_equal(left[y, x], right[y, x - k])
    pl, pr = loads.pad_to_bucket(left, right, 32)
    assert pl.shape == pr.shape == (32, 320, 3)
    assert np.array_equal(pl[12:, :300], left) and not pl[:12].any()
    mix = {"kind": "train", "crop": [16, 32], "batch": 2, "pool": 1,
           "disparity_px": [0, 8], "channels": 3}
    b = loads.Training(mix, SEED, (2, 8, 0)).batches[0]
    assert b["iml"].shape == (2, 20, 40, 3) and b["disp"].shape == (2, 16, 32)


# -- a reference system with a learned 2-D feature stage ---------------------


class Learned(RM.PSMNet):
    """Colour pairs through a 2-D tower (conv, BN, ReLU at stride 2, then
    conv and BN), the two views' features concatenated at each disparity
    into [N, 8, D/2, H/2, W/2], then the MS-PSMNet regularizer; the
    three-head loss."""

    def __init__(self, config):
        m = config["model"]
        super().__init__(m["max_disp"], 8, m["base_filters"])
        self.feature = nn.Sequential(
            nn.Conv2d(3, 4, 3, 2, 1, bias=False), nn.BatchNorm2d(4), nn.ReLU(),
            nn.Conv2d(4, 4, 3, 1, 1, bias=False), nn.BatchNorm2d(4))

    @classmethod
    def train_margins(cls, config):
        return (0, 0, 0)

    def _volume(self, iml, imr):
        fl, fr = (self.feature(x.permute(0, 3, 1, 2).float() / 255.0)
                  for x in (iml, imr))
        W = fl.shape[-1]
        return torch.stack([torch.cat([F.pad(fl[..., d:], (d, 0)),
                                       F.pad(fr[..., :W - d], (d, 0))], 1)
                            for d in range(self.max_disp // 2)], 2)

    def serve_features(self, left, right):
        return self._volume(left[None], right[None])[0]

    def train_features(self, iml, imr, board_h, bwl, bwr):
        return self._volume(iml, imr)

    def loss(self, heads, target):
        d0, d1, d2 = (systems.smooth_l1(h, target, self.max_disp)
                      for h in heads)
        return 0.2 * d0 + 0.6 * d1 + d2

    def disparity(self, heads):
        return heads[-1]


LEARNED = {"reference": "systems.Learned",
           "model": {"max_disp": 16, "in_channels": 8, "base_filters": 4}}
TOWER = ("feature.0.weight", "feature.1.weight", "feature.1.bias",
         "feature.3.weight", "feature.4.weight", "feature.4.bias")


@pytest.fixture
def learned(monkeypatch):
    monkeypatch.setattr(systems, "Learned", Learned, raising=False)
    return LEARNED


def test_weights_draw_a_learned_stage(learned):
    sd = weights.make(learned, SEED, "cpu")
    assert list(sd) == list(reference.build(learned, "meta").state_dict())
    for k in ("feature.1", "feature.4"):
        assert ((sd[k + ".weight"] >= 0.5) & (sd[k + ".weight"] <= 1.5)).all()
        assert ((sd[k + ".running_var"] >= 0.5)
                & (sd[k + ".running_var"] <= 2.0)).all()
        assert sd[k + ".bias"].abs().sum() > 0
    w = sd["feature.0.weight"]
    assert w.shape == (4, 3, 3, 3) and w.abs().sum() > 0


def test_flops_count_a_learned_stage(learned):
    """Serving a 32x64 pair: the tower's two convs at 16x32 (3 -> 4 and
    4 -> 4 channels, 3x3) on each view, then the regularizer's 3-D convs
    over the [1, 8, 8, 16, 32] volume, as they count on MS-PSMNet alone. A
    train step needs no input gradient of either view's first conv."""
    got = flops.serve_macs(learned, (32, 64), channels=3)
    first, second = 16 * 32 * 3 * 4 * 9, 16 * 32 * 4 * 4 * 9
    tower = [("feature.0", first, False), ("feature.3", second, True)]
    assert got[:4] == tower * 2
    with torch.device("meta"):
        plain = RM.PSMNet(16, 8, 4).eval()
    regularizer = flops.conv_macs(
        plain, lambda: plain(torch.empty(1, 8, 8, 16, 32, device="meta")))
    assert [m[:2] for m in got[4:]] == [m[:2] for m in regularizer]
    total = 2 * (first + second) + sum(m for _, m, _ in regularizer)
    assert flops.forward_flops(learned, (32, 64), 3) == 2 * total
    step = flops.train_step_flops(learned, 2, (32, 64), 3)
    assert step == 2 * (3 * 2 * total - 2 * 2 * first)


def test_reference_step_trains_a_learned_stage(learned):
    mix = {"kind": "train", "crop": [32, 64], "batch": 2, "pool": 2,
           "disparity_px": [0, 14], "channels": 3}
    batches = loads.Training(mix, SEED, (0, 0, 0)).batches
    sd = weights.make(learned, SEED, "cpu")
    r = RT.steps(reference.build(learned), sd, batches, 1e-3, 2)
    assert len(r["loss"]) == 2 and all(math.isfinite(x) for x in r["loss"])
    assert set(r["grad"]) == set(r["change"]) == {
        k for k, _ in reference.build(learned, "meta").named_parameters()}
    for k in TOWER:
        assert r["grad"][k] > 0 and r["change"][k] > 0, k
    assert r["disp"].shape == (2, 32, 64)
