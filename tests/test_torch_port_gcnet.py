"""GC-Net on the port (``models/gcnet_kendall.py``, ``ops/volume.py``, the
``Trainer`` and ``StereoServer`` paths of a learned feature stage) against
the benchmark's plain reference system ``GCNetKendall``
(``benchmark/reference/gcnet_kendall.py``) on the seed's weights
(``benchmark/weights.py``), at a tiny size on the CPU: a tower 8 wide with
its 8 residual blocks, base_filters 8, max_disp 32, 64x128 RGB crops.

The reference runs in float64 (its soft-argmin in float32, as it is
written) and the port in float32. On the CPU the reference's own float32
is the less exact side: its gradients of the regularizer's leaves stray
from float64 by up to 1.6% at this size, the port's by 2e-5, so a float32
reference would set the tolerances by its own rounding.

The ``cuda`` tests run on the card (skipped without one):

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_port_gcnet.py
"""
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import loads, reference, weights  # noqa: E402
from msnets_tpu_torch import Config, StereoServer  # noqa: E402
from msnets_tpu_torch.engine import Trainer  # noqa: E402
from msnets_tpu_torch.models import GCNet, build_model  # noqa: E402
from msnets_tpu_torch.ops.volume import concat_volume  # noqa: E402
from msnets_tpu_torch.parallel import make_mesh  # noqa: E402
from msnets_tpu_torch.runtime import fp32_reference  # noqa: E402

SEED = 2**31 + 11
LR = 1e-3
TINY = {"name": "GC-Net", "max_disp": 32, "in_channels": 16,
        "base_filters": 8,
        "encoder_ds": 32, "compute_dtype": "float32"}


@pytest.fixture(autouse=True)
def one_thread():
    """One CPU thread: the tests' own sums split the same way everywhere,
    and parallel test workers do not contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _conf(**model):
    return {"reference": "gcnet_kendall.GCNetKendall",
            "model": {**TINY, **model}, "train": {"lr": LR}}


def _cfg(conf, batch=2, **train):
    return Config.from_json(json.dumps({
        "model": conf["model"],
        "train": {"lr": LR, "crop_height": 64, "crop_width": 128,
                  "batch_size": batch, **train}}))


def _batch(batch=2, seed=SEED):
    mix = {"kind": "train", "crop": [64, 128], "batch": batch, "pool": 1,
           "disparity_px": [0, 30], "channels": 3}
    return loads.Training(mix, seed, (0, 0, 0)).batches[0]


def _reference(conf, sd, dtype=torch.float64, device="cpu"):
    ref = reference.build(conf, device)
    ref.load_state_dict(sd)
    return ref.to(dtype)


def _loop_volume(fl, fr, ndisp):
    """The reference system's loop over d."""
    W = fl.shape[-1]
    return torch.stack([torch.cat([F.pad(fl[..., d:], (d, 0)),
                                   F.pad(fr[..., :W - d], (d, 0))], 1)
                        for d in range(ndisp)], 2)


# -- the concat volume -------------------------------------------------------


@pytest.mark.parametrize("shape,ndisp", [((2, 3, 4, 10), 4),
                                         ((1, 8, 16, 64), 16),
                                         ((2, 4, 6, 16), 16)])
def test_concat_volume_is_the_loop(shape, ndisp):
    """The forward copies: equal to the loop bit for bit (negative zeros
    included). The backward sums over d in another order than autograd
    through the loop's pads and cats: float32 rounding of sums of at most
    ``ndisp`` terms of size ~1 (1e-5)."""
    g = torch.Generator().manual_seed(shape[-1] + ndisp)
    fl, fr = (torch.randn(shape, generator=g).requires_grad_()
              for _ in range(2))
    got = concat_volume(fl, fr, ndisp)
    want = _loop_volume(fl, fr, ndisp)
    assert got.shape == (shape[0], 2 * shape[1], ndisp) + shape[2:]
    assert torch.equal(got.view(-1).view(torch.int32),
                       want.view(-1).view(torch.int32))
    up = torch.randn(got.shape, generator=g)
    for a, b in zip(torch.autograd.grad(got, (fl, fr), up),
                    torch.autograd.grad(want, (fl, fr), up)):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5)


def test_concat_volume_keeps_bfloat16_and_counts():
    fl = torch.randn(2, 4, 6, 16).bfloat16()
    n, nbytes = concat_volume.launches, concat_volume.bytes
    v = concat_volume(fl, fl.flip(0), 8)
    assert v.dtype == torch.bfloat16
    assert torch.equal(v, _loop_volume(fl, fl.flip(0), 8))
    assert concat_volume.launches == n + 1
    assert concat_volume.bytes == nbytes + 2 * 8 * 8 * 6 * 16 * 2
    with pytest.raises(ValueError):
        concat_volume(fl, fl.float(), 8)


# -- the model ---------------------------------------------------------------


def test_state_dict_is_the_references():
    conf = _conf()
    port = build_model(_cfg(conf).model, "cpu")
    assert isinstance(port, GCNet)
    ref_keys = list(reference.build(conf, "meta").state_dict())
    assert sorted(port.state_dict()) == sorted(ref_keys)
    assert any(k.startswith("unary.blocks.1.convbn_2.1.") for k in ref_keys)
    port.load_state_dict(weights.make(conf, SEED, "cpu"))


def test_eval_disparity_matches_the_reference():
    """The unfolded eval model (running BN statistics) on a 64x128 pair:
    float32 rounding through 18 2-D and 19 3-D layers, 1e-3 px."""
    conf = _conf()
    sd = weights.make(conf, SEED, "cpu")
    port = build_model(_cfg(conf).model, "cpu")
    port.load_state_dict(sd)
    ref = _reference(conf, sd).eval()
    b = _batch(1)
    il, ir = (torch.from_numpy(b[k][0]) for k in ("iml", "imr"))
    with torch.no_grad():
        got = port(port.features(il[None], ir[None]))
        want = ref(ref.serve_features(il, ir)[None])
    assert got.shape == (1, 64, 128)
    torch.testing.assert_close(got, want.float(), rtol=0, atol=1e-3)


def test_one_train_step_matches_the_reference():
    """``Trainer``'s step (float32) against the reference's (float64): the
    loss to float32 rounding; each leaf's gradient, the tower's included,
    within 1e-4 of the larger of its largest entry and the median leaf's
    (float32 sums over the crops; deconv5's bias cancels in the softmax,
    its reference gradient is rounding and the port's is 0); Adam's change,
    lr times the gradient's sign at step 1, equal to 2.5e-7 (two float32
    ulps of a parameter in [1, 2), of which the change is a difference)
    where the gradient stands clear of rounding (above 1e-3 of that
    scale)."""
    conf = _conf()
    sd = weights.make(conf, SEED, "cpu")
    b = _batch()
    tr = Trainer(_cfg(conf), device="cpu")
    tr.model.load_state_dict({k: v.clone() for k, v in sd.items()})
    before = {k: p.detach().clone() for k, p in tr.model.named_parameters()}
    metrics, disp = tr.step_fn(0, 0, 0)(b["iml"], b["imr"], b["disp"], LR)

    ref = _reference(conf, sd).train()
    opt = torch.optim.Adam(ref.parameters(), lr=LR, betas=(0.9, 0.999),
                           eps=1e-8)
    vol = ref.train_features(torch.from_numpy(b["iml"]),
                             torch.from_numpy(b["imr"]), 0, 0, 0)
    out = ref(vol)
    loss = ref.loss(out, torch.from_numpy(b["disp"]).double())
    loss.backward()
    start = {k: p.detach().clone() for k, p in ref.named_parameters()}
    opt.step()

    assert float(metrics["loss"]) == pytest.approx(loss.item(), rel=1e-5)
    torch.testing.assert_close(disp, out.detach().float(), rtol=0, atol=1e-3)
    port = dict(tr.model.named_parameters())
    assert set(port) == {k for k, _ in ref.named_parameters()}
    tops = {k: p.grad.abs().max().item() for k, p in ref.named_parameters()}
    median = float(np.median(list(tops.values())))
    for k, p in ref.named_parameters():
        want = p.grad
        got = port[k].grad
        got = torch.zeros_like(want) if got is None else got.double()
        scale = max(tops[k], median)
        assert (got - want).abs().max().item() <= 1e-4 * scale, k
        if k.startswith("unary."):
            assert tops[k] > 1e-3 * median, k
        change = port[k].detach().double() - before[k].double()
        clear = want.abs() > 1e-3 * scale
        gap = (change - (p.detach() - start[k]))[clear]
        assert gap.abs().max().item() <= 2.5e-7 if gap.numel() else True, k


def test_predict_matches_the_reference_on_the_padded_pair():
    """``StereoServer.predict`` on a 60x120 RGB pair (the 64x128 bucket;
    BN folded, the head in float32) against the reference on the pair
    padded on top and right, cropped: float32 rounding, 1e-3 px."""
    conf = _conf()
    sd = weights.make(conf, SEED, "cpu")
    left, right, _ = loads.slanted_pair(np.random.default_rng(3), 60, 120, 0,
                                        30, channels=3)
    server = StereoServer(_cfg(conf), {k: v.clone() for k, v in sd.items()},
                          device="cpu")
    got = server.predict(left, right)
    pl, pr = loads.pad_to_bucket(left, right, 32)
    ref = _reference(conf, sd).eval()
    with torch.no_grad():
        want = ref(ref.serve_features(torch.from_numpy(pl),
                                      torch.from_numpy(pr))[None])[0]
    assert got.shape == (60, 120)
    np.testing.assert_allclose(got, want[4:, :120].float().numpy(), rtol=0,
                               atol=1e-3)
    streamed = list(server.predict_stream([(left, right)]))
    np.testing.assert_array_equal(streamed[0], got)


def test_a_grey_pair_and_a_mesh_are_refused():
    conf = _conf()
    sd = weights.make(conf, SEED, "cpu")
    server = StereoServer(_cfg(conf), sd, device="cpu")
    grey = np.zeros((60, 120), np.uint8)
    with pytest.raises(ValueError, match="RGB"):
        server.predict(grey, grey)
    with pytest.raises(ValueError, match="RGB"):
        next(server.predict_stream([(grey, grey)]))
    with pytest.raises(NotImplementedError, match="one device"):
        Trainer(_cfg(conf), device="cpu", mesh=make_mesh((1, 1, 1)))
    tr = Trainer(_cfg(conf), device="cpu")
    b = _batch()
    with pytest.raises(ValueError, match="margins"):
        tr.step_fn(12, 32, 0)(b["iml"], b["imr"], b["disp"], LR)
    with pytest.raises(ValueError, match="matching-cost"):
        tr.matcher_probe_fn(0, 0, 0)


def test_spans_and_counters_of_a_step():
    """A step of two micro-batches under the profiler: the feature stage's
    spans, the volume's backward among them, and one volume a
    micro-batch."""
    from torch.profiler import ProfilerActivity, profile
    conf = _conf()
    tr = Trainer(_cfg(conf, batch=2, grad_accum=2), device="cpu")
    tr.model.load_state_dict(weights.make(conf, SEED, "cpu"))
    b = _batch()
    n, nbytes = concat_volume.launches, concat_volume.bytes
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tr.step_fn(0, 0, 0)(b["iml"], b["imr"], b["disp"], LR)
    names = {e.name for e in prof.events()}
    for span in ("features", "features.unary", "features.volume",
                 "features.volume_backward", "regularizer.backward"):
        assert "msn." + span in names, span
    assert concat_volume.launches == n + 2
    assert concat_volume.bytes == nbytes + 2 * (16 * 16 * 32 * 64 * 4)


# -- on the card -------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    return torch.device("cuda")


FULL = {"name": "GC-Net", "max_disp": 192, "in_channels": 64,
        "base_filters": 32,
        "encoder_ds": 32, "compute_dtype": "bfloat16"}


@pytest.mark.cuda
def test_predict_on_the_card_matches_the_float32_reference(cuda):
    """A 375x1242 RGB pair (the 384x1248 bucket) served at the published
    widths in bf16 against the float32 reference (TF32 off) on the padded
    pair, cropped. The gap in px follows the random weights' logit scale
    (0.98 px mean, 0.60 median on an H100), so it is held in units of the
    reference's own gap when its volume is rounded to bf16 (the
    benchmark's ``gap_ratio``): 3.98 there, held to 12 (the MS-GCNet
    serving cell's program reads 11.5-15.4 and its fp8 control 107 or
    more)."""
    conf = _conf(**FULL)
    sd = weights.make(conf, SEED, cuda)
    left, right, _ = loads.slanted_pair(np.random.default_rng(5), 375, 1242,
                                        0, 190, channels=3)
    server = StereoServer(_cfg(conf), {k: v.clone() for k, v in sd.items()},
                          device=cuda)
    got = torch.from_numpy(server.predict(left, right)).to(cuda)
    del server
    pl, pr = loads.pad_to_bucket(left, right, 32)
    ref = _reference(conf, sd, torch.float32, cuda).eval()
    with torch.no_grad(), fp32_reference():
        vol = ref.serve_features(torch.from_numpy(pl).to(cuda),
                                 torch.from_numpy(pr).to(cuda))[None]
        want = ref(vol)[0, 9:, :1242]
        yard = ref(vol.bfloat16().float())[0, 9:, :1242]
    gap = (got - want).abs()
    ratio = gap.mean().item() / (yard - want).abs().mean().item()
    print(f"predict gap: mean {gap.mean().item():.6g} median "
          f"{gap.median().item():.6g} max {gap.max().item():.6g} px, "
          f"gap ratio {ratio:.6g}")
    assert ratio <= 12


@pytest.mark.cuda
def test_a_train_step_on_the_card_matches_the_float32_reference(cuda):
    """One bf16 step at the published widths, batch 2 of 256x512 crops,
    against the float32 reference (TF32 off), each gap as the benchmark's
    check measures it, read on an H100 (the cell's readings over 19 seeds
    and its faults' in PERF.md): the loss's relative gap 3.7e-6, held to
    1e-3 (half the batch reads 0.21 or more); each leaf's gradient norm
    over the larger of its reference norm and the median leaf's: the
    median leaf 0.0155, held to 0.05 (the cell's program 0.027 at most,
    half the batch 0.46 or more); the worst leaf 0.35, held to 0.7 (bf16
    through the tower's and the regularizer's layers moves the first BN
    leaves' norms by up to 0.51 in the cell; a step that changes nothing
    reads 1); the disparity's mean gap 0.083 px, held to 0.2 (the fp8
    control reads 0.47 or more)."""
    conf = _conf(**FULL)
    sd = weights.make(conf, SEED, cuda)
    mix = {"kind": "train", "crop": [256, 512], "batch": 2, "pool": 1,
           "disparity_px": [0, 190], "channels": 3}
    b = loads.Training(mix, SEED, (0, 0, 0)).batches[0]
    cfg = Config.from_json(json.dumps({
        "model": FULL, "train": {"lr": LR, "crop_height": 256,
                                 "crop_width": 512, "batch_size": 2}}))
    tr = Trainer(cfg, device=cuda)
    tr.model.load_state_dict({k: v.clone() for k, v in sd.items()})
    metrics, disp = tr.step_fn(0, 0, 0)(b["iml"], b["imr"], b["disp"], LR)
    got = {k: (p.grad.double().norm().item() if p.grad is not None else 0.0)
           for k, p in tr.model.named_parameters()}
    loss, disp = float(metrics["loss"]), disp.float()
    del tr
    torch.cuda.empty_cache()
    ref = _reference(conf, sd, torch.float32, cuda).train()
    with fp32_reference():
        out = ref(ref.train_features(torch.from_numpy(b["iml"]).to(cuda),
                                     torch.from_numpy(b["imr"]).to(cuda),
                                     0, 0, 0))
        want_loss = ref.loss(out, torch.from_numpy(b["disp"]).to(cuda))
        want_loss.backward()
    want = {k: p.grad.double().norm().item()
            for k, p in ref.named_parameters()}
    med = float(np.median(list(want.values())))
    gaps = {k: abs(got[k] - want[k]) / max(want[k], med) for k in want}
    worst = max(gaps, key=gaps.get)
    loss_gap = abs(loss - want_loss.item()) / want_loss.item()
    disp_gap = (disp - out.detach()).abs().mean().item()
    top = sorted(gaps.items(), key=lambda kv: -kv[1])[:6]
    print(f"train step: loss gap {loss_gap:.6g}, worst leaves {top}, "
          f"median leaf {np.median(list(gaps.values())):.6g}, disparity "
          f"mean gap {disp_gap:.6g} px")
    assert loss_gap <= 1e-3 and gaps[worst] <= 0.7 and disp_gap <= 0.2
    assert np.median(list(gaps.values())) <= 0.05
