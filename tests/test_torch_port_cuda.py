"""The port on the GPU: the census, census_aml, matchers_aml, int8_absmax,
int8_quantize, int8_conv3d and subpixel_soft_argmin kernels against their
plain PyTorch versions, and the feature
stage, the server (8-channel, 16-channel and raw variants, ``predict`` and
``predict_stream``; MS-PSMNet), the train
step (MS-GCNet; MS-PSMNet with and without remat), the checkpoint round trip
and the evaluator on the card against the same code on the CPU. Every
test needs an NVIDIA GPU and skips without one; run them on the card with

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_port_cuda.py

(``--noconftest``: tests/conftest.py sets up JAX, which this file does not
use)."""
import numpy as np
import pytest
import torch

from msnets_tpu_torch import Config, ModelConfig, StereoServer
from msnets_tpu_torch.config import (DataConfig, EvalConfig, MatchingConfig,
                                     TrainConfig)
from msnets_tpu_torch.data.pipeline import synthetic_train_batch
from msnets_tpu_torch.engine import Trainer
from msnets_tpu_torch.engine import checkpoint as ck
from msnets_tpu_torch.data import pfm as pfmio
from msnets_tpu_torch.data import png
from msnets_tpu_torch.engine import Evaluator
from msnets_tpu_torch.models import MSGCNet, MSPSMNet
from msnets_tpu_torch.ops.cuda.census import census, census_reference
from msnets_tpu_torch.ops.cuda.census_aml import (census_aml,
                                                  census_aml_reference)
from msnets_tpu_torch.ops.cuda.matchers_aml import (matchers_aml,
                                                    matchers_aml_reference)
from msnets_tpu_torch.ops.cuda.subpixel_soft_argmin import (
    subpixel_soft_argmin, subpixel_soft_argmin_reference)
from msnets_tpu_torch.ops.features import ms_features_test
from msnets_tpu_torch.runtime import fp32_reference

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    return torch.device("cuda")


def _pair(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, shape, dtype=np.uint8),
            rng.integers(0, 256, shape, dtype=np.uint8))


@pytest.mark.parametrize("H,W,ndisp,wsize,sigma", [
    (148, 276, 96, 11, 128.0),     # serving path, 256x512 bucket
    (148, 276, 192, 11, 128.0),    # ndisp of ds_scale 1
    (140, 352, 96, 11, 128.0),     # train path, 280x704 crop
    (45, 131, 40, 11, 64.0),       # rows and columns that divide no tile
    (21, 97, 17, 11, 128.0),       # ndisp not a multiple of the warp split
    (37, 301, 95, 11, 128.0),
    (37, 301, 95, 11, 1e18),       # INVALID entries weigh ~0.01 each
    (16, 400, 300, 11, 1e18),      # right descriptors in two chunks
    (13, 600, 560, 11, 128.0),     # distances kept past shared memory
    (30, 20, 32, 11, 128.0),       # ndisp > W
    (1, 64, 16, 11, 128.0),        # H = 1: all INVALID
    (13, 12, 8, 11, 128.0),        # W = 12: one valid column
    (9, 11, 8, 11, 128.0),         # W = 11: no valid column
    (12, 8, 4, 11, 128.0),         # W < window: all INVALID
    (1, 1, 1, 11, 128.0),
    (33, 70, 17, 5, 32.0),         # a smaller window
])
def test_census_aml_kernel_matches_plain(cuda, H, W, ndisp, wsize, sigma):
    a, b = (torch.from_numpy(x).to(cuda) for x in _pair((H, W), H * W))
    before = census_aml.launches
    cost, aml = census_aml(a, b, ndisp, wsize, sigma)
    assert census_aml.launches == before + 1
    rc, ra = census_aml_reference(a, b, ndisp, wsize, sigma)
    torch.cuda.synchronize()
    assert cost.shape == aml.shape == (ndisp, H, W)
    assert torch.equal(cost, rc)
    # only the order of the sum over d differs from the plain version
    assert (aml - ra).abs().max().item() <= 1e-6
    if W <= wsize or H <= wsize:                     # no valid pixel
        assert bool((cost == 1.0).all()) and bool((aml == 0).all())


def test_census_aml_kernel_rejects_mixed_devices(cuda):
    a, b = (torch.from_numpy(x) for x in _pair((20, 40), 0))
    with pytest.raises(ValueError):
        census_aml(a.to(cuda), b, 8)
    with pytest.raises(ValueError):
        census_aml(a.to(cuda).t(), b.to(cuda).t(), 8)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("H,W,ndisp,margins,flat", [
    (212, 644, 96, (10, 10, 10), False),   # serving path, 384x1248 bucket
    (148, 276, 96, (10, 10, 10), False),   # serving path, 256x512 bucket
    (140, 352, 96, (6, 96, 0), False),     # train path, 280x704 crop
    (45, 131, 40, (5, 6, 3), False),       # tiles and warps divide nothing
    (37, 301, 200, (0, 0, 0), False),      # costs past the kept ones
    (4, 40, 8, (0, 0, 0), False),          # H below the 5x5 window
    (40, 4, 8, (0, 0, 0), False),          # W below the 5x5 window
    (20, 6, 8, (0, 0, 0), False),          # one valid 5x5 column
    (12, 9, 20, (0, 0, 0), False),         # ndisp > W
    (16, 40, 8, (0, 0, 0), True),          # flat: NCC's cost-1 rule
])
def test_matchers_aml_kernel_matches_plain(cuda, H, W, ndisp, margins, flat,
                                           dtype):
    a, b = (torch.from_numpy(x).to(cuda) for x in _pair((H, W), H * W))
    if flat:
        a, b = torch.full_like(a, 77), torch.full_like(b, 90)
    cen = census_aml(a, b, ndisp)
    before = matchers_aml.launches
    got = matchers_aml(a, b, *cen, ndisp, board_h=margins[0],
                       board_w_left=margins[1], board_w_right=margins[2],
                       out_dtype=dtype)
    assert matchers_aml.launches == before + 1
    ref = matchers_aml_reference(a, b, *cen, ndisp, board_h=margins[0],
                                 board_w_left=margins[1],
                                 board_w_right=margins[2], out_dtype=dtype)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == ref.shape == (
        8, ndisp, H - 2 * margins[0], W - margins[1] - margins[2])
    # the costs' channels are exact; the AMLs differ in the order of the sum
    # over d only: 1e-6 in float32, one unit in the last place in bfloat16
    # (every value is >= 0, so bit patterns order as the values do)
    assert torch.equal(got[:5], ref[:5])
    if dtype == torch.float32:
        assert (got[5:] - ref[5:]).abs().max().item() <= 1e-6
    else:
        ulps = (got[5:].view(torch.int16).int()
                - ref[5:].view(torch.int16).int()).abs().max().item()
        assert ulps <= 1, ulps
    if flat:
        assert bool((got[1] == 1.0).all())


def test_matchers_aml_kernel_rejects_what_it_does_not_take(cuda):
    a, b = (torch.from_numpy(x).to(cuda) for x in _pair((20, 40), 0))
    cen = census_aml(a, b, 8)
    with pytest.raises(ValueError):                       # mixed devices
        matchers_aml(a, b.cpu(), *cen, 8)
    with pytest.raises(ValueError):                       # not contiguous
        matchers_aml(a.t().contiguous().t(), b, *cen, 8)
    with pytest.raises(ValueError):                       # other windows
        matchers_aml(a, b, *cen, 8, nccw=5)
    with pytest.raises(ValueError):
        matchers_aml(a, b, *cen, 8, out_dtype=torch.float16)


def test_ms_features_on_the_card_match_the_cpu(cuda):
    a, b = _pair((64, 128), 7)
    before = (census_aml.launches, matchers_aml.launches)
    got = ms_features_test(torch.from_numpy(a).to(cuda),
                           torch.from_numpy(b).to(cuda), 32, MatchingConfig())
    assert (census_aml.launches, matchers_aml.launches) == (
        before[0] + 1, before[1] + 1)
    ref = ms_features_test(torch.from_numpy(a), torch.from_numpy(b), 32,
                           MatchingConfig())
    err = (got.cpu() - ref).abs().amax(dim=(1, 2, 3))
    # the census channels (0, 4) come from census_aml: exact / sum order;
    # the others from matchers_aml, whose CUDA rsqrt, exp and sums round
    # differently from the CPU's: held at the tolerance of the
    # port-against-JAX feature test
    assert err[0].item() == 0.0 and err[4].item() <= 1e-6, err
    assert err.max().item() <= 5e-6, err


VARIANTS = {"8ch": ({}, (1, 0, 1)), "16ch": ({"num_channels": 16}, (0, 1, 0)),
            "raw": ({"features_mode": "raw"}, (0, 0, 0))}


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_server_on_the_card_matches_the_cpu(cuda, variant):
    fields, launches = VARIANTS[variant]
    matching = MatchingConfig(**fields)
    cfg = Config(matching=matching,
                 model=ModelConfig(max_disp=32, base_filters=8,
                                   in_channels=matching.feature_channels,
                                   compute_dtype="float32"))
    sd = MSGCNet(32, matching.feature_channels, 8,
                 generator=torch.Generator().manual_seed(3)).state_dict()
    a, b = _pair((60, 120), 0)
    with fp32_reference():
        srv = StereoServer(cfg, sd, device=cuda)
        before = (census_aml.launches, census.launches,
                  matchers_aml.launches)
        got = srv.predict(a, b)
        assert (census_aml.launches - before[0], census.launches - before[1],
                matchers_aml.launches - before[2]) == launches
    ref = StereoServer(cfg, sd, device="cpu").predict(a, b)
    assert got.shape == ref.shape == (60, 120)
    np.testing.assert_allclose(got, ref, atol=2e-3)


@pytest.mark.parametrize("H,W,ndisp,wsize", [
    (148, 276, 96, 11),     # serving path, 256x512 bucket
    (212, 644, 96, 11),     # serving path, 384x1248 bucket
    (148, 276, 192, 11),    # ndisp of ds_scale 1
    (140, 448, 96, 11),     # train path, 16 channels: 280x896 crop
    (45, 131, 40, 11),      # rows and disparities that divide no tile
    (21, 97, 17, 11),       # ndisp not a multiple of the warp split
    (37, 301, 95, 11),
    (16, 400, 300, 11),     # right descriptors in two chunks
    (13, 600, 560, 11),     # right descriptors in three chunks
    (30, 20, 32, 11),       # ndisp > W
    (1, 64, 16, 11),        # H = 1: all INVALID
    (13, 12, 8, 11),        # W = 12: one valid column
    (9, 11, 8, 11),         # W = 11: no valid column
    (12, 8, 4, 11),         # W < window: all INVALID
    (1, 1, 1, 11),
    (33, 70, 17, 5),        # a smaller window
])
def test_census_kernel_matches_plain(cuda, H, W, ndisp, wsize):
    a, b = (torch.from_numpy(x).to(cuda) for x in _pair((H, W), H + W))
    before = census.launches
    got = census(a, b, ndisp, wsize)
    assert census.launches == before + 1
    ref = census_reference(a, b, ndisp, wsize)
    torch.cuda.synchronize()
    assert got.shape == (ndisp, H, W)
    assert torch.equal(got, ref)


def test_census_kernel_rejects_mixed_devices(cuda):
    a, b = (torch.from_numpy(x) for x in _pair((20, 40), 0))
    with pytest.raises(ValueError):
        census(a.to(cuda), b, 8)


def test_16ch_and_raw_features_on_the_card_match_the_cpu(cuda):
    a, b = _pair((64, 128), 7)
    cfg = MatchingConfig(num_channels=16)
    before = (census_aml.launches, census.launches, matchers_aml.launches)
    got = ms_features_test(torch.from_numpy(a).to(cuda),
                           torch.from_numpy(b).to(cuda), 32, cfg, False)
    assert (census_aml.launches, census.launches, matchers_aml.launches) == (
        before[0], before[1] + 1, before[2])
    ref = ms_features_test(torch.from_numpy(a), torch.from_numpy(b), 32, cfg,
                           False)
    err = (got.cpu() - ref).abs().amax(dim=(1, 2, 3))
    # channels 0 and 8 are the kernel's census cost, normalized the same way
    assert err[0].item() == 0.0 and err[8].item() == 0.0, err
    assert err.max().item() <= 5e-6, err
    raw = MatchingConfig(features_mode="raw")
    got = ms_features_test(torch.from_numpy(a).to(cuda),
                           torch.from_numpy(b).to(cuda), 32, raw, True,
                           torch.bfloat16)
    assert matchers_aml.launches == before[2]
    ref = ms_features_test(torch.from_numpy(a), torch.from_numpy(b), 32, raw,
                           True, torch.bfloat16)
    assert torch.equal(got.cpu(), ref)


# relative L2 error of a gradient tensor, card against CPU (float32, TF32
# off): worst 1.2e-4 (8 channels) and 1.9e-4 (16) measured on an H100
CARD_GRAD_RTOL = 1e-3


def _train_cfg(channels=8, batch_size=2, dtype="float32", root="."):
    m = MatchingConfig(num_channels=channels)
    return Config(matching=m,
                  model=ModelConfig(max_disp=32, base_filters=4,
                                    in_channels=channels, compute_dtype=dtype),
                  train=TrainConfig(crop_height=32, crop_width=64,
                                    batch_size=batch_size,
                                    checkpoint_dir=str(root)))


@pytest.mark.parametrize("channels,batch,n_aml,n_census",
                         [(8, 2, 2, 0), (16, 1, 0, 1)])
def test_train_step_on_the_card_matches_the_cpu(cuda, channels, batch, n_aml,
                                                n_census):
    """One float32 step (TF32 off) from the same weights: the census
    kernels launch once a sample; loss to rel 1e-4; disparity to 2e-3, the
    bound of the server's card-against-CPU test (train-mode BN divides by
    the batch deviation of few elements in the deep layers, which scales
    the rounding up: 2.1e-4 measured on an H100); BN running statistics to
    1e-5; every parameter's gradient (cuDNN's dgrad and wgrad, the BN
    backward on the card) to a relative L2 error of CARD_GRAD_RTOL; and
    Adam's first update, about lr * sign(g), the same way in more than 99%
    of the components (|d| < lr / 10)."""
    cfg = _train_cfg(channels, batch)
    b = synthetic_train_batch(32, 64, 32, cfg.matching, batch, 5, 0,
                              channels == 8)
    geom = (b["board_h"], b["board_w_left"], b["board_w_right"])
    with fp32_reference():
        gpu = Trainer(cfg, device=cuda, seed=3)
        cpu = Trainer(cfg, device="cpu", seed=3)
        before = (census_aml.launches, census.launches,
                  matchers_aml.launches)
        mg, dg = gpu.step_fn(*geom)(b["iml"], b["imr"], b["disp"], 1e-3)
        torch.cuda.synchronize()
        # census_aml and matchers_aml launch together, once an 8-ch sample
        assert (census_aml.launches - before[0], census.launches - before[1],
                matchers_aml.launches - before[2]) == (n_aml, n_census, n_aml)
        mc, dc = cpu.step_fn(*geom)(b["iml"], b["imr"], b["disp"], 1e-3)
    assert float(mg["loss"]) == pytest.approx(float(mc["loss"]), rel=1e-4)
    np.testing.assert_allclose(dg.cpu().numpy(), dc.numpy(), atol=2e-3)
    sg, sc = gpu.model.state_dict(), cpu.model.state_dict()
    for k, v in sc.items():
        if "running" in k:
            np.testing.assert_allclose(sg[k].cpu().numpy(), v.numpy(),
                                       rtol=1e-5, atol=1e-5, err_msg=k)
    moved, errs = [], {}
    for (k, pg), (_, pc) in zip(gpu.model.named_parameters(),
                                cpu.model.named_parameters()):
        if pc.grad is None:                          # deconv5's bias
            assert pg.grad is None, k
            continue
        want = pc.grad.double()
        errs[k] = ((pg.grad.cpu().double() - want).norm() / want.norm()).item()
        moved.append(((pg.detach().cpu() - pc.detach()).abs() < 1e-4).ravel())
    worst = max(errs, key=errs.get)
    print(f"{channels} channels: worst gradient relative L2 error "
          f"{errs[worst]:.3g} ({worst})")
    assert errs[worst] <= CARD_GRAD_RTOL, (worst, errs[worst])
    assert torch.cat(moved).float().mean().item() > 0.99


def test_bf16_train_steps_on_the_card(cuda):
    cfg = _train_cfg(dtype="bfloat16")
    tr = Trainer(cfg, device=cuda)
    b = synthetic_train_batch(32, 64, 32, cfg.matching, 2, 5, 0)
    fn = tr.step_fn(b["board_h"], b["board_w_left"], b["board_w_right"])
    losses = [float(fn(b["iml"], b["imr"], b["disp"], 1e-3)[0]["loss"])
              for _ in range(4)]
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses
    assert tr.model.conv3dbn_1[0].weight.dtype == torch.float32


def test_checkpoint_round_trip_on_the_card(cuda, tmp_path):
    """save_step snapshots on the card; the step right after it changes the
    live tensors in place; a fresh trainer resumed from the file holds the
    snapshot bit for bit."""
    cfg = _train_cfg(root=tmp_path)
    tr = Trainer(cfg, device=cuda)
    b = synthetic_train_batch(32, 64, 32, cfg.matching, 2, 5, 0)
    fn = tr.step_fn(b["board_h"], b["board_w_left"], b["board_w_right"])
    fn(b["iml"], b["imr"], b["disp"], 1e-3)
    want = ck._map_tensors(lambda t: t.detach().cpu().clone(), tr.state())
    path = tr.save_step(1, 1)
    fn(b["iml"], b["imr"], b["disp"], 1e-3)
    tr.finish_checkpoints()
    fresh = Trainer(cfg, device=cuda, seed=1)
    fresh.resume(path)
    got = fresh.state()
    assert got["step"] == want["step"] == 1
    for k, v in want["state_dict"].items():
        assert got["state_dict"][k].device.type == "cuda"
        assert torch.equal(got["state_dict"][k].cpu(), v), k
    for i, s in want["optimizer"]["state"].items():
        for k, v in s.items():
            assert torch.equal(got["optimizer"]["state"][i][k].cpu(), v), (i, k)


def test_predict_stream_on_the_card_equals_predict(cuda):
    cfg = Config(model=ModelConfig(max_disp=32, base_filters=8,
                                   compute_dtype="float32"))
    sd = MSGCNet(32, 8, 8, generator=torch.Generator().manual_seed(3)).state_dict()
    srv = StereoServer(cfg, sd, device=cuda, depth=2)
    pairs = [_pair(s, i) for i, s in enumerate([(64, 128), (60, 120), (96, 160),
                                                (64, 128), (96, 160), (50, 90)])]
    # bit for bit under cuDNN's deterministic algorithms: its transposed
    # convolutions may otherwise sum in a run-dependent order (4e-6 apart
    # on an H100 with the default ones)
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        got = list(srv.predict_stream(iter(pairs)))
        want = [srv.predict(a, b) for a, b in pairs]
    finally:
        torch.backends.cudnn.deterministic = prev
    for d, w in zip(got, want):
        np.testing.assert_array_equal(d, w)
    assert {b: len(pool) for b, pool in srv._slots.items()} == \
        {(64, 128): 2, (96, 160): 2, (64, 96): 2}


def _psmnet_cfg(**train):
    return Config(model=ModelConfig(name="MS-PSMNet", max_disp=32,
                                    base_filters=8, compute_dtype="float32"),
                  train=TrainConfig(crop_height=32, crop_width=64,
                                    batch_size=2, **train))


def test_psmnet_server_on_the_card_matches_the_cpu(cuda):
    sd = MSPSMNet(32, 8, 8, generator=torch.Generator().manual_seed(3)).state_dict()
    a, b = _pair((60, 120), 1)
    cfg = _psmnet_cfg()
    with fp32_reference():
        before = (census_aml.launches, census.launches)
        got = StereoServer(cfg, sd, device=cuda).predict(a, b)
        assert (census_aml.launches - before[0],
                census.launches - before[1]) == (1, 0)
    ref = StereoServer(cfg, sd, device="cpu").predict(a, b)
    assert got.shape == ref.shape == (60, 120)
    np.testing.assert_allclose(got, ref, atol=2e-3)


class _ReluDecisions:
    """Records which inputs of each ``F.relu`` call pass (``record``), or
    makes each call pass exactly the recorded ones (``replay``), so that a
    second run takes the first run's side of every ReLU kink.

    The step's ReLUs see about 1.1M inputs, and in float32 the card and
    the CPU compute them about 1e-6 apart: an input that close to 0 lands
    on one side of the kink on one device and on the other side on the
    other, and its whole gradient enters one run and not the other (one
    such input in dres3.conv1 moved that BN's bias gradient by 4.5%).
    Replayed, the CPU run differs from relu only on such inputs, by no more
    than their size."""

    def __init__(self, monkeypatch):
        self.masks, self.replay = [], False
        self._relu = torch.nn.functional.relu
        monkeypatch.setattr(torch.nn.functional, "relu", self)

    def __call__(self, x, inplace=False):
        if not self.replay:
            self.masks.append((x > 0).cpu())
            return self._relu(x, inplace)
        mask = self.masks.pop(0).to(x.device)
        return x * mask.to(x.dtype)


@pytest.mark.parametrize("remat,scope", [(False, "all"), (True, "all"),
                                         (True, "hourglass")])
def test_psmnet_train_step_on_the_card_matches_the_cpu(cuda, remat, scope,
                                                       monkeypatch):
    """One float32 MS-PSMNet step (TF32 off) from the same weights, at the
    bounds of the MS-GCNet card-against-CPU step: loss rel 1e-4, disparity
    2e-3, BN running statistics 1e-5 (each BN updated once), gradients to
    CARD_GRAD_RTOL, with the CPU run taking the card run's side of every
    ReLU kink (``_ReluDecisions``)."""
    cfg = _psmnet_cfg(remat=remat, remat_scope=scope)
    b = synthetic_train_batch(32, 64, 32, cfg.matching, 2, 5, 0)
    geom = (b["board_h"], b["board_w_left"], b["board_w_right"])
    relu = _ReluDecisions(monkeypatch)
    with fp32_reference():
        gpu = Trainer(cfg, device=cuda, seed=3)
        cpu = Trainer(cfg, device="cpu", seed=3)
        before = census_aml.launches
        mg, dg = gpu.step_fn(*geom)(b["iml"], b["imr"], b["disp"], 1e-3)
        torch.cuda.synchronize()
        assert census_aml.launches - before == 2
        relu.replay = True
        mc, dc = cpu.step_fn(*geom)(b["iml"], b["imr"], b["disp"], 1e-3)
        assert relu.masks == []                 # the same calls, in order
    assert float(mg["loss"]) == pytest.approx(float(mc["loss"]), rel=1e-4)
    np.testing.assert_allclose(dg.cpu().numpy(), dc.numpy(), atol=2e-3)
    sg, sc = gpu.model.state_dict(), cpu.model.state_dict()
    for k, v in sc.items():
        if k.endswith("num_batches_tracked"):
            assert int(sg[k]) == int(v) == 1, k
        elif "running" in k:
            np.testing.assert_allclose(sg[k].cpu().numpy(), v.numpy(),
                                       rtol=1e-5, atol=1e-5, err_msg=k)
    errs = {}
    for (k, pg), (_, pc) in zip(gpu.model.named_parameters(),
                                cpu.model.named_parameters()):
        want = pc.grad.double()
        errs[k] = ((pg.grad.cpu().double() - want).norm() / want.norm()).item()
    worst = max(errs, key=errs.get)
    print(f"MS-PSMNet remat={remat} {scope}: worst gradient relative L2 "
          f"error {errs[worst]:.3g} ({worst})")
    assert errs[worst] <= CARD_GRAD_RTOL, (worst, errs[worst])


def test_evaluator_on_the_card_matches_the_cpu(cuda, tmp_path):
    """A KITTI-layout tree of 3 frames (60x120 PNG files written by the
    port's codec, ground truth as PFM), read from disk: frames, threshold
    and averages equal to 1e-4, PFMs to 2e-3, the colour PNGs written on
    both devices."""
    rng = np.random.default_rng(2)
    entries = []
    for d in ("image_0", "image_1", "disp_occ_0_pfm"):
        (tmp_path / d).mkdir()
    for i in range(3):
        base = rng.integers(0, 256, (60, 126), dtype=np.uint8)
        name = f"{i:06d}_10.png"
        png.write_png(str(tmp_path / "image_0" / name), base[:, 6:].copy())
        png.write_png(str(tmp_path / "image_1" / name), base[:, :120].copy())
        pfmio.write_pfm(str(tmp_path / "disp_occ_0_pfm" / f"{i:06d}_10.pfm"),
                        np.full((60, 120), 6.0, np.float32))
        entries.append(name)
    (tmp_path / "kt15.list").write_text("\n".join(entries) + "\n")
    sd = MSGCNet(32, 8, 8, generator=torch.Generator().manual_seed(4)).state_dict()
    out = {}
    for dev in ("cuda", "cpu"):
        cfg = Config(model=ModelConfig(max_disp=32, base_filters=8,
                                       compute_dtype="float32"),
                     data=DataConfig(data_path=str(tmp_path), kitti2015=True,
                                     test_list=str(tmp_path / "kt15.list")),
                     eval=EvalConfig(result_dir=str(tmp_path / dev)))
        with fp32_reference():
            before = census_aml.launches
            out[dev] = Evaluator(cfg, sd, device=dev).run(log=lambda *a: None)
            if dev == "cuda":
                assert census_aml.launches - before == 3
    assert out["cuda"]["frames"] == out["cpu"]["frames"] == 3
    assert out["cuda"]["threshold"] == out["cpu"]["threshold"] == 3.0
    for k in ("avg_epe", "avg_bad"):
        assert out["cuda"][k] == pytest.approx(out["cpu"][k], abs=1e-4)
    for name in entries:
        pfm = name[:-4] + ".pfm"
        np.testing.assert_allclose(pfmio.read_pfm(str(tmp_path / "cuda" / pfm)),
                                   pfmio.read_pfm(str(tmp_path / "cpu" / pfm)),
                                   atol=2e-3)
        for dev in ("cuda", "cpu"):
            assert (tmp_path / dev / "dispColor" / name).is_file()


@pytest.mark.parametrize("shape,cout,stride,pad", [
    ((1, 6, 8, 10, 32), 32, 1, (1, 1, 1)),   # the stem's widths
    ((1, 6, 8, 10, 32), 64, 2, (1, 1, 1)),   # block_3d_1's entry
    ((1, 5, 7, 9, 64), 64, 2, (1, 1, 1)),    # a block entry, odd dims
    ((2, 5, 7, 9, 8), 16, 1, (0, 1, 1)),     # a disp-split halo window
    ((2, 5, 7, 9, 4), 8, 2, (1, 0, 1)),      # a spatial-split one
    ((1, 4, 1, 6, 8), 16, 1, (1, 1, 1)),     # H = 1
    ((1, 4, 5, 6, 5), 12, 1, (1, 1, 1)),     # cin 5, zero-padded to 8
    ((1, 3, 3, 3, 128), 40, 1, (0, 0, 0)),   # a partial second tile
])
def test_int8_conv3d_kernel_matches_plain(cuda, shape, cout, stride, pad):
    """The int32 sums of the kernel equal the plain version's (float64
    conv3d on the CPU), exactly, over full-range int8 values."""
    from msnets_tpu_torch.ops.cuda.int8_conv3d import (int8_conv3d,
                                                       int8_conv3d_reference)
    rng = np.random.default_rng(sum(shape) + cout)
    xq = torch.from_numpy(rng.integers(-127, 128, shape, dtype=np.int8))
    wq = torch.from_numpy(rng.integers(-127, 128, (cout, 3, 3, 3, shape[-1]),
                                       dtype=np.int8))
    before = int8_conv3d.launches
    got = int8_conv3d(xq.to(cuda), wq.to(cuda), stride, pad)
    torch.cuda.synchronize()
    assert int8_conv3d.launches == before + 1
    want = int8_conv3d_reference(xq, wq, stride, pad)
    assert got.dtype == torch.int32 and got.shape == want.shape
    assert torch.equal(got.cpu(), want)


def test_int8_conv3d_kernel_rejects_mixed_devices(cuda):
    from msnets_tpu_torch.ops.cuda.int8_conv3d import int8_conv3d
    xq = torch.zeros((1, 4, 4, 4, 8), dtype=torch.int8)
    wq = torch.zeros((8, 3, 3, 3, 8), dtype=torch.int8)
    with pytest.raises(ValueError):
        int8_conv3d(xq.to(cuda), wq, 1)


INT8_FUSED_CASES = [    # x [N, C, D, H, W], cout, stride, padding
    ((1, 32, 6, 8, 10), 32, 1, (1, 1, 1)),    # the stem's widths
    ((1, 32, 6, 8, 10), 64, 2, (1, 1, 1)),    # block_3d_1's entry
    ((1, 64, 5, 7, 9), 64, 2, (1, 1, 1)),     # a block entry, odd dims
    ((2, 8, 5, 7, 9), 16, 1, (0, 1, 1)),      # a disp-split halo window
    ((2, 4, 5, 7, 9), 8, 2, (1, 0, 1)),       # a spatial-split one
    ((1, 8, 4, 1, 6), 16, 1, (1, 1, 1)),      # H = 1
    ((1, 5, 4, 5, 6), 12, 1, (1, 1, 1)),      # cin 5
    ((2, 32, 3, 4, 300), 40, 1, (1, 1, 1)),   # ragged third ow tile
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,cout,stride,pad", INT8_FUSED_CASES)
def test_int8_quantize_and_fused_conv_kernels_match_plain(cuda, shape, cout,
                                                          stride, pad, dtype):
    """int8_quantize and the fused int8_conv3d_dequant on the card equal
    their plain versions on the CPU bit for bit, with per-sample and scalar
    scales; each call launches its kernel once."""
    from msnets_tpu_torch.ops.cuda.int8_conv3d import (
        int8_conv3d, int8_conv3d_dequant, int8_conv3d_dequant_reference,
        pack_weights)
    from msnets_tpu_torch.ops.cuda.int8_quantize import (
        int8_quantize, int8_quantize_reference)
    rng = np.random.default_rng(sum(shape) + cout + stride)
    tdt = getattr(torch, dtype)
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                         * 5.0).to(tdt)
    wp = pack_weights(torch.from_numpy(rng.integers(
        -127, 128, (cout, 3, 3, 3, shape[1]), dtype=np.int8)))
    sk = torch.from_numpy(rng.uniform(1e-4, 1e-2, cout).astype(np.float32))
    bias = torch.from_numpy(rng.standard_normal(cout).astype(np.float32))
    for sx in (torch.from_numpy(rng.uniform(0.01, 0.1, shape[0]).astype(
            np.float32)), torch.tensor(np.float32(0.03))):
        q0, c0 = int8_quantize.launches, int8_conv3d.launches
        xq = int8_quantize(x.to(cuda), sx.to(cuda))
        got = int8_conv3d_dequant(xq, wp.to(cuda), sx.to(cuda), sk.to(cuda),
                                  bias.to(cuda), stride, pad, tdt)
        torch.cuda.synchronize()
        assert (int8_quantize.launches - q0, int8_conv3d.launches - c0) == (
            1, 1)
        want_q = int8_quantize_reference(x, sx)
        assert torch.equal(xq.cpu(), want_q)
        want = int8_conv3d_dequant_reference(want_q, wp, sx, sk, bias,
                                             stride, pad, tdt)
        assert got.dtype == tdt and got.shape == want.shape
        assert torch.equal(got.cpu(), want)


def test_int8_quantize_and_fused_conv_reject_bad_inputs(cuda):
    from msnets_tpu_torch.ops.cuda.int8_conv3d import (int8_conv3d_dequant,
                                                       pack_weights)
    from msnets_tpu_torch.ops.cuda.int8_quantize import int8_quantize
    x = torch.zeros((1, 8, 4, 4, 4), device=cuda)
    with pytest.raises(ValueError):
        int8_quantize(x, torch.ones(1))                  # scale on the CPU
    with pytest.raises(TypeError):
        int8_quantize(x.half(), torch.ones(1, device=cuda))
    xq = torch.zeros((1, 4, 4, 4, 32), dtype=torch.int8, device=cuda)
    wp = pack_weights(torch.zeros((8, 3, 3, 3, 32), dtype=torch.int8))
    one, ones = torch.ones(1, device=cuda), torch.ones(8, device=cuda)
    with pytest.raises(ValueError):
        int8_conv3d_dequant(xq, wp, one, ones, ones, 1, (1, 1, 1),
                            torch.float32)               # wp on the CPU
    with pytest.raises(TypeError):
        int8_conv3d_dequant(xq, wp.to(cuda), one, ones.half(), ones, 1,
                            (1, 1, 1), torch.float32)
    with pytest.raises(TypeError):
        int8_conv3d_dequant(xq.float(), wp.to(cuda), one, ones, ones, 1,
                            (1, 1, 1), torch.float32)


ABSMAX_SHAPES = [       # x [N, ...]: odd dims; C=5, W=11 (a sample stride
    (1, 3, 5, 7, 9),    # that is no multiple of 16 bytes); a 2-D input; a
    (2, 5, 3, 3, 11),   # volume of many blocks a sample
    (2, 5, 3, 4, 11),
    (3, 1001),
    (2, 32, 8, 64, 128),
]


def _same_bits(got, want):
    """Equal float32 bits, NaNs by position."""
    got, want = got.cpu().numpy(), want.cpu().numpy()
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan)
    np.testing.assert_array_equal(got[~nan].view(np.int32),
                                  want[~nan].view(np.int32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", ABSMAX_SHAPES)
def test_int8_absmax_kernel_matches_plain(cuda, shape, dtype):
    """The max-abs kernel equals its plain version bit for bit: random
    samples, then (N >= 2) a NaN in sample 0 only, +-inf in sample 1 only,
    an all-zero sample and one of negative zeros; and on a view whose start
    is not 16-byte aligned. One launch a call."""
    from msnets_tpu_torch.ops.cuda.int8_quantize import (
        int8_absmax, int8_absmax_reference)
    rng = np.random.default_rng(sum(shape))
    tdt = getattr(torch, dtype)
    x = rng.standard_normal(shape).astype(np.float32) * 50.0
    cases = [x]
    if shape[0] >= 2:
        for fill in (np.nan, np.inf, -np.inf):
            y = x.copy()
            y.reshape(shape[0], -1)[0 if fill != fill else 1, 7] = fill
            cases.append(y)
        y = x.copy()
        y[0], y[1] = 0.0, -0.0
        cases.append(y)
    for y in cases:
        t = torch.from_numpy(y).to(tdt)
        before = int8_absmax.launches
        got = int8_absmax(t.to(cuda))
        torch.cuda.synchronize()
        assert int8_absmax.launches == before + 1
        assert got.dtype == torch.float32 and got.shape == (shape[0],)
        _same_bits(got, int8_absmax_reference(t))
    flat = torch.from_numpy(x).to(tdt).reshape(-1).to(cuda)
    base = torch.cat([flat[:1], flat])
    view = base[1:].view(shape)
    assert view.data_ptr() % 16 != 0 and view.is_contiguous()
    _same_bits(int8_absmax(view), int8_absmax_reference(view.cpu()))


def test_int8_absmax_kernel_rejects_bad_inputs(cuda):
    from msnets_tpu_torch.ops.cuda.int8_quantize import int8_absmax
    x = torch.ones((2, 3, 4), device=cuda)
    with pytest.raises(TypeError):
        int8_absmax(x.half())
    with pytest.raises(ValueError):
        int8_absmax(x.transpose(1, 2))
    with pytest.raises(ValueError):
        int8_absmax(x[:, :0])


QUANTIZE_EDGES = [      # x [N, C, D, H, W]
    (1, 32, 2, 3, 13),      # W no multiple of 8: the plain loader
    (2, 32, 1, 1, 100),     # fewer positions than a tile (256 at Cp 32)
    (1, 32, 1, 1, 257),     # a tile and one position
    (1, 32, 2, 2, 64),      # a tile exactly
    (2, 20, 3, 8, 40),      # Cp 32 from 20 channels, ragged last tile
    (1, 64, 3, 5, 24),      # Cp 64, tiles of 128
    (2, 48, 1, 3, 43),      # Cp 64, unaligned
    (1, 128, 2, 4, 16),     # Cp 128, tiles of 64
    (1, 100, 1, 5, 13),     # Cp 128 from 100 channels, unaligned
    (1, 128, 1, 1, 65),     # Cp 128, a tile and one position
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", QUANTIZE_EDGES)
def test_int8_quantize_kernel_edge_shapes(cuda, shape, dtype):
    """int8_quantize at the tiling's edges (see QUANTIZE_EDGES), with a
    scale a sample and one for all, and on a view whose start is not
    16-byte aligned: bit for bit against the plain version on the CPU, one
    launch a call."""
    from msnets_tpu_torch.ops.cuda.int8_quantize import (
        int8_quantize, int8_quantize_reference)
    rng = np.random.default_rng(sum(shape) + len(dtype))
    tdt = getattr(torch, dtype)
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                         * 4.0).to(tdt)
    for sx in (torch.from_numpy(rng.uniform(0.01, 0.05, shape[0]).astype(
            np.float32)), torch.tensor(np.float32(0.02))):
        before = int8_quantize.launches
        got = int8_quantize(x.to(cuda), sx.to(cuda))
        torch.cuda.synchronize()
        assert int8_quantize.launches == before + 1
        assert torch.equal(got.cpu(), int8_quantize_reference(x, sx))
    flat = x.reshape(-1).to(cuda)
    view = torch.cat([flat[:1], flat])[1:].view(shape)
    assert view.data_ptr() % 16 != 0
    assert torch.equal(int8_quantize(view, sx.to(cuda)).cpu(),
                       int8_quantize_reference(x, sx))


def _tie_values(rng, scales):
    """Values that sit on and next to the half-integers k + 0.5 of x / s,
    float32 [len(scales), 32, 4096]: where round half to even and the
    division's own rounding decide the int8."""
    k = rng.integers(-130, 130, (len(scales), 32, 1024)).astype(np.float32)
    t = ((k + np.float32(0.5)) * np.asarray(scales, np.float32)[:, None, None])
    steps = np.arange(-2, 2, dtype=np.int32).reshape(1, 1, 1, 4)
    bits = t.view(np.int32)[..., None] + steps
    return bits.view(np.float32).reshape(len(scales), 32, 4096)


def test_int8_quantize_kernel_every_bf16_value(cuda):
    """The kernel equals the plain version (a true division on the host)
    bit for bit on every finite bfloat16 value, and on float32 values on
    and next to the rounding edges, at scales from dynamic absmaxes (amax *
    float32(1/127)), powers of two and extreme scales."""
    from msnets_tpu_torch.ops.cuda.int8_quantize import (
        int8_quantize, int8_quantize_reference)
    from msnets_tpu_torch.ops.matchers import _div_const
    rng = np.random.default_rng(13)
    amax = torch.tensor([1.0, 3.3, 127.0, 0.01, 1e4, 2.5e-3, 7.0, 42.42])
    scales = torch.cat([_div_const(amax, 127.0),
                        torch.tensor([2.0 ** -20, 0.5, 1e-31, 1e31, 3e-38])])
    bits = np.arange(1 << 16, dtype=np.uint32).astype(np.uint16)
    bf = torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16)
    bf = bf[torch.isfinite(bf.float())]
    bf = torch.cat([bf, bf[:(-bf.numel()) % 32]]).reshape(1, 32, 1, 1, -1)
    ties = torch.from_numpy(_tie_values(rng, scales.tolist()))
    for i, s in enumerate(scales.tolist()):
        sx = torch.tensor(np.float32(s), device=cuda)
        for x in (bf.to(cuda), ties[i].reshape(1, 32, 1, 1, -1).to(cuda)):
            assert torch.equal(int8_quantize(x, sx).cpu(),
                               int8_quantize_reference(x.cpu(), sx.cpu())), (
                s, x.dtype)


@pytest.mark.parametrize("model,mode,n_int8", [
    ("MS-GCNet", "dynamic", 2), ("MS-GCNet", "static", 2),
    ("MS-PSMNet", "dynamic", 6)])
def test_int8_server_on_the_card_matches_the_cpu(cuda, model, mode, n_int8):
    """A quant_eval server (float32, F=8, max_disp 32) on the card: the
    int8 convs launch the kernel, and the disparity is the CPU's up to the
    int8 grid's own sensitivity. The card's float convs sum in another
    order, so each dynamic scale (a max over the volume) can differ by an
    ulp and move every value on the grid, as two calibrations do in
    tests/test_torch_port_quant_models.py::test_static_int8_matches_jax:
    the mean gap is held to 20 times below int8's move from float32 on the
    CPU (with the CPU's calibration on both sides, static flips only
    values on a boundary)."""
    from msnets_tpu_torch.models import build_model
    from msnets_tpu_torch.ops.cuda.int8_conv3d import int8_conv3d
    cfg = Config(model=ModelConfig(name=model, max_disp=32, base_filters=8,
                                   compute_dtype="float32", quant_eval=True,
                                   quant_mode=mode))
    sd = build_model(cfg.model, "cpu",
                     torch.Generator().manual_seed(3)).state_dict()
    a, b = _pair((64, 128), 1)
    stats = None
    if mode == "static":
        calib = StereoServer(Config(model=ModelConfig(
            name=model, max_disp=32, base_filters=8, compute_dtype="float32",
            quant_eval=True, quant_mode="calib")), sd, device="cpu")
        calib.predict(a, b)
        stats = calib.quant_stats()
    with fp32_reference():
        srv = StereoServer(cfg, sd, device=cuda, quant_stats=stats)
        before = int8_conv3d.launches
        got = srv.predict(a, b)
        assert int8_conv3d.launches - before == n_int8
    ref = StereoServer(cfg, sd, device="cpu", quant_stats=stats).predict(a, b)
    f32 = StereoServer(Config(model=ModelConfig(
        name=model, max_disp=32, base_filters=8, compute_dtype="float32")),
        sd, device="cpu").predict(a, b)
    assert got.shape == ref.shape == (64, 128)
    gap, int8 = np.abs(got - ref).mean(), np.abs(ref - f32).mean()
    print(f"{model} {mode}: card-CPU mean {gap:.3g} px, max "
          f"{np.abs(got - ref).max():.3g}; int8-float32 {int8:.3g} px")
    assert gap * 20 <= int8


def _head_inputs(cuda, shape, dtype, stride, peak=None, seed=0):
    """The decoder's output after its ReLU, NDHWC in ``dtype``, and a
    He-normal deconv5 kernel; with ``peak``, scaled so that the largest
    |logit| is ``peak``."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(shape, generator=g).relu().to(
        cuda, dtype, memory_format=torch.channels_last_3d)
    k = (torch.randn((shape[1], 1, 3, 3, 3), generator=g)
         * (2 / 27) ** 0.5).to(cuda)
    if peak is not None:
        logits = torch.nn.functional.conv_transpose3d(
            x.double(), k.double(), None, stride, 1, stride - 1)
        k = k * (peak / logits.abs().max().item())
    return x, k


HEAD_CASES = [
    ((1, 32, 96, 192, 624), 2, "bf16", None),   # the online cell: 384x1248
    ((2, 32, 7, 13, 45), 2, "bf16", None),      # odd D, H, W; two samples
    ((1, 32, 6, 9, 33), 2, "bf16", 80.0),       # one row and column past a tile
    ((1, 32, 24, 48, 156), 4, "bf16", None),    # quarter_input at 384x1248
    ((2, 32, 5, 7, 35), 4, "bf16", 80.0),
    ((1, 8, 16, 12, 70), 2, "f32", None),       # the card tests' F=8 server
    ((1, 16, 3, 1, 1), 2, "f32", None),         # one pixel
    ((1, 64, 9, 10, 31), 4, "f32", None),       # the most channels it takes
]


@pytest.mark.parametrize("shape,stride,dtype,peak", HEAD_CASES)
def test_subpixel_soft_argmin_kernel_matches_float64(cuda, shape, stride,
                                                     dtype, peak):
    """Against the plain version in float64 on the same inputs: max |dd| <=
    1e-3 px. The kernel sums 27 taps x C channels a logit in float32 (an
    error of ~1e-6 of the logits' scale) and takes __expf (a relative error
    of ~2^-21 on the softmax's weights, which moves the disparity by at most
    that times the spread of d, < 1e-4 px at D = 192)."""
    x, k = _head_inputs(cuda, shape, {"bf16": torch.bfloat16,
                                      "f32": torch.float32}[dtype], stride,
                        peak)
    before = subpixel_soft_argmin.launches
    got = subpixel_soft_argmin(x, k, stride, stride * shape[2])
    assert subpixel_soft_argmin.launches == before + 1
    want = subpixel_soft_argmin_reference(x.double(), k.double(), stride)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32
    assert got.shape == (shape[0], stride * shape[3], stride * shape[4])
    err = (got.double() - want).abs().max().item()
    print(f"{shape} s={stride} {dtype}: max |dd| {err:.3g} px")
    assert err <= 1e-3


@pytest.mark.parametrize("stride", [2, 4])
def test_subpixel_soft_argmin_kernel_matches_the_cudnn_head(cuda, stride):
    """At the online shape (its quarter with stride 4), against the path it
    replaces, deconv5 through cuDNN plus ``soft_argmin``, with TF32 off:
    both float32, so within 1e-3 px."""
    from msnets_tpu_torch.models.layers import conv_head
    shape = (1, 32, 96, 192, 624) if stride == 2 else (1, 32, 24, 48, 156)
    x, k = _head_inputs(cuda, shape, torch.bfloat16, stride, seed=1)
    got = subpixel_soft_argmin(x, k, stride, stride * shape[2])
    with fp32_reference():
        want = conv_head(x, k, stride, stride * shape[2])
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    print(f"s={stride}: kernel against cuDNN (TF32 off) max |dd| {err:.3g}")
    assert err <= 1e-3


def test_subpixel_soft_argmin_rejects_what_it_does_not_take(cuda):
    x, k = _head_inputs(cuda, (1, 32, 8, 6, 10), torch.bfloat16, 2)
    with pytest.raises(ValueError):                       # mixed devices
        subpixel_soft_argmin(x, k.cpu(), 2, 16)
    with pytest.raises(ValueError):                       # NCDHW
        subpixel_soft_argmin(x.contiguous(), k, 2, 16)
    with pytest.raises(TypeError):                        # float16
        subpixel_soft_argmin(x.half(), k, 2, 16)
    with pytest.raises(ValueError):                       # D_out != max_disp
        subpixel_soft_argmin(x, k, 2, 32)
    with pytest.raises(ValueError):                       # 4 bf16 channels
        subpixel_soft_argmin(x[:, :4].contiguous(
            memory_format=torch.channels_last_3d), k[:4], 2, 16)


def test_subpixel_soft_argmin_launches_once_a_request_not_in_training(cuda):
    cfg = Config(model=ModelConfig(max_disp=32, base_filters=8,
                                   compute_dtype="bfloat16"))
    sd = MSGCNet(32, 8, 8, generator=torch.Generator().manual_seed(3)).state_dict()
    srv = StereoServer(cfg, sd, device=cuda)
    before = subpixel_soft_argmin.launches
    for i in range(3):
        srv.predict(*_pair((60, 120), i))
    assert subpixel_soft_argmin.launches == before + 3
    tcfg = _train_cfg()
    tr = Trainer(tcfg, device=cuda, seed=3)
    b = synthetic_train_batch(32, 64, 32, tcfg.matching, 2, 5, 0)
    before = subpixel_soft_argmin.launches
    tr.step_fn(b["board_h"], b["board_w_left"], b["board_w_right"])(
        b["iml"], b["imr"], b["disp"], 1e-3)
    torch.cuda.synchronize()
    assert subpixel_soft_argmin.launches == before


def test_subpixel_soft_argmin_leaves_other_widths_to_the_conv_head(cuda):
    """A float32 MS-GCNet of 6 filters (a width the kernel does not take)
    serves on the card through the conv head, launching nothing, and gives
    the CPU server's disparity."""
    cfg = Config(model=ModelConfig(max_disp=32, base_filters=6,
                                   compute_dtype="float32"))
    sd = MSGCNet(32, 8, 6, generator=torch.Generator().manual_seed(3)).state_dict()
    a, b = _pair((60, 120), 0)
    with fp32_reference():
        before = subpixel_soft_argmin.launches
        got = StereoServer(cfg, sd, device=cuda).predict(a, b)
        assert subpixel_soft_argmin.launches == before
    ref = StereoServer(cfg, sd, device="cpu").predict(a, b)
    assert got.shape == ref.shape == (60, 120)
    np.testing.assert_allclose(got, ref, atol=2e-3)
