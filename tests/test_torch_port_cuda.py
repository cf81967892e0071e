"""The port on the GPU: the census and census_aml kernels against their plain
PyTorch versions, and the feature stage, the server (8-channel, 16-channel
and raw variants, ``predict`` and ``predict_stream``; MS-PSMNet), the train
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
from msnets_tpu_torch.data import pipeline
from msnets_tpu_torch.engine import Evaluator
from msnets_tpu_torch.models import MSGCNet, MSPSMNet
from msnets_tpu_torch.ops.cuda.census import census, census_reference
from msnets_tpu_torch.ops.cuda.census_aml import (census_aml,
                                                  census_aml_reference)
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


def test_ms_features_on_the_card_match_the_cpu(cuda):
    a, b = _pair((64, 128), 7)
    before = census_aml.launches
    got = ms_features_test(torch.from_numpy(a).to(cuda),
                           torch.from_numpy(b).to(cuda), 32, MatchingConfig())
    assert census_aml.launches == before + 1
    ref = ms_features_test(torch.from_numpy(a), torch.from_numpy(b), 32,
                           MatchingConfig())
    err = (got.cpu() - ref).abs().amax(dim=(1, 2, 3))
    # the census channels (0, 4) come from the kernel: exact / sum order;
    # the others are the same torch code, whose CUDA rsqrt, exp and
    # reductions round differently from the CPU's: held at the tolerance
    # of the port-against-JAX feature test
    assert err[0].item() == 0.0 and err[4].item() <= 1e-6, err
    assert err.max().item() <= 5e-6, err


VARIANTS = {"8ch": ({}, (1, 0)), "16ch": ({"num_channels": 16}, (0, 1)),
            "raw": ({"features_mode": "raw"}, (0, 0))}


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_server_on_the_card_matches_the_cpu(cuda, variant):
    fields, (n_aml, n_census) = VARIANTS[variant]
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
        before = (census_aml.launches, census.launches)
        got = srv.predict(a, b)
        assert (census_aml.launches - before[0],
                census.launches - before[1]) == (n_aml, n_census)
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
    before = (census_aml.launches, census.launches)
    got = ms_features_test(torch.from_numpy(a).to(cuda),
                           torch.from_numpy(b).to(cuda), 32, cfg, False)
    assert (census_aml.launches, census.launches) == (before[0], before[1] + 1)
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
        before = (census_aml.launches, census.launches)
        mg, dg = gpu.step_fn(*geom)(b["iml"], b["imr"], b["disp"], 1e-3)
        torch.cuda.synchronize()
        assert (census_aml.launches - before[0],
                census.launches - before[1]) == (n_aml, n_census)
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
    assert {b: q.qsize() for b, q in srv._slots.items()} == \
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


def test_evaluator_on_the_card_matches_the_cpu(cuda, tmp_path, monkeypatch):
    """A KITTI-layout tree of 3 frames (60x120, ground truth as PFM), read
    through the pipeline's read_gray seam (the card's machine has no
    OpenCV): frames, threshold and averages equal to 1e-4, PFMs to 2e-3."""
    rng = np.random.default_rng(2)
    frames, entries = {}, []
    (tmp_path / "disp_occ_0_pfm").mkdir()
    for i in range(3):
        base = rng.integers(0, 256, (60, 126), dtype=np.uint8)
        name = f"{i:06d}_10.png"
        frames[str(tmp_path / "image_0" / name)] = base[:, 6:]
        frames[str(tmp_path / "image_1" / name)] = base[:, :120]
        pfmio.write_pfm(str(tmp_path / "disp_occ_0_pfm" / f"{i:06d}_10.pfm"),
                        np.full((60, 120), 6.0, np.float32))
        entries.append(name)
    (tmp_path / "kt15.list").write_text("\n".join(entries) + "\n")
    monkeypatch.setattr(pipeline, "read_gray", lambda path: frames[path])
    sd = MSGCNet(32, 8, 8, generator=torch.Generator().manual_seed(4)).state_dict()
    out = {}
    for dev in ("cuda", "cpu"):
        cfg = Config(model=ModelConfig(max_disp=32, base_filters=8,
                                       compute_dtype="float32"),
                     data=DataConfig(data_path=str(tmp_path), kitti2015=True,
                                     test_list=str(tmp_path / "kt15.list")),
                     eval=EvalConfig(result_dir=str(tmp_path / dev),
                                     save_color=False))
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
