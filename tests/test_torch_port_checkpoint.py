"""Port checkpoints (msnets_tpu_torch.engine.checkpoint and the Trainer's
save/resume) and StereoServer.from_checkpoint, on the CPU."""
import json
import os

import numpy as np
import pytest
import torch

from msnets_tpu_torch.config import (Config, DataConfig, MatchingConfig,
                                     ModelConfig, TrainConfig)
from msnets_tpu_torch.data.pipeline import TrainPipeline, synthetic_train_batch
from msnets_tpu_torch.engine import checkpoint as ck
from msnets_tpu_torch.engine import Trainer
from msnets_tpu_torch.serve import StereoServer

from . import torch_ref
from .test_torch_port_data import make_sceneflow_tree

MAX_DISP = 32


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(root, **train):
    return Config(model=ModelConfig(max_disp=MAX_DISP, base_filters=4,
                                    compute_dtype="float32"),
                  train=TrainConfig(crop_height=32, crop_width=64,
                                    batch_size=2, checkpoint_dir=str(root),
                                    **train),
                  data=DataConfig(data_path=str(root)))


def _stepped(cfg, steps=1, seed=0):
    tr = Trainer(cfg, device="cpu", seed=seed)
    for i in range(steps):
        b = synthetic_train_batch(32, 64, MAX_DISP, MatchingConfig(), 2, 5,
                                  i)
        tr.step_fn(12, MAX_DISP, 0)(b["iml"], b["imr"], b["disp"], 1e-3)
    return tr


def _assert_state_equal(a, b):
    """Bitwise: every tensor of the model (parameters, BN running stats,
    num_batches_tracked), the Adam moments and steps, and the step count."""
    sa, sb = a.state(), b.state()
    assert sa["step"] == sb["step"]
    assert sa["state_dict"].keys() == sb["state_dict"].keys()
    for k, v in sa["state_dict"].items():
        assert torch.equal(v, sb["state_dict"][k]), k
    oa, ob = sa["optimizer"]["state"], sb["optimizer"]["state"]
    assert oa.keys() == ob.keys() and len(oa) > 0
    for i in oa:
        for k in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(oa[i][k], ob[i][k]), (i, k)


def test_names_schema_sidecar_and_no_tmp(tmp_path):
    tr = _stepped(_cfg(tmp_path, async_ckpt=False))
    path = tr.maybe_save(3, {"loss": 1.5, "epe": 2.5, "accu3": 0.25,
                             "batches": 4})
    assert path == str(tmp_path / "MS-GCNet" / "model_epoch_00003.tar")
    assert ck.step_ckpt_path(str(tmp_path), "MS-GCNet", 12) == \
        str(tmp_path / "MS-GCNet" / "model_step_00000012.tar")
    ckpt, meta = ck.load_checkpoint(path)
    assert set(ckpt) == {"epoch", "state_dict", "optimizer", "loss", "epe_err",
                         "accu3", "step", "format"}
    assert (ckpt["epoch"], ckpt["loss"], ckpt["epe_err"], ckpt["accu3"],
            ckpt["step"]) == (3, 1.5, 2.5, 0.25, 1)
    assert meta == json.load(open(path + ".json")) == {
        "epoch": 3, "loss": 1.5, "epe_err": 2.5, "accu3": 0.25, "batches": 4}
    ck.save_checkpoint(str(tmp_path), "MS-GCNet", 4, tr.state(), is_best=True)
    best, _ = ck.load_checkpoint(str(tmp_path / "MS-GCNet" / "model_best.tar"))
    assert best["epoch"] == 4
    assert not [p for p in os.listdir(tmp_path / "MS-GCNet") if p.endswith(".tmp")]


def test_kitti_cadence(tmp_path):
    cfg = _cfg(tmp_path, async_ckpt=False)
    tr = Trainer(Config(model=cfg.model, train=cfg.train,
                        data=DataConfig(kitti2015=True)), device="cpu")
    assert tr.maybe_save(24, {}) is None
    assert tr.maybe_save(25, {}).endswith("model_epoch_00025.tar")
    assert tr.maybe_save(26, {}, final=True).endswith("model_epoch_00026.tar")


def test_async_equals_sync_after_an_in_place_step(tmp_path):
    """save() snapshots before it returns: a step right after it (Adam and
    BN update in place) does not reach the file."""
    tr = _stepped(_cfg(tmp_path))
    sync = ck.save_checkpoint(str(tmp_path / "sync"), "m", 1, tr.state())
    saver = ck.AsyncCheckpointer()
    path = saver.save(str(tmp_path / "async"), "m", 1, tr.state())
    before = tr.model.conv3dbn_1[0].weight.detach().clone()
    b = synthetic_train_batch(32, 64, MAX_DISP, MatchingConfig(), 2, 5, 9)
    tr.step_fn(12, MAX_DISP, 0)(b["iml"], b["imr"], b["disp"], 1e-3)
    assert not torch.equal(before, tr.model.conv3dbn_1[0].weight)
    assert saver.wait() == [path]
    a, _ = ck.load_checkpoint(sync)
    c, _ = ck.load_checkpoint(path)
    assert c["step"] == a["step"] == 1
    for k, v in a["state_dict"].items():
        assert torch.equal(c["state_dict"][k], v), k
    for i, s in a["optimizer"]["state"].items():
        for k, v in s.items():
            assert torch.equal(c["optimizer"]["state"][i][k], v), (i, k)
    assert not [p for p in os.listdir(tmp_path / "async" / "m") if p.endswith(".tmp")]
    saver.close()
    assert not saver._thread.is_alive()


def test_writer_errors_surface_on_wait(tmp_path):
    saver = ck.AsyncCheckpointer()
    bad = tmp_path / "file"
    bad.write_text("")                  # makedirs(bad/m) fails
    saver.save(str(bad), "m", 1, {"state_dict": {}, "optimizer": {}, "step": 0})
    with pytest.raises(OSError):
        saver.wait()
    saver.close()


def test_resume_restores_the_state_bitwise(tmp_path):
    tr = _stepped(_cfg(tmp_path), steps=2)
    tr.save_step(1, 2)
    tr.finish_checkpoints()
    fresh = Trainer(_cfg(tmp_path), device="cpu", seed=1)
    meta = fresh.resume(ck.step_ckpt_path(str(tmp_path), "MS-GCNet", 2))
    assert meta == {"epoch": 1, "iteration": 2}
    _assert_state_equal(tr, fresh)
    assert int(fresh.model.conv3dbn_1[1].num_batches_tracked) == 2


def test_mid_epoch_crash_and_resume_equals_the_uninterrupted_epoch(tmp_path):
    """One epoch uninterrupted (A); the same epoch with a step checkpoint
    after batch 1 and a 'crash' (B); a fresh trainer resumed from it that
    finishes the epoch (C). C equals A bit for bit (on the CPU, one
    thread)."""
    lst = make_sceneflow_tree(tmp_path, [112] * 6)
    cfg = _cfg(tmp_path)
    cfg = Config(model=cfg.model, train=cfg.train,
                 data=DataConfig(data_path=str(tmp_path), training_list=lst))
    pipe = TrainPipeline(cfg.data, cfg.matching, 32, 64, MAX_DISP, 2, seed=7,
                         num_threads=2)
    a = Trainer(cfg, device="cpu", seed=7)
    avg = a.train_epoch(pipe, epoch=1)
    assert avg["batches"] == 3 and np.isfinite(avg["loss"])

    b = Trainer(cfg, device="cpu", seed=7)
    for i, batch in enumerate(pipe.epoch(1)):
        b.step_fn(batch["board_h"], batch["board_w_left"],
                  batch["board_w_right"])(batch["iml"], batch["imr"],
                                          batch["disp"], 1e-3)
        b.save_step(1, i + 1)
        break
    b.finish_checkpoints()
    path = ck.step_ckpt_path(str(tmp_path), "MS-GCNet", 1)

    c = Trainer(cfg, device="cpu", seed=0)
    meta = c.resume(path)
    assert meta == {"epoch": 1, "iteration": 1}
    avg_c = c.train_epoch(pipe, epoch=1, start_iteration=meta["iteration"])
    assert avg_c["batches"] == 2
    _assert_state_equal(a, c)


def test_ckpt_every_steps_writes_step_files(tmp_path):
    lst = make_sceneflow_tree(tmp_path, [112] * 4)
    base = _cfg(tmp_path, ckpt_every_steps=1)
    cfg = Config(model=base.model, train=base.train,
                 data=DataConfig(data_path=str(tmp_path), training_list=lst))
    pipe = TrainPipeline(cfg.data, cfg.matching, 32, 64, MAX_DISP, 2, seed=1,
                         num_threads=1)
    tr = Trainer(cfg, device="cpu")
    logged = []
    tr.train_epoch(pipe, 1, log_fn=lambda **kw: logged.append(kw["iteration"]))
    tr.finish_checkpoints()
    assert logged == [0, 1]
    for step, it in ((1, 1), (2, 2)):
        p = ck.step_ckpt_path(str(tmp_path), "MS-GCNet", step)
        assert json.load(open(p + ".json")) == {"epoch": 1, "iteration": it}


@pytest.mark.parametrize("prefix", ["", "module."])
def test_reference_tar_loads(tmp_path, prefix):
    """A reference checkpoint ({epoch, state_dict, optimizer, loss, epe_err,
    accu3}, from tests/torch_ref.py's TorchGCNet; a numpy loss as the
    reference may store it; optionally nn.DataParallel's prefix) loads
    non-strictly: weights and BN statistics, optimizer and step untouched."""
    torch.manual_seed(0)
    tm = torch_ref.TorchGCNet(max_disp=MAX_DISP, cin=8, F=4)
    with torch.no_grad():
        for m in tm.modules():
            if isinstance(m, torch.nn.BatchNorm3d):
                m.running_mean.normal_()
                m.running_var.uniform_(0.5, 2.0)
    path = str(tmp_path / "model_epoch_00010.tar")
    torch.save({"epoch": 10,
                "state_dict": {prefix + k: v for k, v in tm.state_dict().items()},
                "optimizer": torch.optim.Adam(tm.parameters()).state_dict(),
                "loss": np.float32(0.5), "epe_err": 1.25, "accu3": 0.75}, path)
    tr = Trainer(_cfg(tmp_path), device="cpu", seed=3)
    tr.resume(path)
    want = tm.state_dict()
    got = tr.model.state_dict()
    assert want.keys() == got.keys()
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    assert tr.step == 0 and not tr.optimizer.state


def test_from_checkpoint_equals_the_server_of_the_same_state_dict(tmp_path):
    cfg = _cfg(tmp_path, async_ckpt=False)
    tr = _stepped(cfg, steps=2)
    path = tr.maybe_save(1, {})
    rng = np.random.default_rng(0)
    iml = rng.integers(0, 256, (60, 120), dtype=np.uint8)
    imr = rng.integers(0, 256, (60, 120), dtype=np.uint8)
    got = StereoServer.from_checkpoint(cfg, path, device="cpu",
                                       depth=3).predict(iml, imr)
    ref = StereoServer(cfg, tr.model.state_dict(), device="cpu").predict(iml, imr)
    np.testing.assert_array_equal(got, ref)


def test_entry_points_without_a_device_raise_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: the default device exists")
    cfg = _cfg(tmp_path, async_ckpt=False)
    path = _stepped(cfg).maybe_save(1, {})
    for build in (lambda: Trainer(cfg),
                  lambda: StereoServer.from_checkpoint(cfg, path)):
        with pytest.raises(RuntimeError, match="cuda"):
            build()
