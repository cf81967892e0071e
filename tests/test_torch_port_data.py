"""Port data modules (msnets_tpu_torch.data: pfm, resolvers, the train
pipeline) against the JAX package's on the same files and seeds: crops,
samples, shards, batch schedules and batches must be equal."""
import dataclasses

import numpy as np
import pytest

from msnets_tpu.config import (DataConfig as JaxDataConfig,
                               MatchingConfig as JaxMC)
from msnets_tpu.data import pfm as JP
from msnets_tpu.data import pipeline as JPipe
from msnets_tpu.data import resolvers as JR
from msnets_tpu_torch.config import DataConfig, MatchingConfig
from msnets_tpu_torch.data import pfm as TP
from msnets_tpu_torch.data import pipeline as TPipe
from msnets_tpu_torch.data import resolvers as TR


def make_sceneflow_tree(root, widths, h=64, shift=6, seed=5):
    """A Scene Flow tree of textured pairs with a constant disparity
    ``shift``, one entry per width in ``widths``; returns the list file."""
    import cv2
    rng = np.random.default_rng(seed)
    entries = []
    for i, w in enumerate(widths):
        base = rng.integers(0, 256, (h, w + shift), dtype=np.uint8)
        stem = f"TRAIN/A/{i:04d}"
        ldir = root / "FlyingThings3D/frames_finalpass" / stem / "left"
        rdir = root / "FlyingThings3D/frames_finalpass" / stem / "right"
        ddir = root / "FlyingThings3D/disparity" / stem / "left"
        for d in (ldir, rdir, ddir):
            d.mkdir(parents=True, exist_ok=True)
        cv2.imwrite(str(ldir / "0006.png"), base[:, :w])
        cv2.imwrite(str(rdir / "0006.png"), base[:, shift:])
        disp = np.full((h, w), float(shift), np.float32)
        disp[0, :3] = np.inf                         # inf -> 0 in the crop
        TP.write_pfm(str(ddir / "0006.pfm"), disp)
        entries.append(f"FlyingThings3D/frames_finalpass/{stem}/left/0006.png")
    lst = root / "train.list"
    lst.write_text("\n".join(entries) + "\n")
    return str(lst)


MAX_DISP, CROP_H, CROP_W = 32, 32, 64
# 112-px images take the full margins; 80-px ones halve bwl to 16
WIDTHS = [112, 112, 80, 112, 80, 112, 112, 80, 112]


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("sf")
    return str(root), make_sceneflow_tree(root, WIDTHS)


def _pipes(tree, num_channels=8, **kw):
    root, lst = tree
    args = (CROP_H, CROP_W, MAX_DISP, 2)
    kw = dict(seed=3, num_threads=2, **kw)
    return (TPipe.TrainPipeline(DataConfig(data_path=root, training_list=lst),
                                MatchingConfig(num_channels=num_channels),
                                *args, **kw),
            JPipe.TrainPipeline(JaxDataConfig(data_path=root, training_list=lst),
                                JaxMC(num_channels=num_channels), *args, **kw))


def _assert_samples_equal(a, b):
    for f in dataclasses.fields(b):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(y, np.ndarray):
            assert x.dtype == y.dtype, f.name
            np.testing.assert_array_equal(x, y, err_msg=f.name)
        else:
            assert x == y, f.name


@pytest.mark.parametrize("w,h,crop_w,crop_h,bwl,bwr,bh,seed,center", [
    (960, 540, 512, 256, 192, 0, 12, 0, False),
    (960, 540, 512, 256, 192, 192, 12, 1, False),
    (600, 400, 512, 256, 192, 0, 12, 2, False),       # margins halve twice
    (600, 400, 512, 256, 192, 192, 12, 3, True),
    (512, 280, 512, 256, 1, 0, 12, 4, False),         # margins halve to 0
])
def test_crop_position_matches_jax(w, h, crop_w, crop_h, bwl, bwr, bh, seed,
                                   center):
    got = TPipe.crop_position(w, h, crop_w, crop_h, bwl, bwr, bh,
                              np.random.default_rng(seed), center)
    ref = JPipe.crop_position(w, h, crop_w, crop_h, bwl, bwr, bh,
                              np.random.default_rng(seed), center)
    assert got == ref


def test_crop_position_rejects_narrow_images():
    for mod in (TPipe, JPipe):
        with pytest.raises(ValueError):
            mod.crop_position(500, 300, 512, 256, 192, 0, 12, None, True)


@pytest.mark.parametrize("index,left_only,center", [
    (0, True, False), (2, True, False), (1, False, False), (0, True, True)])
def test_make_train_sample_matches_jax(tree, index, left_only, center):
    root, lst = tree
    entry = open(lst).read().split()[index]
    paths = TR.resolve("sceneflow", root, entry)
    assert paths == JR.resolve("sceneflow", root, entry)
    got = TPipe.make_train_sample(*paths, CROP_H, CROP_W, MAX_DISP,
                                  MatchingConfig(), np.random.default_rng(9),
                                  center, left_only)
    ref = JPipe.make_train_sample(*paths, CROP_H, CROP_W, MAX_DISP, JaxMC(),
                                  np.random.default_rng(9), center, left_only)
    _assert_samples_equal(got, ref)
    assert got.iml.shape == (CROP_H + 24, CROP_W + got.board_w_left
                             + got.board_w_right)


@pytest.mark.parametrize("left_only", [True, False])
def test_dummy_sample_matches_jax(left_only):
    _assert_samples_equal(
        TPipe.make_dummy_train_sample(CROP_H, CROP_W, MAX_DISP,
                                      MatchingConfig(), left_only),
        JPipe.make_dummy_train_sample(CROP_H, CROP_W, MAX_DISP, JaxMC(),
                                      left_only))


@pytest.mark.parametrize("hosts", [1, 2])
def test_shards_and_batch_schedule_match_jax(tree, hosts):
    for host in range(hosts):
        t, j = _pipes(tree, num_hosts=hosts, host_id=host)
        assert t.steps_per_epoch() == j.steps_per_epoch()
        for epoch in (1, 2):
            assert t.shard_entries(epoch) == j.shard_entries(epoch)
            assert t.batch_schedule(epoch) == j.batch_schedule(epoch)
        assert t.geometry_for_width(80) == j.geometry_for_width(80) == (12, 16, 0)


@pytest.mark.parametrize("start,channels", [(0, 8), (1, 8), (0, 16)])
def test_epoch_batches_match_jax(tree, start, channels):
    t, j = _pipes(tree, num_channels=channels)
    got, ref = list(t.epoch(1, start)), list(j.epoch(1, start))
    assert len(got) == len(ref) > 0
    for a, b in zip(got, ref):
        assert a.keys() == b.keys()
        for k in b:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_map_dataset_matches_jax(tree):
    t, j = _pipes(tree)
    td, jd = TPipe.MapDataset(t, 1), JPipe.MapDataset(j, 1)
    assert len(td) == len(jd) == len(WIDTHS)
    for key in (0, 3, -1, (2, 4)):
        _assert_samples_equal(td[key], jd[key])
    with pytest.raises(IndexError):
        td[len(WIDTHS)]


def test_image_width_matches_jax(tree):
    root, lst = tree
    for entry in open(lst).read().split():
        p = TR.resolve("sceneflow", root, entry)[0]
        assert TPipe.image_width(p) == JPipe.image_width(p)


def test_pfm_round_trip_matches_jax(tmp_path):
    rng = np.random.default_rng(0)
    for shape in ((5, 7), (4, 6, 3)):
        img = rng.normal(size=shape).astype(np.float32)
        TP.write_pfm(str(tmp_path / "t.pfm"), img)
        JP.write_pfm(str(tmp_path / "j.pfm"), img)
        assert (tmp_path / "t.pfm").read_bytes() == (tmp_path / "j.pfm").read_bytes()
        np.testing.assert_array_equal(TP.read_pfm(str(tmp_path / "t.pfm")), img)


@pytest.mark.parametrize("dataset", ["sceneflow", "kitti2012", "kitti2015",
                                     "eth3d", "middlebury"])
def test_resolvers_match_jax(dataset):
    entry = ("FlyingThings3D/frames_finalpass/TRAIN/A/0001/left/0006.png"
             if dataset == "sceneflow" else "000001_10.png")
    for clean in (False, True):
        if dataset == "sceneflow":
            assert TR.resolve(dataset, "/d", entry, clean) == \
                JR.resolve(dataset, "/d", entry, clean)
        else:
            assert TR.resolve(dataset, "/d", entry) == JR.resolve(dataset, "/d", entry)
    assert TR.result_name(dataset, entry, 7) == JR.result_name(dataset, entry, 7)
    with pytest.raises(ValueError):
        TR.resolve("other", "/d", entry)


def test_data_config_matches_jax():
    for kw in ({}, {"kitti2015": True}, {"eth3d": True}):
        t, j = DataConfig(**kw), JaxDataConfig(**kw)
        assert (t.dataset, t.bad_threshold) == (j.dataset, j.bad_threshold)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)


@pytest.mark.parametrize("left_only", [True, False])
def test_synthetic_train_batch_has_its_disparity(left_only):
    b = TPipe.synthetic_train_batch(CROP_H, CROP_W, MAX_DISP, MatchingConfig(),
                                    2, 7, 0, left_only)
    bwr = 0 if left_only else MAX_DISP
    assert b["iml"].shape == b["imr"].shape == (2, CROP_H + 24,
                                                CROP_W + MAX_DISP + bwr)
    assert (b["board_h"], b["board_w_left"], b["board_w_right"]) == (12, MAX_DISP, bwr)
    np.testing.assert_array_equal(b["iml"][:, :, 7:], b["imr"][:, :, :-7])
    assert b["disp"].shape == (2, CROP_H, CROP_W) and (b["disp"] == 7).all()
