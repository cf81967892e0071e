"""The port's evaluator (msnets_tpu_torch.engine.evaluator) against the JAX
Evaluator on the same files and converted weights, float32 on the CPU:
Scene Flow and KITTI trees written with OpenCV, frames that pad (60x120 to
64x128), missing ground truth, eval_bad_x's re-scoring and the colour
PNGs."""
import os
import shutil
from dataclasses import replace

import numpy as np
import pytest
import torch

from msnets_tpu.config import (Config as JaxConfig, DataConfig as JaxDataConfig,
                               EvalConfig as JaxEvalConfig,
                               ModelConfig as JaxModelConfig)
from msnets_tpu.engine import Evaluator as JaxEvaluator
from msnets_tpu.engine import eval_bad_x as jax_eval_bad_x
from msnets_tpu.models.torch_convert import convert_state_dict
from msnets_tpu.utils import colormap as JC
from msnets_tpu_torch.config import Config, DataConfig, EvalConfig, ModelConfig
from msnets_tpu_torch.data import pfm as pfmio
from msnets_tpu_torch.engine import Evaluator, dataset_threshold, eval_bad_x
from msnets_tpu_torch.models import MSGCNet
from msnets_tpu_torch.runtime import fp32_reference

H, W, SHIFT = 60, 120, 6
MAX_DISP, F = 32, 4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with fp32_reference():
        yield
    torch.set_num_threads(n)


def _frame(rng):
    base = rng.integers(0, 256, (H, W + SHIFT), dtype=np.uint8)
    gt = np.full((H, W), float(SHIFT), np.float32)
    gt[:, :SHIFT] = np.inf                  # occluded band: inf -> 0, masked
    return base[:, SHIFT:], base[:, :W], gt


def _sceneflow_tree(root, n=3):
    import cv2
    rng = np.random.default_rng(5)
    entries = []
    for i in range(n):
        left, right, gt = _frame(rng)
        d = f"FlyingThings3D/frames_finalpass/TRAIN/A/{i:04d}"
        for sub in ("left", "right"):
            (root / d / sub).mkdir(parents=True, exist_ok=True)
        (root / f"FlyingThings3D/disparity/TRAIN/A/{i:04d}/left").mkdir(
            parents=True, exist_ok=True)
        cv2.imwrite(str(root / d / "left/0006.png"), left)
        cv2.imwrite(str(root / d / "right/0006.png"), right)
        pfmio.write_pfm(str(root / f"FlyingThings3D/disparity/TRAIN/A/{i:04d}"
                            "/left/0006.pfm"), gt)
        entries.append(f"{d}/left/0006.png")
    lst = root / "sf.list"
    lst.write_text("\n".join(entries) + "\n")
    return str(lst)


def _kitti_tree(root, n=2):
    import cv2
    rng = np.random.default_rng(9)
    for d in ("image_0", "image_1", "disp_occ_0_pfm"):
        (root / d).mkdir(parents=True, exist_ok=True)
    entries = []
    for i in range(n):
        left, right, gt = _frame(rng)
        name = f"{i:06d}_10.png"
        cv2.imwrite(str(root / "image_0" / name), left)
        cv2.imwrite(str(root / "image_1" / name), right)
        pfmio.write_pfm(str(root / "disp_occ_0_pfm" / (name[:-4] + ".pfm")), gt)
        entries.append(name)
    lst = root / "kt15.list"
    lst.write_text("\n".join(entries) + "\n")
    return str(lst)


@pytest.fixture(scope="module")
def state_dict():
    m = MSGCNet(MAX_DISP, 8, F, generator=torch.Generator().manual_seed(3))
    rng = np.random.default_rng(4)
    with torch.no_grad():
        for bn in m.modules():
            if isinstance(bn, torch.nn.BatchNorm3d):
                c = bn.num_features
                bn.weight.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, c).astype(np.float32)))
                bn.running_var.copy_(torch.from_numpy(rng.uniform(0.5, 2.0, c).astype(np.float32)))
    return m.state_dict()


def _configs(root, lst, kitti=False, save_color=False, result="results"):
    data = dict(data_path=str(root), test_list=lst, kitti2015=kitti)
    ev = dict(result_dir=str(root / result), save_color=save_color)
    port = Config(model=ModelConfig(max_disp=MAX_DISP, base_filters=F,
                                    compute_dtype="float32"),
                  data=DataConfig(**data), eval=EvalConfig(**ev))
    jax_cfg = JaxConfig(model=JaxModelConfig(max_disp=MAX_DISP, base_filters=F,
                                             compute_dtype="float32"),
                        data=JaxDataConfig(**data),
                        eval=JaxEvalConfig(result_dir=str(root / (result + "_jax")),
                                           save_color=save_color))
    return port, jax_cfg


def _both(port_cfg, jax_cfg, sd):
    plog, jlog = [], []
    got = Evaluator(port_cfg, sd, device="cpu").run(log=plog.append)
    want = JaxEvaluator(jax_cfg, convert_state_dict(
        {k: v.clone() for k, v in sd.items()}, "MS-GCNet")).run(log=jlog.append)
    return got, want, plog, jlog


def _same_scores(got, want):
    assert got["frames"] == want["frames"]
    assert got["threshold"] == want["threshold"]
    assert got["avg_epe"] == pytest.approx(want["avg_epe"], abs=1e-4)
    assert got["avg_bad"] == pytest.approx(want["avg_bad"], abs=1e-4)


@pytest.fixture(scope="module")
def sceneflow(tmp_path_factory, state_dict):
    root = tmp_path_factory.mktemp("sf")
    lst = _sceneflow_tree(root)
    port_cfg, jax_cfg = _configs(root, lst)
    return root, port_cfg, jax_cfg, _both(port_cfg, jax_cfg, state_dict)


def test_sceneflow_run_matches_jax(sceneflow):
    """Frames, threshold 1.0 and the averages; Scene Flow saves the PFM of
    every 50th frame: 0.pfm only, equal to JAX's to 2e-3."""
    _, port_cfg, jax_cfg, (got, want, _, _) = sceneflow
    _same_scores(got, want)
    assert got["frames"] == 3 and got["threshold"] == 1.0
    assert sorted(os.listdir(port_cfg.eval.result_dir)) == ["0.pfm"]
    d = pfmio.read_pfm(os.path.join(port_cfg.eval.result_dir, "0.pfm"))
    ref = pfmio.read_pfm(os.path.join(jax_cfg.eval.result_dir, "0.pfm"))
    assert d.shape == ref.shape == (H, W)
    np.testing.assert_allclose(d, ref, atol=2e-3)


def test_frame_log_lines_match_jax(sceneflow):
    *_, (_, _, plog, jlog) = sceneflow
    assert len(plog) == len(jlog) == 2           # frame 0 and the total
    assert plog[-1].startswith("===> Total 3 Frames ==> AVG EPE:")


def test_missing_gt_is_excluded_like_jax(sceneflow, state_dict, tmp_path):
    """A frame without its GT file: averaged over the other two, with the
    warning naming it, as in JAX."""
    root = tmp_path / "missing"
    shutil.copytree(sceneflow[0], root,
                    ignore=shutil.ignore_patterns("results*"))
    gone = "FlyingThings3D/disparity/TRAIN/A/0001/left/0006.pfm"
    os.remove(root / gone)
    port_cfg, jax_cfg = _configs(root, str(root / "sf.list"))
    got, want, plog, jlog = _both(port_cfg, jax_cfg, state_dict)
    _same_scores(got, want)
    assert got["frames"] == 2
    warn = [m for m in plog if m.startswith("WARNING")]
    assert warn == [m for m in jlog if m.startswith("WARNING")]
    assert "1 of 3 frames have no GT" in warn[0] and "0001" in warn[0]


@pytest.fixture(scope="module")
def kitti(tmp_path_factory, state_dict):
    root = tmp_path_factory.mktemp("kt15")
    lst = _kitti_tree(root)
    port_cfg, jax_cfg = _configs(root, lst, kitti=True, save_color=True)
    return root, port_cfg, jax_cfg, _both(port_cfg, jax_cfg, state_dict)


def test_kitti_run_matches_jax_at_threshold_3(kitti):
    """KITTI: threshold 3.0, a PFM for every frame, named after its entry."""
    root, port_cfg, jax_cfg, (got, want, _, _) = kitti
    _same_scores(got, want)
    assert got["threshold"] == 3.0 == dataset_threshold(port_cfg.data)
    for name in ("000000_10.pfm", "000001_10.pfm"):
        d = pfmio.read_pfm(os.path.join(port_cfg.eval.result_dir, name))
        ref = pfmio.read_pfm(os.path.join(jax_cfg.eval.result_dir, name))
        np.testing.assert_allclose(d, ref, atol=2e-3)


def test_kitti_colour_pngs_are_the_jax_colorizers(kitti):
    """dispColor/ and errDispColor/ hold what the JAX colorizers make of the
    saved disparity and the GT, pixel for pixel."""
    import cv2
    root, port_cfg, _, _ = kitti
    res = port_cfg.eval.result_dir
    for name in ("000000_10", "000001_10"):
        disp = pfmio.read_pfm(os.path.join(res, name + ".pfm"))
        gt = pfmio.read_pfm(str(root / "disp_occ_0_pfm" / (name + ".pfm")))
        gt[gt == np.inf] = 0.0
        png = cv2.imread(os.path.join(res, "dispColor", name + ".png"))[:, :, ::-1]
        np.testing.assert_array_equal(
            png, JC.kt15_false_color(disp).astype(np.uint8))
        err = cv2.imread(os.path.join(res, "errDispColor", name + ".png"))[:, :, ::-1]
        np.testing.assert_array_equal(
            err, JC.kt15_error_log_color(disp, gt).astype(np.uint8))


def test_eval_bad_x_rescores_like_jax(kitti, tmp_path):
    """eval_bad_x (at EvalConfig's threshold, 3.0) on the PFMs the run
    saved: the run's averages, JAX's eval_bad_x on the same files, and the
    same again from disp-pfm/."""
    root, port_cfg, jax_cfg, (got, _, _, _) = kitti
    res = port_cfg.eval.result_dir
    out = eval_bad_x(replace(port_cfg, eval=EvalConfig(result_dir=res)),
                     log=lambda *a: None)
    jcfg = replace(jax_cfg, eval=JaxEvalConfig(result_dir=res))
    ref = jax_eval_bad_x(jcfg, log=lambda *a: None)
    assert out["frames"] == ref["frames"] == 2
    for k in ("avg_epe", "avg_bad"):
        assert out[k] == pytest.approx(ref[k], abs=1e-6)
        assert out[k] == pytest.approx(got[k], abs=1e-6)
    moved = tmp_path / "res"
    (moved / "disp-pfm").mkdir(parents=True)
    for name in ("000000_10.pfm", "000001_10.pfm"):
        shutil.copy(os.path.join(res, name), moved / "disp-pfm" / name)
    again = eval_bad_x(replace(port_cfg, eval=EvalConfig(result_dir=str(moved))),
                       log=lambda *a: None)
    assert again == out


def test_dataset_thresholds():
    assert dataset_threshold(DataConfig()) == 1.0
    assert dataset_threshold(DataConfig(kitti2012=True)) == 3.0
    assert dataset_threshold(DataConfig(eth3d=True)) == 1.0
    assert dataset_threshold(DataConfig(middlebury=True)) == 1.0


def test_evaluator_rejects_quant_eval(state_dict):
    with pytest.raises(NotImplementedError):
        Evaluator(Config(model=ModelConfig(quant_eval=True)), state_dict,
                  device="cpu")
