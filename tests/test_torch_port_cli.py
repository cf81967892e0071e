"""The port's CLI (msnets_tpu_torch.cli) against the JAX package's: the same
parser, the same Config for the same command lines, the dataset and host
flags, and a CPU train -> checkpoint -> test round trip (mirrors the cases
of tests/test_cli.py)."""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from msnets_tpu import cli as jax_cli
from msnets_tpu_torch import cli
from msnets_tpu_torch.data import pfm as pfmio
from msnets_tpu_torch.data.pipeline import TrainPipeline
from msnets_tpu_torch.engine import checkpoint as ck
from msnets_tpu_torch.runtime import fp32_reference

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with fp32_reference():
        yield
    torch.set_num_threads(n)


def _make_tree(root, n=2, h=64, w=128, disp_val=6.0):
    import cv2
    rng = np.random.default_rng(5)
    entries = []
    for i in range(n):
        shift = int(disp_val)
        base = rng.integers(0, 256, (h, w + shift), dtype=np.uint8)
        ldir = root / f"FlyingThings3D/frames_finalpass/TRAIN/A/{i:04d}/left"
        rdir = root / f"FlyingThings3D/frames_finalpass/TRAIN/A/{i:04d}/right"
        ddir = root / f"FlyingThings3D/disparity/TRAIN/A/{i:04d}/left"
        for d in (ldir, rdir, ddir):
            d.mkdir(parents=True, exist_ok=True)
        cv2.imwrite(str(ldir / "0006.png"), base[:, shift:])
        cv2.imwrite(str(rdir / "0006.png"), base[:, :w])
        pfmio.write_pfm(str(ddir / "0006.pfm"),
                        np.full((h, w), disp_val, np.float32))
        entries.append(f"FlyingThings3D/frames_finalpass/TRAIN/A/{i:04d}/left/0006.png")
    lst = root / "list.list"
    lst.write_text("\n".join(entries) + "\n")
    return str(lst)


def _actions(parser):
    return {a.dest: (tuple(a.option_strings), a.default, a.type, a.choices,
                     a.nargs, type(a).__name__)
            for a in parser._actions}


def test_parser_actions_match_jax():
    """Every flag: its option strings, dest, default, type, choices and
    action, so the JAX package's command lines parse unchanged."""
    got, want = _actions(cli.build_parser()), _actions(jax_cli.build_parser())
    assert got.keys() == want.keys()
    for dest in want:
        assert got[dest] == want[dest], dest
    assert cli.build_parser().get_default("remat") is None


COMMAND_LINES = {
    "defaults": [],
    "psmnet": ["--model_name=MS-PSMNet"],
    "psmnet-b2": ["--model_name=MS-PSMNet", "--batchSize=2"],
    "psmnet-b3": ["--model_name=MS-PSMNet", "--batchSize=3"],
    "psmnet-b2-accum4": ["--model_name=MS-PSMNet", "--batchSize=2",
                         "--grad_accum=4"],
    "psmnet-no-remat": ["--model_name=MS-PSMNet", "--no_remat"],
    "remat-hourglass": ["--remat", "--remat_scope=hourglass"],
    "kitti2015": ["--kitti2015=1"],
    "hosts": ["--num_hosts=2", "--host_id=1"],
    "loop-train": ["--mode=loop-train", "--crop_height=64",
                   "--crop_width=128", "--max_disp=32", "--batchSize=2",
                   "--nEpochs=2", "--data_path=/data",
                   "--training_list=t.list", "--test_list=t.list",
                   "--checkpoint_dir=ck", "--train_logdir=", "--threads=2",
                   "--compute_dtype=float32", "--no_remat"],
    "test-16ch": ["--mode=test", "--crop_height=96", "--crop_width=192",
                  "--cbmv_F=16", "--resume=ck/m.tar", "--resultDir=res",
                  "--threshold=1.5"],
    "quant-static-stem": ["--mode=test", "--quant_eval=1",
                          "--quant_mode=static", "--quant_scope=stem"],
    "quant-psmnet": ["--model_name=MS-PSMNet", "--quant_eval=1"],
    "raw": ["--features=raw", "--sf_frames=frames_cleanpass", "--eth3d=1",
            "--lr=0.002", "--startEpoch=3", "--ckpt_every_steps=5",
            "--log_summary_step=10", "--middlebury=1", "--kitti2012=1"],
}


@pytest.mark.parametrize("name", list(COMMAND_LINES))
def test_args_to_config_matches_jax(name):
    """Field by field, every field the port's Config carries."""
    argv = COMMAND_LINES[name] + ["--seed=7"]
    got = dataclasses.asdict(cli.args_to_config(cli.build_parser().parse_args(argv)))
    want = dataclasses.asdict(jax_cli.args_to_config(
        jax_cli.build_parser().parse_args(argv)))
    for section, fields in got.items():
        if isinstance(fields, dict):
            assert fields == {k: want[section][k] for k in fields}, section
        else:
            assert fields == want[section], section


def test_gcnet_volume_is_the_published_width():
    """--model_name GC-Net takes in_channels from its own stage, 2F = 64
    (arXiv:1703.04309 Table 1), not the matching space's 8: its tower is
    32 wide."""
    from msnets_tpu_torch.models import build_model
    cfg = cli.args_to_config(cli.build_parser().parse_args(
        ["--model_name=GC-Net"]))
    assert cfg.model.in_channels == 64
    model = build_model(cfg.model, "cpu")
    assert model.unary.conv_out.out_channels == 32
    assert model.conv3dbn_1[0].in_channels == 64


def test_seed_defaults_from_the_clock():
    c = cli.args_to_config(cli.build_parser().parse_args([]))
    assert 0 <= c.train.seed < 2 ** 31


def test_remat_default_is_model_dependent():
    """As tests/test_cli.py: MS-GCNet without remat; MS-PSMNet at batch >= 2
    without remat and grad_accum = batch, at batch 1 with remat; explicit
    flags override."""
    def cfg(*argv):
        return cli.args_to_config(cli.build_parser().parse_args(list(argv)))
    c = cfg()
    assert c.train.remat is False and c.train.grad_accum == 1
    c = cfg("--model_name=MS-PSMNet", "--batchSize=2")
    assert c.train.remat is False and c.train.grad_accum == 2
    c = cfg("--model_name=MS-PSMNet")
    assert c.train.remat is True and c.train.grad_accum == 1
    c = cfg("--model_name=MS-PSMNet", "--batchSize=3")
    assert c.train.remat is False and c.train.grad_accum == 3
    c = cfg("--model_name=MS-PSMNet", "--batchSize=4")
    assert c.train.remat is False and c.train.grad_accum == 4
    c = cfg("--model_name=MS-PSMNet", "--batchSize=2", "--grad_accum=4")
    assert c.train.remat is True and c.train.grad_accum == 4
    c = cfg("--model_name=MS-PSMNet", "--no_remat")
    assert c.train.remat is False and c.train.grad_accum == 1
    assert cfg("--remat").train.remat is True


def test_dataset_flag_dispatch():
    c = cli.args_to_config(cli.build_parser().parse_args(["--kitti2015=1"]))
    assert c.data.dataset == "kitti2015" and c.data.bad_threshold == 3.0
    c = cli.args_to_config(cli.build_parser().parse_args(["--eth3d=1"]))
    assert c.data.dataset == "eth3d" and c.data.bad_threshold == 1.0


def test_host_shard_flags_reach_pipeline(tmp_path):
    lst = _make_tree(tmp_path, n=5)
    a = cli.build_parser().parse_args(
        ["--num_hosts=2", "--host_id=1", f"--training_list={lst}",
         f"--data_path={tmp_path}"])
    cfg = cli.args_to_config(a)
    assert cfg.train.num_hosts == 2 and cfg.train.host_id == 1
    p = TrainPipeline(cfg.data, cfg.matching, 32, 64, 32, 1,
                      num_hosts=cfg.train.num_hosts,
                      host_id=cfg.train.host_id)
    assert p.steps_per_epoch() == 2     # 5 entries // 2 hosts // batch 1


@pytest.mark.parametrize("argv,error,match", [
    (["--mesh=2,2,2"], ValueError, "--mesh 2,2,2 wants 8 processes, but "
     "this one was started among 1"),
    (["--coordinator=localhost:1234", "--num_hosts=4", "--mesh=1,2,1"],
     ValueError, "--mesh 1,2,1 wants 2 processes, but this one was started "
     "among 4"),
    (["--mode=test", "--quant_eval=1", "--quant_mode=calib"], SystemExit,
     "2")],
    ids=["mesh", "coordinator", "quant_eval"])
def test_unported_flags_raise(argv, error, match):
    """Before any process group forms: "calib" is a ModelConfig quant_mode
    but not among the CLI's --quant_mode choices (as in the JAX CLI:
    calibration is the evaluator's); a training mesh over the spatial and
    disp axes runs (tests/test_torch_port_mesh_train.py), but only among as
    many processes as it has ranks, so one started alone, or among a
    --num_hosts that is not the mesh's size, is told how many to start and
    never waits on the coordinator."""
    with pytest.raises(error, match=match):
        cli.main(argv)


def test_main_runs_on_the_gpu_by_default(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: the default device exists")
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(["--mode=test", f"--resume={tmp_path / 'none.tar'}"])


def test_module_runs_as_a_script():
    out = subprocess.run([sys.executable, "-m", "msnets_tpu_torch.cli",
                          "--help"], cwd=ROOT, capture_output=True,
                         text=True, timeout=120, check=True)
    assert "--model_name" in out.stdout and "eval-badx" in out.stdout


def _tiny(argv):
    """The Config of ``argv`` with 4 base filters (no CLI flag sets them)."""
    c = cli.args_to_config(cli.build_parser().parse_args(argv))
    return dataclasses.replace(c, model=dataclasses.replace(c.model,
                                                            base_filters=4))


def test_run_train_then_run_test(tmp_path):
    """One epoch of 1 batch, its checkpoint, summaries (scalars, image
    grids, matcher probes), then the test mode on that checkpoint."""
    lst = _make_tree(tmp_path)
    ckpt_dir, logdir = tmp_path / "ck", tmp_path / "tb"
    common = ["--max_disp=32", f"--data_path={tmp_path}",
              f"--training_list={lst}", f"--test_list={lst}",
              "--compute_dtype=float32", "--seed=7"]
    logs = []
    tr = cli.run_train(_tiny(common + [
        "--mode=train", "--crop_height=32", "--crop_width=64",
        "--batchSize=2", "--nEpochs=1", f"--checkpoint_dir={ckpt_dir}",
        f"--train_logdir={logdir}", "--log_summary_step=1", "--threads=2",
        "--no_remat"]), device="cpu", log=logs.append)
    ckpt = ck.ckpt_path(str(ckpt_dir), "MS-GCNet", 1)
    assert os.path.exists(ckpt) and tr.step == 1
    assert any("Epoch 1 Complete" in m for m in logs)
    events = [f for f in os.listdir(logdir) if "events" in f]
    assert events and os.path.getsize(logdir / events[0]) > 1000

    res = tmp_path / "results"
    logs = []
    out = cli.run_test(_tiny(common + ["--mode=test", f"--resume={ckpt}",
                                       f"--resultDir={res}"]),
                       device="cpu", log=logs.append)
    assert out["frames"] == 2 and out["threshold"] == 1.0
    assert np.isfinite(out["avg_epe"]) and any("AVG EPE" in m for m in logs)
    assert os.path.exists(res / "0.pfm")
    with pytest.raises(ValueError):
        cli.run_test(_tiny(common + ["--mode=test"]), device="cpu")


def test_run_loop_train_resumes_each_epoch(tmp_path):
    """Each epoch resumes the previous epoch's checkpoint and writes the
    next model_epoch_%05d file."""
    lst = _make_tree(tmp_path)
    ckpt_dir = tmp_path / "ck"
    cli.run_loop_train(_tiny(
        ["--mode=loop-train", "--crop_height=32", "--crop_width=64",
         "--max_disp=32", "--batchSize=2", "--nEpochs=2", "--seed=7",
         f"--data_path={tmp_path}", f"--training_list={lst}",
         f"--checkpoint_dir={ckpt_dir}", "--train_logdir=", "--threads=2",
         "--compute_dtype=float32", "--no_remat"]), device="cpu",
        log=lambda *a: None)
    for ep in (1, 2):
        state, meta = ck.load_checkpoint(ck.ckpt_path(str(ckpt_dir),
                                                      "MS-GCNet", ep))
        assert state["epoch"] == ep and state["step"] == ep


def test_test_mode_runs_static_int8(tmp_path):
    """``python -m msnets_tpu_torch.cli --mode test --quant_eval 1
    --quant_mode static`` on the tiny tree (cli.main, the CLI's F=32): the
    evaluator calibrates on the first frame and scores every frame in
    int8; the logged averages and the PFM are the Evaluator's of the same
    Config and weights, and int8 moves them off the float32 run's."""
    import contextlib
    import io
    from msnets_tpu_torch.engine import Evaluator
    from msnets_tpu_torch.models import MSGCNet
    lst = _make_tree(tmp_path)
    m = MSGCNet(32, 8, 32, generator=torch.Generator().manual_seed(4))
    torch.save({"state_dict": m.state_dict()}, tmp_path / "ref.tar")
    argv = ["--mode=test", "--max_disp=32", f"--data_path={tmp_path}",
            f"--test_list={lst}", f"--resume={tmp_path / 'ref.tar'}",
            "--compute_dtype=float32", "--seed=7", "--quant_eval=1",
            "--quant_mode=static"]
    with contextlib.redirect_stdout(io.StringIO()) as log:
        cli.main(argv + [f"--resultDir={tmp_path / 'int8'}"], device="cpu")
    total = [line for line in log.getvalue().splitlines()
             if "AVG EPE" in line]
    cfg = cli.args_to_config(cli.build_parser().parse_args(
        argv + [f"--resultDir={tmp_path / 'ev'}"]))
    assert (cfg.model.quant_eval, cfg.model.quant_mode) == (True, "static")
    ev = Evaluator(cfg, m.state_dict(), device="cpu")
    out = ev.run(log=lambda *a: None)
    assert out["frames"] == 2 and np.isfinite(out["avg_epe"])
    assert total == [f"===> Total 2 Frames ==> AVG EPE: {out['avg_epe']:.4f}, "
                     f"AVG Bad-1.0: {out['avg_bad']:.4f}"]
    assert ev._calibrated == {(64, 128)}
    np.testing.assert_array_equal(pfmio.read_pfm(str(tmp_path / "int8/0.pfm")),
                                  pfmio.read_pfm(str(tmp_path / "ev/0.pfm")))
    f32 = Evaluator(dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, quant_eval=False)), m.state_dict(), device="cpu").run(
            log=lambda *a: None)
    assert f32["avg_epe"] != out["avg_epe"]
