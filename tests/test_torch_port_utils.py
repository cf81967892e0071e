"""The port's utility tail against the JAX package's counterparts, on the
same seeded inputs, in float32 on the CPU: utils/profiling.py,
utils/summary.py's matcher_argmin_probe, utils/debug_viz.py,
models/basic_blocks.py (through models/convert.py's 2-D key maps) and
ops/sampling.py."""
import json

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from msnets_tpu.models import basic_blocks as JB
from msnets_tpu.ops import sampling as JSmp
from msnets_tpu.utils import debug_viz as JV
from msnets_tpu.utils import summary as JS
from msnets_tpu.models.torch_convert import convert_state_dict
from msnets_tpu_torch.config import ModelConfig
from msnets_tpu_torch.models import basic_blocks as B
from msnets_tpu_torch.models import build_model
from msnets_tpu_torch.models.convert import (conv_block2d_key_map,
                                             state_dict_from_key_map,
                                             upconv_block2d_key_map)
from msnets_tpu_torch.ops import sampling as Smp
from msnets_tpu_torch.runtime import fp32_reference
from msnets_tpu_torch.utils import debug_viz as V
from msnets_tpu_torch.utils import profiling as P
from msnets_tpu_torch.utils import summary as S


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with fp32_reference():
        yield
    torch.set_num_threads(n)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1)))


# -- profiling ---------------------------------------------------------------

def test_trace_writes_a_chrome_trace_of_the_block(tmp_path):
    with P.trace(str(tmp_path / "t")) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    events = json.loads((tmp_path / "t" / "trace.json").read_text())
    names = {e.get("name") for e in events["traceEvents"]}
    assert any("mm" in str(n) for n in names), sorted(map(str, names))[:20]
    assert any("mm" in e.key for e in prof.key_averages())


def test_debug_nans_names_the_op_that_made_a_nan():
    x = torch.tensor([-1.0], requires_grad=True)
    with P.debug_nans():
        with pytest.raises(RuntimeError, match="nan"):
            torch.sqrt(x).sum().backward()
    assert not torch.is_anomaly_enabled()
    with P.debug_nans(False):
        torch.sqrt(x).sum().backward()             # no check: NaN gradient
    assert torch.isnan(x.grad).all()


def test_device_memory_stats_reads_the_allocator():
    stats = P.device_memory_stats()
    if not torch.cuda.is_available():
        assert stats == {}
        return
    assert set(stats) == {f"cuda:{i}" for i in range(torch.cuda.device_count())}
    assert all("allocated_bytes.all.current" in s for s in stats.values())


# -- summary and debug_viz ---------------------------------------------------

def test_matcher_argmin_probe_is_jaxs_in_the_ports_layout():
    f = np.random.default_rng(0).random((2, 8, 12, 5, 7), dtype=np.float32)
    want = JS.matcher_argmin_probe(np.moveaxis(f, 1, -1))
    for got in (S.matcher_argmin_probe(f),
                S.matcher_argmin_probe(torch.from_numpy(f))):
        assert list(got) == list(want)
        for k in want:
            assert got[k].dtype == np.float32 and got[k].shape == (2, 5, 7)
            np.testing.assert_array_equal(got[k], want[k])


def test_feature_argmin_maps_are_jaxs():
    f = np.random.default_rng(1).random((8, 10, 6, 9), dtype=np.float32)
    want = JV.feature_argmin_maps(f)
    got = V.feature_argmin_maps(torch.from_numpy(f))
    assert list(got) == list(want) == V.FEATURE_NAMES
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_param_counts_are_jaxs(capsys):
    m = build_model(ModelConfig(max_disp=32, base_filters=4), "cpu")
    params = convert_state_dict(m.state_dict(), "MS-GCNet")["params"]
    assert V.count_params(m) == JV.count_params(params) > 0
    V.print_params(m, "p ")
    lines = capsys.readouterr().out.splitlines()
    assert lines[-1] == f"p total: {JV.count_params(params)}"
    assert len(lines) == len(list(m.parameters())) + 1


def test_image_grid_and_feature_probe_save_files(tmp_path, capsys):
    f = np.random.default_rng(2).random((8, 6, 5, 7), dtype=np.float32)
    V.debug_ms_features(f, save_path=str(tmp_path / "f.png"))
    assert (tmp_path / "f.png").stat().st_size > 0
    assert capsys.readouterr().out.count("feature ") == 8
    V.show_image_grid([f[0, 0]] * 3, ["a", "b", "c"], cols=2,
                      save_path=str(tmp_path / "g.png"))
    assert (tmp_path / "g.png").stat().st_size > 0


def test_dataloader_len_is_jaxs(tmp_path):
    p = tmp_path / "l.list"
    p.write_text("a\nb\n\nc\nd\ne\n")
    assert V.dataloader_len(str(p), 2) == JV.dataloader_len(str(p), 2) == 2


# -- basic blocks ------------------------------------------------------------

@pytest.mark.parametrize("maxdisp", [1, 5, 12])
def test_correlation1d_map_matches_jax(maxdisp):
    rng = np.random.default_rng(maxdisp)
    x = rng.normal(0, 1, (2, 6, 9, 4)).astype(np.float32)
    y = rng.normal(0, 1, (2, 6, 9, 4)).astype(np.float32)
    want = np.asarray(JB.correlation1d_map(jnp.asarray(x), jnp.asarray(y),
                                           maxdisp))
    got = B.correlation1d_map(_nchw(x), _nchw(y), maxdisp).numpy()
    assert got.shape == want.shape == (2, maxdisp, 6, 9)
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("D,stride,k", [(4, 1, 1), (5, 2, 3), (12, 1, 3)])
def test_corr1d_matches_jax(D, stride, k):
    """Shifted channel sums, zero fill left of each shift, rows past W zero
    (D=12 > W=9), the 'same' mean filter."""
    rng = np.random.default_rng(D + k)
    a = rng.normal(0, 1, (1, 7, 9, 3)).astype(np.float32)
    b = rng.normal(0, 1, (1, 7, 9, 3)).astype(np.float32)
    want = np.asarray(JB.corr1d(jnp.asarray(a), jnp.asarray(b), D, stride, k))
    got = B.corr1d(_nchw(a), _nchw(b), D, stride, k).numpy()
    assert got.shape == want.shape == (1, D, 7, 9)
    np.testing.assert_allclose(got, want, atol=1e-5)


def _jax_block(block, x, seed):
    """The JAX block's variables with non-identity BN statistics."""
    v = block.init(jax.random.PRNGKey(seed), jnp.asarray(x))
    v = jax.tree.map(np.asarray, dict(v))
    if "batch_stats" in v:
        rng = np.random.default_rng(seed)
        bs = v["batch_stats"]["bn"]
        bs["mean"] = rng.normal(0, 0.3, bs["mean"].shape).astype(np.float32)
        bs["var"] = rng.uniform(0.5, 2.0, bs["var"].shape).astype(np.float32)
        p = v["params"]["bn"]
        p["scale"] = rng.uniform(0.5, 1.5, p["scale"].shape).astype(np.float32)
        p["bias"] = rng.normal(0, 0.2, p["bias"].shape).astype(np.float32)
    return v


def _check_block(jblock, port, key_map, x, seed):
    """Eval and train-mode outputs within 1e-5 of the JAX block's, and the
    BN statistics after the train forward."""
    v = _jax_block(jblock, x, seed)
    port.load_state_dict(state_dict_from_key_map(v, key_map))
    xt = _nchw(x)
    with torch.no_grad():
        got = port.eval()(xt).numpy()
    want = np.moveaxis(np.asarray(jblock.apply(v, jnp.asarray(x))), -1, 1)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5)
    if "batch_stats" not in v:
        return got.shape
    with torch.no_grad():
        got = port.train()(xt).numpy()
    want, upd = jblock.apply(v, jnp.asarray(x), True, mutable=["batch_stats"])
    np.testing.assert_allclose(got, np.moveaxis(np.asarray(want), -1, 1),
                               atol=1e-5)
    np.testing.assert_allclose(port.bn.running_mean.numpy(),
                               upd["batch_stats"]["bn"]["mean"], atol=1e-6)
    np.testing.assert_allclose(port.bn.running_var.numpy(),
                               upd["batch_stats"]["bn"]["var"], atol=1e-6)
    return got.shape


@pytest.mark.parametrize("kernel,stride,use_bn,use_relu,hw", [
    (3, 1, True, True, (8, 10)), (3, 2, True, True, (8, 10)),
    (3, 2, True, False, (7, 9)), (1, 1, False, True, (6, 5)),
    (3, 2, False, False, (9, 8))], ids=str)
def test_conv_block2d_matches_jax(kernel, stride, use_bn, use_relu, hw):
    """flax 'SAME' padding: at stride 2 an even size pads (0, 1), an odd one
    (1, 1); the output is ceil(size / stride)."""
    x = np.random.default_rng(3).normal(0, 1, (2,) + hw + (3,)).astype(np.float32)
    jb = JB.ConvBlock2D(5, kernel, stride, use_bn, use_relu)
    shape = _check_block(jb, B.ConvBlock2D(3, 5, kernel, stride, use_bn,
                                           use_relu),
                         conv_block2d_key_map(use_bn), x, 4)
    assert shape[2:] == tuple(-(-n // stride) for n in hw)


@pytest.mark.parametrize("kernel,use_bn,use_relu", [
    (4, True, True), (3, True, False), (4, False, True), (3, False, False)],
    ids=str)
def test_upconv_block2d_matches_jax(kernel, use_bn, use_relu):
    x = np.random.default_rng(5).normal(0, 1, (2, 5, 7, 4)).astype(np.float32)
    jb = JB.UpconvBlock2D(3, kernel, use_bn, use_relu)
    shape = _check_block(jb, B.UpconvBlock2D(4, 3, kernel, use_bn, use_relu),
                         upconv_block2d_key_map(use_bn), x, 6)
    assert shape == (2, 3, 10, 14)


# -- sampling ----------------------------------------------------------------

def test_sampling_matches_jax_for_one_generator():
    gt = np.random.default_rng(7).integers(0, 65, 500)
    got = Smp.generate_d_indices(gt, 64, 4, np.random.default_rng(8))
    want = JSmp.generate_d_indices(gt, 64, 4, np.random.default_rng(8))
    np.testing.assert_array_equal(got, want)
    vol = np.random.default_rng(9).random((500, 65), dtype=np.float32)
    np.testing.assert_array_equal(Smp.get_samples(vol, got),
                                  JSmp.get_samples(vol, want))
    np.testing.assert_array_equal(Smp.generate_labels(got),
                                  JSmp.generate_labels(want))
    v4 = np.random.default_rng(10).random((3, 4, 5, 2), dtype=np.float32)
    np.testing.assert_array_equal(Smp.get_cost(v4), JSmp.get_cost(v4))
