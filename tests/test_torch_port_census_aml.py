"""census_aml (msnets_tpu_torch.ops.cuda.census_aml): its plain PyTorch
version against the JAX Pallas kernel (interpret mode) and against the JAX
XLA formulation, on the cases of tests/test_pallas.py; the wrapper's input
checks; the kernel build helpers that run without nvcc."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from msnets_tpu.ops import matchers as JM
from msnets_tpu.ops.pallas.census_aml_pallas import census_aml_pallas
from msnets_tpu_torch.ops.cuda import _build
from msnets_tpu_torch.ops.cuda.census_aml import (census_aml,
                                                  census_aml_reference)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(shape, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, shape, dtype=np.uint8),
            rng.integers(0, 256, shape, dtype=np.uint8))


def _hwd(t):
    """port [D, H, W] -> JAX [H, W, D]"""
    return np.transpose(t.numpy(), (1, 2, 0))


CASES = [((20, 40), 8, 4, 128.0),
         ((24, 33), 12, 8, 128.0),     # rows not a multiple of the tile
         ((30, 64), 16, 8, 64.0)]


@pytest.mark.parametrize("shape,ndisp,tile,sigma", CASES)
def test_reference_matches_pallas_interpret(shape, ndisp, tile, sigma):
    a, b = _pair(shape)
    cost, aml = census_aml_reference(torch.from_numpy(a), torch.from_numpy(b),
                                     ndisp, 11, sigma)
    jc, ja = census_aml_pallas(jnp.asarray(a), jnp.asarray(b), ndisp, 11,
                               sigma, tile, True)
    # XLA turns the division by 120 into a reciprocal multiply (1 ulp);
    # the exact comparison of the cost channel is the numpy one below
    np.testing.assert_allclose(_hwd(cost), np.asarray(jc), atol=1e-6)
    np.testing.assert_allclose(_hwd(aml), np.asarray(ja), atol=1e-6)


@pytest.mark.parametrize("shape,ndisp,tile,sigma", CASES + [
    ((24, 20), 32, 8, 128.0)])              # ndisp > W
def test_reference_matches_xla(shape, ndisp, tile, sigma):
    a, b = _pair(shape)
    cost, aml = census_aml(torch.from_numpy(a), torch.from_numpy(b), ndisp,
                           11, sigma)
    ref_c = JM.census(jnp.asarray(a), jnp.asarray(b), ndisp, 11)
    np.testing.assert_array_equal(
        _hwd(cost), np.clip(np.asarray(ref_c), 0, 120) / np.float32(120.0))
    np.testing.assert_allclose(_hwd(aml),
                               np.asarray(JM.extract_aml(ref_c, sigma)),
                               atol=1e-6)


def test_cost_channel_within_one_ulp_of_xla():
    """A known difference: XLA compiles ``clip(c)/120`` into a multiply by
    the reciprocal, the port divides (as numpy does). The two cost channels
    differ by at most one unit in the last place."""
    a, b = _pair((30, 64))
    cost, _ = census_aml(torch.from_numpy(a), torch.from_numpy(b), 16)
    ref_c = JM.census(jnp.asarray(a), jnp.asarray(b), 16, 11)
    xla = np.asarray(jax.jit(lambda v: jnp.clip(v, 0.0, 120.0) / 120.0)(ref_c))
    got = _hwd(cost)
    assert np.all(np.abs(got - xla) <= np.spacing(np.maximum(got, xla)))


def test_all_invalid_when_narrower_than_window():
    a = np.full((12, 8), 7, np.uint8)          # W=8 < censw=11
    b = np.full((12, 8), 9, np.uint8)
    cost, aml = census_aml(torch.from_numpy(a), torch.from_numpy(b), 4)
    assert cost.shape == aml.shape == (4, 12, 8)
    np.testing.assert_array_equal(aml.numpy(), 0.0)
    np.testing.assert_array_equal(cost.numpy(), 1.0)   # clip(INVALID)/120
    jc, ja = census_aml_pallas(jnp.asarray(a), jnp.asarray(b), 4, 11, 128.0,
                               4, True)
    np.testing.assert_array_equal(_hwd(cost), np.asarray(jc))
    np.testing.assert_array_equal(_hwd(aml), np.asarray(ja))


def test_cpu_tensors_take_the_plain_version_without_counting():
    a, b = (torch.from_numpy(x) for x in _pair((20, 40)))
    before = census_aml.launches
    got = census_aml(a, b, 8)
    ref = census_aml_reference(a, b, 8)
    assert census_aml.launches == before
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


@pytest.mark.parametrize("bad,err", [
    (lambda a: a.to(torch.int32), TypeError),
    (lambda a: a[None], ValueError),
    (lambda a: a.t(), ValueError),             # not contiguous
    (lambda a: a[:, :-1], ValueError),         # shape mismatch
])
def test_input_checks(bad, err):
    a, b = (torch.from_numpy(x) for x in _pair((20, 40)))
    with pytest.raises(err):
        census_aml(bad(a), b, 8)


@pytest.mark.parametrize("ndisp,wsize", [(0, 11), (4, 13), (4, 6)])
def test_argument_checks(ndisp, wsize):
    a, b = (torch.from_numpy(x) for x in _pair((20, 40)))
    with pytest.raises(ValueError):
        census_aml(a, b, ndisp, wsize)


def test_build_paths_and_missing_nvcc(monkeypatch, tmp_path):
    assert "census_aml" in _build.kernel_names()
    p = _build.library_path("census_aml")
    assert p.parent == _build.BUILD_DIR and p.name.startswith("libcensus_aml_")
    assert _build.BUILD_DIR.parts[-2:] == ("build", "msnets_tpu_torch")
    assert p == _build.library_path("census_aml")     # stable hash
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(_build, "DEFAULT_NVCC", tmp_path / "nvcc")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()
