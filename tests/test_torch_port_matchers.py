"""Port matchers (msnets_tpu_torch.ops.matchers) against the JAX matchers on
the same inputs, at the tolerances of tests/test_matchers.py."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from msnets_tpu.config import INVALID as JAX_INVALID
from msnets_tpu.ops import matchers as JM
from msnets_tpu_torch.config import INVALID
from msnets_tpu_torch.ops import matchers as TM


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, shape, dtype=np.uint8),
            rng.integers(0, 256, shape, dtype=np.uint8))


def _jax(fn, a, b, *args):
    return np.asarray(fn(jnp.asarray(a), jnp.asarray(b), *args))


def _port(fn, a, b, *args):
    return fn(torch.from_numpy(a), torch.from_numpy(b), *args).numpy()


def test_invalid_sentinel_matches():
    assert INVALID == JAX_INVALID


@pytest.mark.parametrize("shape,ndisp,wsize", [
    ((28, 52), 1, 5), ((28, 52), 12, 5), ((28, 52), 1, 11),
    ((28, 52), 12, 11),
    ((8, 8), 4, 11),        # narrower than the window: all INVALID
    ((24, 20), 32, 5),      # ndisp > W
])
def test_census_exact(shape, ndisp, wsize):
    a, b = _pair(shape, 42)
    got = _port(TM.census, a, b, ndisp, wsize)
    np.testing.assert_array_equal(got, _jax(JM.census, a, b, ndisp, wsize))
    if shape == (8, 8):
        assert np.all(got == INVALID)


def test_sobel_exact():
    a, _ = _pair((28, 52), 42)
    np.testing.assert_array_equal(TM.sobel(torch.from_numpy(a)).numpy(),
                                  np.asarray(JM.sobel(jnp.asarray(a))))


def _assert_on_mask(got, ref, atol):
    mask = ref < 1e9
    assert np.array_equal(mask, got < 1e9), "sentinel pattern mismatch"
    np.testing.assert_array_equal(got[~mask], ref[~mask])
    np.testing.assert_allclose(got[mask], ref[mask], atol=atol)


@pytest.mark.parametrize("shape,ndisp", [((28, 52), 1), ((28, 52), 12),
                                         ((24, 20), 32), ((8, 8), 4)])
def test_ncc(shape, ndisp):
    a, b = _pair(shape, 42)
    _assert_on_mask(_port(TM.ncc_nister, a, b, ndisp, 3),
                    _jax(JM.ncc_nister, a, b, ndisp, 3), 3e-6)


def test_ncc_flat_window_is_one():
    a = np.full((16, 24), 7, dtype=np.uint8)
    got = _port(TM.ncc_nister, a, a, 4, 3)
    valid = got < 1e9
    assert valid.any()
    np.testing.assert_array_equal(got[valid], 1.0)
    np.testing.assert_array_equal(got, _jax(JM.ncc_nister, a, a, 4, 3))


@pytest.mark.parametrize("shape,ndisp", [((28, 52), 10), ((24, 20), 32),
                                         ((8, 8), 4)])
def test_zsad(shape, ndisp):
    a, b = _pair(shape, 42)
    _assert_on_mask(_port(TM.zsad, a, b, ndisp, 5),
                    _jax(JM.zsad, a, b, ndisp, 5), 5e-3)


@pytest.mark.parametrize("shape,ndisp", [((28, 52), 10), ((24, 20), 32),
                                         ((8, 8), 4)])
def test_sadsob(shape, ndisp):
    a, b = _pair(shape, 42)
    sl, sr = np.array(JM.sobel(jnp.asarray(a))), np.array(JM.sobel(jnp.asarray(b)))
    _assert_on_mask(_port(TM.sadsob, sl, sr, ndisp, 5),
                    _jax(JM.sadsob, sl, sr, ndisp, 5), 5e-3)


@pytest.mark.parametrize("dim", [-1, 0])
def test_extract_aml(dim):
    rng = np.random.default_rng(3)
    vol = (rng.random((64, 16)) * 100).astype(np.float32)
    vol[rng.random((64, 16)) < 0.15] = INVALID
    vol[0, :] = INVALID                       # fully invalid row -> zeros
    ref = np.asarray(JM.extract_aml(jnp.asarray(vol), 128.0))
    if dim == 0:
        got = TM.extract_aml(torch.from_numpy(vol.T.copy()), 128.0, dim=0).numpy().T
    else:
        got = TM.extract_aml(torch.from_numpy(vol), 128.0).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6)
    assert (got[0] == 0).all()


@pytest.mark.parametrize("ndisp,fill", [(5, 0.0), (30, np.inf)])
def test_shifted_over_disp(ndisp, fill):
    x = np.random.default_rng(5).random((6, 20)).astype(np.float32)
    got = TM.shifted_over_disp(torch.from_numpy(x), ndisp, fill).numpy()
    ref = np.asarray(JM.shifted_over_disp(jnp.asarray(x), ndisp, fill))
    np.testing.assert_array_equal(got, ref)


def test_valid_mask_and_box_valid():
    np.testing.assert_array_equal(
        TM._valid_mask(20, 31, 9, 5, torch.device("cpu")).numpy(),
        JM._valid_mask(20, 31, 9, 5))
    x = np.random.default_rng(6).integers(0, 256, (12, 17, 3)).astype(np.float32)
    np.testing.assert_array_equal(TM._box_valid(torch.from_numpy(x), 5).numpy(),
                                  np.asarray(JM._box_valid(jnp.asarray(x), 5)))
