"""census (msnets_tpu_torch.ops.cuda.census): its plain PyTorch version
against the JAX Pallas kernel ``census_pallas`` (interpret mode) and against
the numpy oracle, exactly, on the cases of tests/test_pallas.py and at the
edges; the wrapper's input checks and launch count."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from msnets_tpu.ops import oracle_np as O
from msnets_tpu.ops.pallas.census_pallas import census_pallas
from msnets_tpu_torch.config import INVALID
from msnets_tpu_torch.ops.cuda import _build
from msnets_tpu_torch.ops.cuda.census import census, census_reference


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(shape, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, shape, dtype=np.uint8),
            rng.integers(0, 256, shape, dtype=np.uint8))


def _hwd(t):
    """port [D, H, W] -> JAX [H, W, D]"""
    return np.transpose(t.numpy(), (1, 2, 0))


CASES = [((20, 40), 5, 8, 4),
         ((24, 33), 5, 12, 8),     # rows not a multiple of the tile
         ((30, 64), 11, 16, 8),
         ((24, 20), 11, 32, 8),    # ndisp > W
         ((12, 8), 11, 4, 4)]      # W < window: all INVALID


@pytest.mark.parametrize("shape,wsize,ndisp,tile", CASES)
def test_reference_matches_pallas_interpret_and_oracle(shape, wsize, ndisp,
                                                       tile):
    a, b = _pair(shape)
    got = census_reference(torch.from_numpy(a), torch.from_numpy(b), ndisp,
                           wsize)
    assert got.shape == (ndisp,) + shape and got.is_contiguous()
    with pltpu.force_tpu_interpret_mode():
        pallas = np.asarray(census_pallas(jnp.asarray(a), jnp.asarray(b),
                                          ndisp, wsize, tile))
    np.testing.assert_array_equal(_hwd(got), pallas)
    if shape[1] < wsize:       # the oracle's windows do not fit the image
        assert bool((got == INVALID).all())
    else:
        np.testing.assert_array_equal(_hwd(got), O.census(a, b, ndisp, wsize))


def test_cpu_tensors_take_the_plain_version_without_counting():
    a, b = (torch.from_numpy(x) for x in _pair((20, 40)))
    before = census.launches
    got = census(a, b, 8)
    assert census.launches == before
    assert torch.equal(got, census_reference(a, b, 8))


@pytest.mark.parametrize("bad,err", [
    (lambda a: a.to(torch.int32), TypeError),
    (lambda a: a[None], ValueError),
    (lambda a: a.t(), ValueError),             # not contiguous
    (lambda a: a[:, :-1], ValueError),         # shape mismatch
])
def test_input_checks(bad, err):
    a, b = (torch.from_numpy(x) for x in _pair((20, 40)))
    with pytest.raises(err):
        census(bad(a), b, 8)


@pytest.mark.parametrize("ndisp,wsize", [(0, 11), (4, 13), (4, 6)])
def test_argument_checks(ndisp, wsize):
    a, b = (torch.from_numpy(x) for x in _pair((20, 40)))
    with pytest.raises(ValueError):
        census(a, b, ndisp, wsize)


def test_build_names_both_kernels_and_hashes_the_shared_header():
    # both census kernels, the 8-channel matchers, the int8 conv and
    # quantize of the int8 eval, and MS-GCNet's serving head
    assert _build.kernel_names() == ["census", "census_aml", "int8_conv3d",
                                     "int8_quantize", "matchers_aml",
                                     "subpixel_soft_argmin"]
    assert (_build.CSRC_DIR / "census_common.cuh").is_file()
    p = _build.library_path("census")
    assert p.name.startswith("libcensus_") and p != _build.library_path(
        "census_aml")
