"""matchers_aml (msnets_tpu_torch.ops.cuda.matchers_aml): its plain PyTorch
version against the formulation it was moved from (the costs computed and
trimmed, then normalized and stacked) bit for bit, and against the JAX
package's 8-channel volume; the wrapper's input checks; the CPU dispatch and
its launch counter; the kernel's build paths."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from msnets_tpu.config import MatchingConfig as JaxMatchingConfig
from msnets_tpu.ops import features as JF
from msnets_tpu_torch.config import MatchingConfig
from msnets_tpu_torch.ops import matchers as M
from msnets_tpu_torch.ops.cuda import _build
from msnets_tpu_torch.ops.cuda.census_aml import census_aml
from msnets_tpu_torch.ops.cuda.matchers_aml import (matchers_aml,
                                                    matchers_aml_reference)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(shape, seed):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8)),
            torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8)))


def _separate_steps(iml, imr, D, cfg, bh, bwl, bwr, out_dtype):
    """The 8-channel volume as the feature stage built it from separate
    steps: each matcher's [H, W, D] cost permuted and trimmed, then the
    clip normalizations, the AMLs over dim 0 and the cast stack."""
    H, W = iml.shape

    def trim(v):
        return v[:, bh:(H - bh if bh > 0 else H),
                 bwl:(W - bwr if bwr > 0 else W)]

    cen_cost, cen_aml = (trim(v) for v in census_aml(iml, imr, D, cfg.censw,
                                                    cfg.cens_sigma))
    c_ncc = trim(M.ncc_nister(iml, imr, D, cfg.nccw).permute(2, 0, 1))
    c_sad = trim(M.zsad(iml, imr, D, cfg.sadw).permute(2, 0, 1))
    c_sob = trim(M.sadsob(M.sobel(iml), M.sobel(imr), D,
                          cfg.sobelw).permute(2, 0, 1))
    t13 = 2.0 ** 13
    ch = [cen_cost,
          (1.0 + torch.clamp(c_ncc, -1.0, 1.0)) / 2.0,
          M._div_const(torch.clamp(c_sob, 0.0, t13), t13),
          M._div_const(torch.clamp(c_sad, 0.0, t13), t13),
          cen_aml,
          M.extract_aml(c_ncc, cfg.ncc_sigma, dim=0),
          M.extract_aml(c_sob, cfg.sad_sigma, dim=0),
          M.extract_aml(c_sad, cfg.sad_sigma, dim=0)]
    return torch.stack([c.to(out_dtype) for c in ch], dim=0)


def _ours(iml, imr, D, cfg, bh, bwl, bwr, out_dtype=torch.float32):
    cen = census_aml(iml, imr, D, cfg.censw, cfg.cens_sigma)
    return matchers_aml(iml, imr, *cen, D, cfg.nccw, cfg.sadw, cfg.sobelw,
                        cfg.ncc_sigma, cfg.sad_sigma, bh, bwl, bwr, out_dtype)


# the shapes of tests/test_torch_port_features.py at the working resolution:
# ms_features_test's 64x128 pair (32x64 plus its 10-px pad), the asymmetric
# margins, the train crop (board 6, left margin D); then the edges
CASES = {
    "test_path": ((52, 84), 16, (10, 10, 10)),
    "margins": ((30, 64), 16, (5, 6, 0)),
    "train": ((28, 48), 16, (6, 16, 0)),
    "ndisp_gt_w": ((12, 9), 20, (0, 0, 0)),
    "h_below_window": ((4, 40), 8, (0, 0, 0)),
    "w_below_window": ((40, 4), 8, (0, 0, 0)),
    "one_valid_column": ((20, 6), 8, (0, 0, 0)),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", list(CASES))
def test_reference_equals_the_separate_steps(case, dtype):
    shape, D, margins = CASES[case]
    a, b = _pair(shape, 3)
    cfg = MatchingConfig()
    got = _ours(a, b, D, cfg, *margins, dtype)
    assert got.dtype == dtype
    assert torch.equal(got, _separate_steps(a, b, D, cfg, *margins, dtype))


@pytest.mark.parametrize("case", list(CASES))
def test_reference_matches_jax(case):
    shape, D, margins = CASES[case]
    a, b = _pair(shape, 4)
    got = _ours(a, b, D, MatchingConfig(), *margins)
    ref = np.asarray(JF.to_ncdhw(JF.ms_features(
        jnp.asarray(a.numpy()), jnp.asarray(b.numpy()), D,
        JaxMatchingConfig(), *margins, True)))
    assert tuple(got.shape) == ref.shape
    # the tolerance of the port's other feature tests; the census and the
    # clip-normalized SAD channels are exact
    np.testing.assert_allclose(got.numpy(), ref, atol=5e-6)
    for c in (0, 2, 3):
        np.testing.assert_array_equal(got[c].numpy(), ref[c])


def test_flat_image_takes_the_ncc_cost_one_rule():
    """A flat window has n*B - A^2 = 0: C is not finite and the NCC cost
    is 1, so channel 1 is 1 wherever the cost is valid or INVALID."""
    a = torch.full((16, 40), 77, dtype=torch.uint8)
    b = torch.full((16, 40), 90, dtype=torch.uint8)
    got = _ours(a, b, 8, MatchingConfig(), 0, 0, 0)
    assert bool((got[1] == 1.0).all())
    ref = np.asarray(JF.to_ncdhw(JF.ms_features(
        jnp.asarray(a.numpy()), jnp.asarray(b.numpy()), 8,
        JaxMatchingConfig(), 0, 0, 0, True)))
    np.testing.assert_allclose(got.numpy(), ref, atol=5e-6)


def test_cpu_tensors_take_the_plain_version_without_counting():
    a, b = _pair((30, 64), 5)
    cen = census_aml(a, b, 16)
    before = matchers_aml.launches
    got = matchers_aml(a, b, *cen, 16, board_h=5, board_w_left=6,
                       out_dtype=torch.bfloat16)
    assert matchers_aml.launches == before
    ref = matchers_aml_reference(a, b, *cen, 16, board_h=5, board_w_left=6,
                                 out_dtype=torch.bfloat16)
    assert torch.equal(got, ref) and tuple(got.shape) == (8, 16, 20, 58)


def _args():
    a, b = _pair((20, 40), 6)
    cost, aml = census_aml(a, b, 8)
    return [a, b, cost, aml]


@pytest.mark.parametrize("bad", [
    "mixed_devices", "iml_int32", "imr_float", "not_contiguous",
    "pair_shapes", "census_shape", "census_dtype", "census_not_contiguous",
])
def test_input_checks(bad):
    args = _args()
    if bad == "mixed_devices":
        args[2] = torch.empty(args[2].shape, device="meta")
    elif bad == "iml_int32":
        args[0] = args[0].to(torch.int32)
    elif bad == "imr_float":
        args[1] = args[1].float()
    elif bad == "not_contiguous":
        args[0] = args[0].t().contiguous().t()
    elif bad == "pair_shapes":
        args[1] = args[1][:, :-1].contiguous()
    elif bad == "census_shape":
        args[2] = args[2][:4].contiguous()
    elif bad == "census_dtype":
        args[3] = args[3].double()
    else:
        args[3] = args[3].transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError):
        matchers_aml(*args, 8)


@pytest.mark.parametrize("kw", [
    {"ndisp": 0}, {"sadw": 4}, {"board_h": 10}, {"board_w_left": -1},
    {"board_w_left": 20, "board_w_right": 20},
], ids=["ndisp0", "even_window", "rows_trimmed_away", "negative_margin",
        "cols_trimmed_away"])
def test_argument_checks(kw):
    a, b, cost, aml = _args()
    kw = {"ndisp": 8, **kw}
    if kw["ndisp"] != 8:                          # census planes of that D
        cost, aml = cost[:0], aml[:0]
    with pytest.raises(ValueError):
        matchers_aml(a, b, cost, aml, **kw)


def test_pair_smaller_than_the_windows_is_refused():
    """The plain version needs H, W >= window - 1 (an empty box sum); below
    that both devices refuse the pair."""
    a, b = _pair((3, 40), 7)
    cost, aml = census_aml(a, b, 8)
    with pytest.raises(ValueError, match="smaller"):
        matchers_aml(a, b, cost, aml, 8)


def test_build_paths():
    assert "matchers_aml" in _build.kernel_names()
    p = _build.library_path("matchers_aml")
    assert p.parent == _build.BUILD_DIR
    assert p.name.startswith("libmatchers_aml_")
    assert p == _build.library_path("matchers_aml")     # stable hash
