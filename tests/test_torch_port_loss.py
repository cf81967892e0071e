"""Port losses and metrics (msnets_tpu_torch.engine.loss) against the JAX
package's, jitted, on the same float32 inputs.

Tolerances:
  * exact (bitwise) where the arithmetic allows it: the elementwise terms
    (the port multiplies by the float32 reciprocal where XLA does), masks,
    empty masks, and every loss and metric on inputs on a 1/8 grid, whose
    terms and partial sums are all exact in float32, so the order of the
    sum cannot matter;
  * on random inputs a masked mean sums its terms in another order than
    XLA (which picks it by shape), so port and JAX are each held within the
    float32 summation bound of a float64 reference, (n - 1) * 2^-24 *
    sum|term| over the count, plus 1 ulp."""
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from msnets_tpu.engine import loss as JL
from msnets_tpu_torch.engine import loss as TL

MAX_DISP = 32


def _case(seed=0, shape=(2, 8, 16)):
    """Predictions and targets spread over every piece of my_loss2, with
    targets at 0 and at max_disp (outside the train mask) and outside it."""
    rng = np.random.default_rng(seed)
    gt = rng.uniform(-2, MAX_DISP + 2, shape).astype(np.float32)
    gt.reshape(-1)[:6] = [0, 0, MAX_DISP, MAX_DISP, 0.001, 0.0005]
    pred = (gt + rng.uniform(-8, 8, shape)).astype(np.float32)
    return pred, gt, (gt - MAX_DISP) * gt < 0


def _grid_case(seed=0, shape=(2, 8, 16)):
    """``_case`` on a 1/8 grid: |err| <= 8, so every term of every loss with
    a power-of-two thresh and alpha is a multiple of 2^-8 below 2^4, and any
    sum of 256 of them is exact in float32."""
    rng = np.random.default_rng(seed)
    gt = (rng.integers(-16, 8 * (MAX_DISP + 2), shape) / 8).astype(np.float32)
    gt.reshape(-1)[:4] = [0, 0, MAX_DISP, MAX_DISP]
    pred = (gt + rng.integers(-64, 65, shape) / 8).astype(np.float32)
    return pred, gt, (gt - MAX_DISP) * gt < 0


def _both(name, *arrays, **static):
    jf = jax.jit(functools.partial(getattr(JL, name), **static))
    ref = jax.tree.map(np.asarray, jf(*(jnp.asarray(a) for a in arrays)))
    got = getattr(TL, name)(*(torch.from_numpy(np.asarray(a)) for a in arrays),
                            **static)
    got = jax.tree.map(lambda t: t.numpy(), got)
    return got, ref


LOSSES = {
    "smooth_l1": ("smooth_l1", {}),
    "my_loss2": ("my_loss2", {}),
    "my_loss2_t1.5_a0.5": ("my_loss2", {"thresh": 1.5, "alpha": 0.5}),
    "epe": ("epe", {}),
    "gcnet_sceneflow": ("gcnet_loss", {"is_kitti": False}),
    "gcnet_kitti": ("gcnet_loss", {"is_kitti": True}),
    "gcnet_kitti_t2_a1": ("gcnet_loss", {"is_kitti": True, "thresh": 2.0,
                                         "alpha": 1.0}),
}


# power-of-two thresh and alpha keep my_loss2's terms on the grid
GRID_LOSSES = {
    "smooth_l1": ("smooth_l1", {}),
    "my_loss2_t2_a2": ("my_loss2", {"thresh": 2.0, "alpha": 2.0}),
    "my_loss2_t4_a1": ("my_loss2", {"thresh": 4.0, "alpha": 1.0}),
    "epe": ("epe", {}),
    "gcnet_sceneflow": ("gcnet_loss", {"is_kitti": False}),
    "gcnet_kitti_t2_a2": ("gcnet_loss", {"is_kitti": True, "thresh": 2.0,
                                         "alpha": 2.0}),
}


@pytest.mark.parametrize("case", list(GRID_LOSSES))
@pytest.mark.parametrize("seed", [0, 1])
def test_losses_exact_on_grid_inputs(case, seed):
    name, static = GRID_LOSSES[case]
    pred, gt, mask = _grid_case(seed)
    got, ref = _both(name, pred, gt, mask, **static)
    assert got.dtype == ref.dtype == np.float32 and got.shape == ()
    assert got.view(np.int32) == ref.view(np.int32), (got, ref)


def _terms64(name, pred, gt, thresh=3.0, alpha=2.0, **_):
    """float64 terms of ``name`` (a single-term loss)."""
    t = np.abs(pred.astype(np.float64) - gt)
    if name == "smooth_l1":
        return np.where(t < 1, 0.5 * t * t, t - 0.5)
    if name == "epe":
        return t
    return np.where(t < thresh, t * t / thresh,
                    np.where(t <= thresh + alpha,
                             2 * t - (t - thresh) ** 2 / (2 * alpha) - thresh,
                             t + alpha / 2))


@pytest.mark.parametrize("case", list(LOSSES))
@pytest.mark.parametrize("seed", [0, 1])
def test_losses_match_jax(case, seed):
    """Random inputs: both within float32's summation bound of the float64
    mean (the terms are the same; see the module docstring)."""
    name, static = LOSSES[case]
    pred, gt, mask = _case(seed)
    got, ref = _both(name, pred, gt, mask, **static)
    assert got.dtype == ref.dtype == np.float32 and got.shape == ()
    n = int(mask.sum())
    if name == "gcnet_loss":
        parts = [("smooth_l1", 0.4 if static["is_kitti"] else 1.0)]
        if static["is_kitti"]:
            parts.append(("my_loss2", 0.6))
    else:
        parts = [(name, 1.0)]
    exact, bound = 0.0, 0.0
    for part, wgt in parts:
        terms = _terms64(part, pred, gt, **static)[mask]
        exact += wgt * terms.sum() / n
        bound += wgt * (n - 1) * 2.0 ** -24 * np.abs(terms).sum() / n
    for v in (got, ref):
        ulp = float(np.spacing(np.float32(exact)))
        assert abs(float(v) - exact) <= bound + ulp, (v, exact, bound)


@pytest.mark.parametrize("kitti", [False, True])
def test_psmnet_loss_exact_on_grid_inputs(kitti):
    p0, gt, mask = _grid_case(2)
    p1, p2 = _grid_case(3)[0], _grid_case(4)[0]
    got, ref = _both("psmnet_loss", p0, p1, p2, gt, mask, is_kitti=kitti,
                     thresh=2.0, alpha=2.0)
    assert got.view(np.int32) == ref.view(np.int32), (got, ref)


@pytest.mark.parametrize("thred", [3.0, 1.0])
def test_valid_accu3_exact(thred):
    """Counts of 0/1 terms: exact in any order, on random inputs too."""
    pred, gt, mask = _case(5)
    got, ref = _both("valid_accu3", gt, pred, mask, thred=thred)
    assert got.view(np.int32) == ref.view(np.int32), (got, ref)


@pytest.mark.parametrize("threshold", [1.0, 3.0])
def test_epe_rate_exact_on_grid_inputs(threshold):
    pred, gt, _ = _grid_case(6)
    (ge, gr), (re, rr) = _both("epe_rate", gt, pred, max_disp=MAX_DISP,
                               threshold=threshold)
    assert ge.view(np.int32) == re.view(np.int32), (ge, re)
    assert gr.view(np.int32) == rr.view(np.int32), (gr, rr)


def test_masks_match_jax_at_their_edges():
    gt = np.array([-1, 0, 0.0005, 0.001, 5, 31.99, 32, 32.5], np.float32)
    for name in ("train_valid_mask", "eval_valid_mask"):
        got, ref = _both(name, gt, max_disp=MAX_DISP)
        np.testing.assert_array_equal(got, ref)
    # train: 0 < gt < max_disp; eval: 0.001 <= gt <= max_disp
    np.testing.assert_array_equal(
        TL.train_valid_mask(torch.from_numpy(gt), MAX_DISP).numpy(),
        [False, False, True, True, True, True, False, False])
    np.testing.assert_array_equal(
        TL.eval_valid_mask(torch.from_numpy(gt), MAX_DISP).numpy(),
        [False, False, False, True, True, True, True, False])


@pytest.mark.parametrize("name,extra", [
    ("smooth_l1", {}), ("my_loss2", {}), ("epe", {}),
    ("gcnet_loss", {"is_kitti": True})])
def test_empty_mask_gives_zero(name, extra):
    """masked_mean divides by max(count, 1): 0, not the NaN of
    F.smooth_l1_loss(x[mask], y[mask])."""
    pred, gt, _ = _case(7)
    empty = np.zeros(gt.shape, bool)
    got, ref = _both(name, pred, gt, empty, **extra)
    assert got == ref == 0.0
    got, ref = _both("valid_accu3", gt, pred, empty)
    assert got == ref == 0.0


# |err| at my_loss2's pieces and on both sides of each boundary (thresh 3,
# alpha 2): quadratic below 3, taper from 3 through 5, linear above 5
EDGES = [0.0, 0.5, 1.0, np.nextafter(3, 0), 3.0, np.nextafter(3, 9), 4.0,
         4.17, np.nextafter(5, 0), 5.0, np.nextafter(5, 9), 7.25, 40.0]


@pytest.mark.parametrize("err", EDGES)
@pytest.mark.parametrize("sign", [1, -1])
def test_my_loss2_pieces_and_boundaries_exact(err, sign):
    """One valid element: the masked mean is the element's term, bitwise."""
    gt = np.array([[10.0]], np.float32)
    pred = (gt + np.float32(sign * err)).astype(np.float32)
    mask = np.ones((1, 1), bool)
    for name in ("my_loss2", "smooth_l1", "epe"):
        got, ref = _both(name, pred, gt, mask)
        assert got.view(np.int32) == ref.view(np.int32), (name, got, ref)


def test_my_loss2_piece_values():
    """The clean piecewise form: t^2/3, 2t - (t-3)^2/4 - 3, t + 1."""
    z = torch.zeros(1)
    one = torch.ones(1, dtype=torch.bool)
    for t, want in ((1.5, 0.75), (3.0, 3.0), (4.0, 4.75), (5.0, 6.0),
                    (6.0, 7.0)):
        assert TL.my_loss2(torch.tensor([t]), z, one).item() == \
            pytest.approx(want, rel=1e-6)
