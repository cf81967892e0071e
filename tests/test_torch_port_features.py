"""Port feature stage (msnets_tpu_torch.ops.features) against the JAX feature
stage on the same uint8 inputs."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from msnets_tpu.config import MatchingConfig as JaxMatchingConfig
from msnets_tpu.ops import features as JF
from msnets_tpu_torch.config import MatchingConfig
from msnets_tpu_torch.ops import features as TF


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _img(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


@pytest.mark.parametrize("shape", [(36, 52), (37, 53), (64, 128),
                                   (375, 1242), (7, 11)])
def test_downsample_half_uint8_exact(shape):
    img = _img(shape, 11)
    got = TF.downsample_half(torch.from_numpy(img)).numpy()
    ref = np.asarray(JF.downsample_half(jnp.asarray(img)))
    assert got.dtype == np.uint8 and got.shape == ref.shape
    # a float-contraction difference would show as 1-LSB mismatches
    n_diff = int((got != ref).sum())
    assert n_diff == 0, f"{n_diff} pixels differ by up to " \
        f"{np.abs(got.astype(int) - ref.astype(int)).max()} LSB"


def test_matching_config_defaults_match():
    j, t = JaxMatchingConfig(), MatchingConfig()
    for f in ("censw", "nccw", "sadw", "sobelw", "cens_sigma", "ncc_sigma",
              "sad_sigma", "num_channels", "ds_scale", "features_mode"):
        assert getattr(t, f) == getattr(j, f), f


def test_ms_features_test_matches_jax():
    a, b = _img((64, 128), 7), _img((64, 128), 8)
    got = TF.ms_features_test(torch.from_numpy(a), torch.from_numpy(b), 32,
                              MatchingConfig())
    ref = np.asarray(JF.to_ncdhw(JF.ms_features_test(
        jnp.asarray(a), jnp.asarray(b), 32, JaxMatchingConfig())))
    assert tuple(got.shape) == ref.shape == (8, 16, 32, 64)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, atol=5e-6)


def test_ms_features_margins_match_jax():
    """Asymmetric margins (board 5 / 6 / 0) through ms_features."""
    a, b = _img((30, 64), 7), _img((30, 64), 9)
    got = TF.ms_features(torch.from_numpy(a), torch.from_numpy(b), 16,
                         MatchingConfig(), 5, 6, 0)
    ref = np.asarray(JF.to_ncdhw(JF.ms_features(
        jnp.asarray(a), jnp.asarray(b), 16, JaxMatchingConfig(), 5, 6, 0,
        True)))
    assert tuple(got.shape) == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, atol=5e-6)


def test_known_disparity_recovered():
    """The verify surface: a shifted random texture; the census-AML channel
    peaks at the true disparity 7."""
    base = _img((48, 103), 0)
    L, R = np.ascontiguousarray(base[:, :96]), np.ascontiguousarray(base[:, 7:])
    f = TF.ms_features(torch.from_numpy(L), torch.from_numpy(R), 16,
                       MatchingConfig(), 5, 20, 0, True)
    acc = (f[4].argmax(0)[8:-8, 8:-8] == 7).float().mean().item()
    assert acc > 0.99


def test_bf16_output_and_unported_variants():
    a = torch.from_numpy(_img((40, 64), 3))
    f = TF.ms_features(a, a, 8, MatchingConfig(), 5, 6, 0, True,
                       torch.bfloat16)
    assert f.dtype == torch.bfloat16 and f.shape[0] == 8
    with pytest.raises(NotImplementedError):
        TF.ms_features(a, a, 8, MatchingConfig(), 5, 6, 0, False)
    with pytest.raises(NotImplementedError):
        TF.ms_features(a, a, 8, MatchingConfig(features_mode="raw"), 5, 6)
