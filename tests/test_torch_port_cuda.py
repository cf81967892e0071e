"""The port on the GPU: the census_aml kernel against its plain PyTorch
version, and the feature stage and server on the card against the same code
on the CPU. Every test needs an NVIDIA GPU and skips without one; run them on
the card with

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_port_cuda.py

(``--noconftest``: tests/conftest.py sets up JAX, which this file does not
use)."""
import numpy as np
import pytest
import torch

from msnets_tpu_torch import Config, ModelConfig, StereoServer
from msnets_tpu_torch.config import MatchingConfig
from msnets_tpu_torch.models import MSGCNet
from msnets_tpu_torch.ops.cuda.census_aml import (census_aml,
                                                  census_aml_reference)
from msnets_tpu_torch.ops.features import ms_features_test
from msnets_tpu_torch.runtime import fp32_reference

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    return torch.device("cuda")


def _pair(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, shape, dtype=np.uint8),
            rng.integers(0, 256, shape, dtype=np.uint8))


@pytest.mark.parametrize("H,W,ndisp,wsize,sigma", [
    (148, 276, 96, 11, 128.0),     # serving path, 256x512 bucket
    (45, 131, 40, 11, 64.0),       # rows that divide no block
    (30, 20, 32, 11, 128.0),       # ndisp > W
    (12, 8, 4, 11, 128.0),         # W < window: all INVALID
    (1, 1, 1, 11, 128.0),
    (33, 70, 17, 5, 32.0),         # a smaller window
])
def test_census_aml_kernel_matches_plain(cuda, H, W, ndisp, wsize, sigma):
    a, b = (torch.from_numpy(x).to(cuda) for x in _pair((H, W), H * W))
    before = census_aml.launches
    cost, aml = census_aml(a, b, ndisp, wsize, sigma)
    assert census_aml.launches == before + 1
    rc, ra = census_aml_reference(a, b, ndisp, wsize, sigma)
    torch.cuda.synchronize()
    assert cost.shape == aml.shape == (ndisp, H, W)
    assert torch.equal(cost, rc)
    # only the order of the sum over d differs from the plain version
    assert (aml - ra).abs().max().item() <= 1e-6
    if W < wsize:
        assert bool((cost == 1.0).all()) and bool((aml == 0).all())


def test_census_aml_kernel_rejects_mixed_devices(cuda):
    a, b = (torch.from_numpy(x) for x in _pair((20, 40), 0))
    with pytest.raises(ValueError):
        census_aml(a.to(cuda), b, 8)
    with pytest.raises(ValueError):
        census_aml(a.to(cuda).t(), b.to(cuda).t(), 8)


def test_ms_features_on_the_card_match_the_cpu(cuda):
    a, b = _pair((64, 128), 7)
    before = census_aml.launches
    got = ms_features_test(torch.from_numpy(a).to(cuda),
                           torch.from_numpy(b).to(cuda), 32, MatchingConfig())
    assert census_aml.launches == before + 1
    ref = ms_features_test(torch.from_numpy(a), torch.from_numpy(b), 32,
                           MatchingConfig())
    err = (got.cpu() - ref).abs().amax(dim=(1, 2, 3))
    # the census channels (0, 4) come from the kernel: exact / sum order;
    # the others are the same torch code, whose CUDA rsqrt, exp and
    # reductions round differently from the CPU's: held at the tolerance
    # of the port-against-JAX feature test
    assert err[0].item() == 0.0 and err[4].item() <= 1e-6, err
    assert err.max().item() <= 5e-6, err


def test_server_on_the_card_matches_the_cpu(cuda):
    cfg = Config(model=ModelConfig(max_disp=32, base_filters=8,
                                   compute_dtype="float32"))
    sd = MSGCNet(32, 8, 8, generator=torch.Generator().manual_seed(3)
                 ).state_dict()
    a, b = _pair((60, 120), 0)
    with fp32_reference():
        srv = StereoServer(cfg, sd, device=cuda)
        before = census_aml.launches
        got = srv.predict(a, b)
        assert census_aml.launches == before + 1
    ref = StereoServer(cfg, sd, device="cpu").predict(a, b)
    assert got.shape == ref.shape == (60, 120)
    np.testing.assert_allclose(got, ref, atol=2e-3)
