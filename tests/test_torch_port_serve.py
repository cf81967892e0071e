"""Port serving path (msnets_tpu_torch.serve) end to end on the CPU against
the JAX StereoServer, the bucket helpers, and the GPU-by-default rule."""
import numpy as np
import pytest
import torch

from msnets_tpu import serve as JS
from msnets_tpu.config import (Config as JaxConfig, MatchingConfig as JaxMC,
                               ModelConfig as JaxModelConfig)
from msnets_tpu.models.torch_convert import convert_state_dict
from msnets_tpu_torch import serve as TS
from msnets_tpu_torch.config import Config, ModelConfig
from msnets_tpu_torch.models import MSGCNet, build_model
from msnets_tpu_torch.runtime import fp32_reference, resolve_device


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(dtype="float32"):
    return Config(model=ModelConfig(max_disp=32, base_filters=8,
                                    compute_dtype=dtype))


@pytest.fixture(scope="module")
def state_dict():
    m = MSGCNet(32, 8, 8, generator=torch.Generator().manual_seed(3))
    rng = np.random.default_rng(4)
    with torch.no_grad():
        for bn in m.modules():
            if isinstance(bn, torch.nn.BatchNorm3d):
                c = bn.num_features
                bn.weight.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, c).astype(np.float32)))
                bn.bias.copy_(torch.from_numpy(rng.normal(0, 0.2, c).astype(np.float32)))
                bn.running_mean.copy_(torch.from_numpy(rng.normal(0, 0.3, c).astype(np.float32)))
                bn.running_var.copy_(torch.from_numpy(rng.uniform(0.5, 2.0, c).astype(np.float32)))
    return m.state_dict()


def test_predict_matches_jax_server(state_dict):
    """60x120 is no multiple of 32: pad to 64x128 and crop back."""
    rng = np.random.default_rng(0)
    iml = rng.integers(0, 256, (60, 120), dtype=np.uint8)
    imr = rng.integers(0, 256, (60, 120), dtype=np.uint8)
    srv = TS.StereoServer(_cfg(), state_dict, device="cpu")
    got = srv.predict(iml, imr)
    jcfg = JaxConfig(model=JaxModelConfig(max_disp=32, base_filters=8,
                                          compute_dtype="float32"),
                     matching=JaxMC())
    ref = JS.StereoServer(jcfg, convert_state_dict(state_dict, "MS-GCNet")
                          ).predict(iml, imr)
    assert got.shape == ref.shape == (60, 120) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, atol=2e-3)
    assert srv.stats()["bucket_hits"] == {(64, 128): 1}


def test_bf16_server_close_to_f32(state_dict):
    rng = np.random.default_rng(1)
    iml = rng.integers(0, 256, (64, 128), dtype=np.uint8)
    d32 = TS.StereoServer(_cfg(), state_dict, device="cpu").predict(iml, iml)
    srv = TS.StereoServer(_cfg("bfloat16"), state_dict, device="cpu")
    assert srv.model.deconv5.weight.dtype == torch.float32     # f32 head
    assert srv.model.conv3dbn_1.weight.dtype == torch.bfloat16
    d16 = srv.predict(iml, iml)
    assert np.isfinite(d16).all() and 0 <= d16.min() and d16.max() < 32
    assert np.abs(d16 - d32).mean() < 1.0


def test_warmup_and_stats(state_dict):
    srv = TS.StereoServer(_cfg(), state_dict, buckets=[(64, 128)],
                          device="cpu")
    srv.warmup([(30, 40)])
    s = srv.stats()
    assert s["frames"] == 0 and s["warm_buckets"] == [(64, 128)]
    srv.predict(np.zeros((50, 100), np.uint8), np.zeros((50, 100), np.uint8))
    assert srv.stats()["bucket_hits"] == {(64, 128): 1}


@pytest.mark.parametrize("h,w", [(375, 1242), (240, 400), (540, 960),
                                 (600, 1250), (100, 600), (64, 128)])
def test_bucket_helpers_match_jax(h, w):
    assert TS.pick_bucket(h, w, TS.DEFAULT_BUCKETS) == \
        JS.pick_bucket(h, w, JS.DEFAULT_BUCKETS)
    assert TS.exact_bucket(h, w) == JS.exact_bucket(h, w)
    assert TS.pick_bucket(h, w, None) == JS.pick_bucket(h, w, None)


def test_pad_to_bucket_matches_jax():
    iml = np.arange(6, dtype=np.uint8).reshape(2, 3)
    for a, b in zip(TS.pad_to_bucket(iml, iml + 1, (4, 5)),
                    JS.pad_to_bucket(iml, iml + 1, (4, 5))):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        TS.pad_to_bucket(iml, iml, (1, 5))


def test_entry_points_default_to_the_gpu(state_dict):
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: the default device exists")
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="cuda"):
        build_model(_cfg().model)
    with pytest.raises(RuntimeError, match="cuda"):
        TS.StereoServer(_cfg(), state_dict)
    assert resolve_device("cpu") == torch.device("cpu")


def test_fp32_reference_restores_tf32_flags():
    before = (torch.backends.cudnn.allow_tf32,
              torch.backends.cuda.matmul.allow_tf32)
    with fp32_reference():
        assert not torch.backends.cudnn.allow_tf32
        assert not torch.backends.cuda.matmul.allow_tf32
    assert (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32) == before
