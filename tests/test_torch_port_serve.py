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
from msnets_tpu_torch.config import Config, MatchingConfig, ModelConfig
from msnets_tpu_torch.models import MSGCNet, build_model
from msnets_tpu_torch.runtime import fp32_reference, resolve_device


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(dtype="float32", matching=MatchingConfig()):
    return Config(matching=matching,
                  model=ModelConfig(max_disp=32, base_filters=8,
                                    in_channels=matching.feature_channels,
                                    compute_dtype=dtype))


def _state_dict(in_channels):
    m = MSGCNet(32, in_channels, 8, generator=torch.Generator().manual_seed(3))
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


@pytest.fixture(scope="module")
def state_dict():
    return _state_dict(8)


VARIANTS = {"8ch": {}, "16ch": {"num_channels": 16},
            "raw": {"features_mode": "raw"}}


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_predict_matches_jax_server(variant):
    """60x120 is no multiple of 32: pad to 64x128 and crop back. The three
    feature variants, each with the model's in_channels to match."""
    rng = np.random.default_rng(0)
    iml = rng.integers(0, 256, (60, 120), dtype=np.uint8)
    imr = rng.integers(0, 256, (60, 120), dtype=np.uint8)
    cfg = _cfg(matching=MatchingConfig(**VARIANTS[variant]))
    sd = _state_dict(cfg.model.in_channels)
    srv = TS.StereoServer(cfg, sd, device="cpu")
    got = srv.predict(iml, imr)
    jcfg = JaxConfig(model=JaxModelConfig(max_disp=32, base_filters=8,
                                          in_channels=cfg.model.in_channels,
                                          compute_dtype="float32"),
                     matching=JaxMC(**VARIANTS[variant]))
    ref = JS.StereoServer(jcfg, convert_state_dict(sd, "MS-GCNet")
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


def _stream_pairs(shapes, seed):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 256, s, dtype=np.uint8),
             rng.integers(0, 256, s, dtype=np.uint8)) for s in shapes]


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_predict_stream_order_and_values(state_dict, depth):
    """Mirrors tests/test_serve.py::test_predict_stream_order_and_values, two
    buckets mixed: each result is predict's on the same pair, bit for bit
    (the same forward), in input order; every slot returns to its pool."""
    srv = TS.StereoServer(_cfg(), state_dict, buckets=[(64, 128)],
                          device="cpu", depth=depth)
    pairs = _stream_pairs([(64, 128), (50, 100), (96, 160), (64, 128),
                           (60, 120)], 2)
    got = list(srv.predict_stream(iter(pairs)))
    assert len(got) == 5
    for (iml, imr), d in zip(pairs, got):
        assert d.shape == iml.shape and d.dtype == np.float32
        np.testing.assert_array_equal(d, srv.predict(iml, imr))
    assert {b: len(p) for b, p in srv._slots.items()} == \
        {(64, 128): depth, (96, 160): depth}
    assert srv.stats()["frames"] == 10


def test_predict_stream_item_error_surfaces_in_order(state_dict):
    """A pair whose views differ in shape fails in its padding: the frames
    before it come out, then its error is raised, and the stream ends with
    every slot back in its pool."""
    srv = TS.StereoServer(_cfg(), state_dict, device="cpu", depth=2)
    pairs = _stream_pairs([(64, 128)] * 4, 3)
    pairs[2] = (pairs[2][0], pairs[2][1][:32])
    stream = srv.predict_stream(iter(pairs))
    for want in pairs[:2]:
        np.testing.assert_array_equal(next(stream), srv.predict(*want))
    with pytest.raises(ValueError):
        next(stream)
    with pytest.raises(StopIteration):
        next(stream)
    assert len(srv._slots[(64, 128)]) == 2


def test_abandoned_stream_leaves_no_thread(state_dict):
    """A stream abandoned with ``depth`` frames in flight (the first result
    is yielded after the third frame's launch) finishes them on close: every
    slot comes back, and the stream starts no thread."""
    import threading
    threads = threading.active_count()
    srv = TS.StereoServer(_cfg(), state_dict, device="cpu", depth=2)
    stream = srv.predict_stream(iter(_stream_pairs([(64, 128)] * 6, 4)))
    next(stream)
    assert len(srv._slots[(64, 128)]) == 0         # two frames in flight
    assert srv.stats()["frames"] == 3
    assert threading.active_count() == threads
    stream.close()                                 # GeneratorExit
    assert len(srv._slots[(64, 128)]) == 2
    assert srv.stats()["frames"] == 3
