"""Port MS-GCNet (msnets_tpu_torch.models) against the JAX MSGCNet: weight
conversion both ways, eval parity with randomized BatchNorm statistics, BN
folding, init and the model factory."""
import math

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from msnets_tpu.models import MSGCNet as JaxMSGCNet
from msnets_tpu.models.torch_convert import convert_state_dict
from msnets_tpu_torch.config import ModelConfig
from msnets_tpu_torch.models import MSGCNet, build_model, fold_batchnorm
from msnets_tpu_torch.models.convert import state_dict_from_jax
from msnets_tpu_torch.models.layers import soft_argmin


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _randomize_bn(model, seed):
    """Non-identity BN: a fresh BN would not test the key mapping."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm3d):
                c = m.num_features
                m.weight.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, c).astype(np.float32)))
                m.bias.copy_(torch.from_numpy(rng.normal(0, 0.2, c).astype(np.float32)))
                m.running_mean.copy_(torch.from_numpy(rng.normal(0, 0.3, c).astype(np.float32)))
                m.running_var.copy_(torch.from_numpy(rng.uniform(0.5, 2.0, c).astype(np.float32)))
    return model


@pytest.fixture(scope="module")
def small_model():
    m = MSGCNet(max_disp=32, in_channels=8, num_filters=8,
                generator=torch.Generator().manual_seed(0))
    return _randomize_bn(m, 1).eval()


def test_state_dict_round_trips_through_jax_converter(small_model):
    sd = small_model.state_dict()
    back = state_dict_from_jax(convert_state_dict(sd, "MS-GCNet"), "MS-GCNet")
    assert list(back) == list(sd)
    for k in sd:
        assert torch.equal(back[k], sd[k]), k
    fresh = MSGCNet(32, 8, 8)
    fresh.load_state_dict(back)          # strict: every key, every shape


def test_eval_matches_jax(small_model):
    x = np.random.default_rng(7).random((1, 8, 16, 16, 32), dtype=np.float32)
    with torch.no_grad():
        got = small_model(torch.from_numpy(x)).numpy()
    jm = JaxMSGCNet(max_disp=32, in_channels=8, num_filters=8,
                    dtype=jnp.float32)
    apply = jax.jit(lambda v, f: jm.apply(v, f, train=False))  # eager: ~10x slower
    ref = np.asarray(apply(convert_state_dict(small_model.state_dict(),
                                              "MS-GCNet"),
                           jnp.asarray(np.moveaxis(x, 1, -1))))
    assert got.shape == ref.shape == (1, 32, 64)
    np.testing.assert_allclose(got, ref, atol=2e-3)


def test_fold_batchnorm_keeps_eval_output(small_model):
    import copy
    x = torch.from_numpy(
        np.random.default_rng(8).random((1, 8, 16, 16, 16), dtype=np.float32))
    with torch.no_grad():
        ref = small_model(x)
        folded = fold_batchnorm(copy.deepcopy(small_model))
        got = folded(x)
    assert not any(isinstance(m, torch.nn.BatchNorm3d) for m in folded.modules())
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-4)


def test_he_normal_init_std():
    m = MSGCNet(max_disp=32, in_channels=8, num_filters=32,
                generator=torch.Generator().manual_seed(0))
    w = m.block_3d_4.convbn_3d_2[0].weight           # 128 out, 3^3 taps
    assert abs(w.std().item() / math.sqrt(2 / (27 * 128)) - 1) < 0.02
    d = m.deconv5.weight                              # ConvTranspose3d: out=1
    assert abs(d.std().item() / math.sqrt(2 / 27) - 1) < 0.2
    assert torch.equal(m.deconv5.bias, torch.zeros(1))
    again = MSGCNet(32, 8, 32, generator=torch.Generator().manual_seed(0))
    assert torch.equal(again.conv3dbn_1[0].weight, m.conv3dbn_1[0].weight)
    n = sum(p.numel() for p in m.parameters())
    assert 2.5e6 < n < 3.2e6, n           # reference MS-GCNet is ~2.8M


def test_soft_argmin_peaky():
    logits = torch.full((1, 8, 2, 2), -30.0)
    logits[:, 5] = 30.0
    np.testing.assert_allclose(soft_argmin(logits, 8).numpy(), 5.0, atol=1e-4)


@pytest.mark.parametrize("cfg,err", [
    (ModelConfig(name="MS-PSMNet"), NotImplementedError),
    (ModelConfig(quarter_input=True), NotImplementedError),
    (ModelConfig(quant_eval=True), NotImplementedError),
    (ModelConfig(name="other"), ValueError),
])
def test_build_model_rejects_unported(cfg, err):
    with pytest.raises(err):
        build_model(cfg, device="cpu")


def test_state_dict_from_jax_rejects_psmnet():
    with pytest.raises(NotImplementedError):
        state_dict_from_jax({"params": {}, "batch_stats": {}}, "MS-PSMNet")
