"""Port MS-GCNet (msnets_tpu_torch.models) against the JAX MSGCNet: weight
conversion both ways, eval parity with randomized BatchNorm statistics, BN
folding, init and the model factory: ``build_model`` through each class's
``from_config`` against the constructor calls it replaced, and the train
loss chosen by a model's heads (``engine.loss.train_loss``)."""
import math

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from msnets_tpu.models import MSGCNet as JaxMSGCNet
from msnets_tpu.models.torch_convert import convert_state_dict
from msnets_tpu_torch.config import ModelConfig
from msnets_tpu_torch.engine import loss as L
from msnets_tpu_torch.models import (GCNet, MSGCNet, MSPSMNet, build_model,
                                     compute_dtype, fold_batchnorm)
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


@pytest.mark.parametrize("cin", [16, 2], ids=["16ch", "raw"])
def test_state_dict_round_trips_with_other_input_channels(cin):
    """The 16-channel and raw variants change only conv3dbn_1's input
    channels; the key schema and both converters carry them."""
    m = build_model(ModelConfig(max_disp=32, in_channels=cin, base_filters=8),
                    "cpu", generator=torch.Generator().manual_seed(2))
    sd = _randomize_bn(m, 3).state_dict()
    assert tuple(sd["conv3dbn_1.0.weight"].shape) == (8, cin, 3, 3, 3)
    back = state_dict_from_jax(convert_state_dict(sd, "MS-GCNet"), "MS-GCNet")
    assert list(back) == list(sd)
    for k in sd:
        assert torch.equal(back[k], sd[k]), k
    MSGCNet(32, cin, 8).load_state_dict(back)


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
    (ModelConfig(quant_eval=True, quant_scope="encoder"), ValueError),
    (ModelConfig(name="other"), ValueError),
])
def test_build_model_rejects_unported(cfg, err):
    """A quant_scope outside all/stem (JAX asserts) and an unknown model
    are refused; quant_eval itself is ported (test_torch_port_quant*.py)."""
    with pytest.raises(err):
        build_model(cfg, device="cpu")


def test_state_dict_from_jax_rejects_psmnet():
    """An MS-PSMNet tree without its variables is refused (the key map
    names every one), as is an unknown model."""
    with pytest.raises(KeyError):
        state_dict_from_jax({"params": {}, "batch_stats": {}}, "MS-PSMNet")
    with pytest.raises(ValueError):
        state_dict_from_jax({"params": {}, "batch_stats": {}}, "other")


def _constructor_call(m, generator, remat, remat_scope):
    """The constructor call ``build_model``'s former branch on the model's
    name made, argument for argument."""
    q = (m.quant_eval, m.quant_mode)
    if m.name == "MS-PSMNet":
        return MSPSMNet(m.max_disp, m.in_channels, m.base_filters,
                        4 if m.quarter_input else 2, generator,
                        compute_dtype(m), remat, remat_scope, *q,
                        m.packed_eval_outer)
    if m.name == "GC-Net":
        return GCNet(m.max_disp, m.in_channels, m.base_filters, generator,
                     compute_dtype=compute_dtype(m), remat=remat,
                     quarter_input=m.quarter_input, quant_eval=q[0],
                     quant_mode=q[1], quant_scope=m.quant_scope)
    return MSGCNet(m.max_disp, m.in_channels, m.base_filters, generator,
                   compute_dtype(m), remat, m.quarter_input, *q,
                   m.quant_scope)


def _settings(model):
    """Each module's plain attributes: strides, upscale, remat, compute
    dtype, int8 sites and modes."""
    return {name: {k: v for k, v in vars(mod).items()
                   if not k.startswith("_") and not callable(v)}
            for name, mod in model.named_modules()}


SMALL = dict(max_disp=32, base_filters=8, compute_dtype="float32")
SEAM = {
    "MS-GCNet": (ModelConfig(**SMALL), False, "all"),
    "MS-PSMNet": (ModelConfig(name="MS-PSMNet", **SMALL), True, "hourglass"),
    "GC-Net": (ModelConfig(name="GC-Net", in_channels=16, **SMALL), True,
               "all"),
    "MS-GCNet-quarter": (ModelConfig(quarter_input=True, **SMALL), False,
                         "all"),
    "MS-PSMNet-quarter": (ModelConfig(name="MS-PSMNet", quarter_input=True,
                                      **SMALL), False, "all"),
    "MS-GCNet-int8-stem": (ModelConfig(quant_eval=True, quant_mode="static",
                                       quant_scope="stem", **SMALL), False,
                           "all"),
    "MS-PSMNet-int8": (ModelConfig(name="MS-PSMNet", quant_eval=True,
                                   packed_eval_outer=False,
                                   compute_dtype="bfloat16", max_disp=32,
                                   base_filters=8), False, "all"),
    "GC-Net-int8-quarter": (ModelConfig(name="GC-Net", in_channels=16,
                                        quant_eval=True, quarter_input=True,
                                        **SMALL), False, "all"),
}


@pytest.mark.parametrize("name", list(SEAM))
def test_build_model_is_the_constructor_call_it_replaced(name):
    """Same class, module tree (quantized convs, strides, upscale and remat
    included), state_dict keys, shapes and drawn weights from the same
    generator seed."""
    m, remat, scope = SEAM[name]
    got = build_model(m, "cpu", torch.Generator().manual_seed(7), remat,
                      scope)
    want = _constructor_call(m, torch.Generator().manual_seed(7), remat,
                             scope).eval()
    assert type(got) is type(want)
    assert repr(got) == repr(want)
    assert _settings(got) == _settings(want)
    a, b = got.state_dict(), want.state_dict()
    assert list(a) == list(b)
    for k in a:
        assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype, k
        assert torch.equal(a[k], b[k]), k


def _heads(n, seed):
    g = torch.Generator().manual_seed(seed)
    return tuple(torch.rand((2, 8, 16), generator=g) * 40 for _ in range(n))


@pytest.mark.parametrize("heads", [1, 3])
@pytest.mark.parametrize("kitti", [False, True])
def test_train_loss_is_the_loss_of_the_heads(heads, kitti):
    """One map takes ``gcnet_loss``, three heads ``psmnet_loss``, bit for
    bit, and the disparity is the map or the last head."""
    out = _heads(heads, 1)
    target = _heads(1, 2)[0]
    mask = L.train_valid_mask(target, 32)
    got, disp = L.train_loss(out if heads == 3 else out[0], target, mask,
                             kitti, 3.0, 2.0)
    want = (L.psmnet_loss(*out, target, mask, kitti, 3.0, 2.0) if heads == 3
            else L.gcnet_loss(out[0], target, mask, kitti, 3.0, 2.0))
    assert torch.equal(got, want)
    assert disp is out[-1]
