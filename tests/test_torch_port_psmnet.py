"""Port MS-PSMNet (msnets_tpu_torch.models.psmnet) against the JAX MSPSMNet
on the same seeded inputs, both in float32 on the CPU: the key schema and
weight conversion both ways, eval, the three train heads with their
gradients and BatchNorm statistics, the trilinear upsample, BN folding and
the server of the whole slice against the JAX server."""
import copy
import warnings

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from msnets_tpu import serve as JS
from msnets_tpu.config import (Config as JaxConfig,
                               ModelConfig as JaxModelConfig)
from msnets_tpu.engine import loss as JL
from msnets_tpu.models import MSPSMNet as JaxMSPSMNet
from msnets_tpu.models.layers import (
    resize_trilinear_align_corners as jax_resize)
from msnets_tpu.models.torch_convert import convert_state_dict
from msnets_tpu_torch.config import Config, ModelConfig
from msnets_tpu_torch.engine import loss as TL
from msnets_tpu_torch.models import (MSPSMNet, build_model, fold_batchnorm,
                                     resize_trilinear_align_corners)
from msnets_tpu_torch.models.convert import state_dict_from_jax
from msnets_tpu_torch.runtime import fp32_reference
from msnets_tpu_torch.serve import StereoServer

from . import torch_ref

F = 8
GRAD_RTOL = 2e-4   # relative L2 error of a gradient tensor (1.2e-5 measured)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with fp32_reference():
        yield
    torch.set_num_threads(n)


def _copy(sd):
    """A state_dict that later in-place updates leave alone (the converter's
    arrays share the tensors' memory)."""
    return {k: v.clone() for k, v in sd.items()}


def _randomize_bn(model, seed):
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


def _model(max_disp, seed=0):
    m = MSPSMNet(max_disp, 8, F, generator=torch.Generator().manual_seed(seed))
    return _randomize_bn(m, seed + 1)


def _jax_model(max_disp):
    return JaxMSPSMNet(max_disp=max_disp, in_channels=8, base_filters=F,
                       dtype=jnp.float32)


def _convert(sd):
    """convert_state_dict with every key matched (an unmatched key warns)."""
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        return convert_state_dict(_copy(sd), "MS-PSMNet")


# -- weights -----------------------------------------------------------------

def test_state_dict_round_trips_through_jax_converter():
    sd = _model(32).state_dict()
    back = state_dict_from_jax(_convert(sd), "MS-PSMNet")
    assert list(back) == list(sd)
    for k in sd:
        assert torch.equal(back[k], sd[k]), k
    MSPSMNet(32, 8, F).load_state_dict(back)       # strict


def test_key_schema_is_the_reference_twin():
    """The reference checkpoint's keys (tests/torch_ref.py's twin of the
    reference module tree), e.g. dres0.0.0.weight, dres2.conv5.0.weight,
    classif1.2.weight."""
    port = set(MSPSMNet(32, 8, F).state_dict())
    assert port == set(torch_ref.TorchPSMNet(max_disp=32, cin=8, F=F).state_dict())
    for k in ("dres0.0.0.weight", "dres0.2.1.running_var",
              "dres2.conv1.0.0.weight", "dres2.conv5.0.weight",
              "classif1.0.1.weight", "classif1.2.weight"):
        assert k in port, k


def test_build_model_builds_psmnet():
    m = build_model(ModelConfig(name="MS-PSMNet", max_disp=32, base_filters=F),
                    "cpu", generator=torch.Generator().manual_seed(0))
    assert isinstance(m, MSPSMNet) and m.upscale == 2 and not m.training
    again = build_model(ModelConfig(name="MS-PSMNet", max_disp=32,
                                    base_filters=F), "cpu",
                        generator=torch.Generator().manual_seed(0))
    assert torch.equal(m.dres0[0][0].weight, again.dres0[0][0].weight)
    with pytest.raises(ValueError):
        MSPSMNet(32, 8, F, remat=True, remat_scope="stem")


# -- eval ----------------------------------------------------------------------

def test_eval_matches_jax():
    m = _model(32).eval()
    x = np.random.default_rng(7).random((1, 8, 16, 16, 32), dtype=np.float32)
    with torch.no_grad():
        got = m(torch.from_numpy(x)).numpy()
    jm = _jax_model(32)
    ref = np.asarray(jax.jit(lambda v, f: jm.apply(v, f, train=False))(
        _convert(m.state_dict()), jnp.asarray(np.moveaxis(x, 1, -1))))
    assert got.shape == ref.shape == (1, 32, 64)
    np.testing.assert_allclose(got, ref, atol=2e-3)


def test_fold_batchnorm_folds_every_stage():
    """No BatchNorm is left in the hourglasses, dres stages or classifiers,
    and the eval output stays."""
    m = _model(32).eval()
    x = torch.from_numpy(
        np.random.default_rng(8).random((1, 8, 16, 8, 16), dtype=np.float32))
    with torch.no_grad():
        ref = m(x)
        folded = fold_batchnorm(copy.deepcopy(m))
        got = folded(x)
    assert not any(isinstance(k, torch.nn.BatchNorm3d) for k in folded.modules())
    assert isinstance(folded.dres2.conv5, torch.nn.ConvTranspose3d)
    assert isinstance(folded.classif3[0], torch.nn.Conv3d)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-4)


# -- train: three heads, gradients, BN statistics ------------------------------

MAX_DISP_T = 16


@pytest.fixture(scope="module")
def train_step():
    """One train-mode forward and backward of psmnet_loss, port and JAX, from
    the same weights on the same volume and target."""
    m = _model(MAX_DISP_T, seed=3).train()
    variables = _convert(m.state_dict())
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 8, 8, 8, 16)).astype(np.float32)
    tgt = rng.uniform(0, MAX_DISP_T + 2, (2, 16, 32)).astype(np.float32)
    target = torch.from_numpy(tgt)
    outs = m(torch.from_numpy(x))
    loss = TL.psmnet_loss(*outs, target,
                          TL.train_valid_mask(target, MAX_DISP_T), False)
    loss.backward()
    grads = _copy(m.state_dict())
    for k, p in m.named_parameters():
        grads[k] = p.grad.clone()
    port = {"outs": [o.detach().numpy() for o in outs], "loss": loss.item(),
            "stats": convert_state_dict(_copy(m.state_dict()),
                                        "MS-PSMNet")["batch_stats"],
            "grads": convert_state_dict(grads, "MS-PSMNet")["params"]}

    jm = _jax_model(MAX_DISP_T)

    def f(params, xx, tt):
        out, upd = jm.apply({"params": params,
                             "batch_stats": variables["batch_stats"]}, xx,
                            train=True, mutable=["batch_stats"])
        mask = JL.train_valid_mask(tt, MAX_DISP_T)
        return JL.psmnet_loss(*out, tt, mask, False), (out, upd["batch_stats"])

    (jl, (jo, js)), jg = jax.jit(jax.value_and_grad(f, has_aux=True))(
        variables["params"], jnp.asarray(np.moveaxis(x, 1, -1)),
        jnp.asarray(tgt))
    ref = {"outs": [np.asarray(o) for o in jo], "loss": float(jl),
           "stats": js, "grads": jg}
    return port, ref


def test_train_three_heads_match_jax(train_step):
    """pred1, pred2, pred3 at the bound of tests/test_models.py's
    test_psmnet_train_three_heads; the loss to rel 1e-5."""
    port, ref = train_step
    assert len(port["outs"]) == 3
    for got, want in zip(port["outs"], ref["outs"]):
        assert got.shape == want.shape == (2, 16, 32)
        np.testing.assert_allclose(got, want, atol=2e-3)
    assert port["loss"] == pytest.approx(ref["loss"], rel=1e-5)


def test_train_running_stats_match_jax(train_step):
    """Each BN's running mean and (biased) variance after one train forward
    to 1e-5, the bound of tests/test_models.py's remat tests."""
    port, ref = train_step
    want = dict(jax.tree_util.tree_leaves_with_path(ref["stats"]))
    got = dict(jax.tree_util.tree_leaves_with_path(port["stats"]))
    assert want.keys() == got.keys() and len(want) == 2 * 25
    for path, w in want.items():
        np.testing.assert_allclose(np.asarray(got[path]), np.asarray(w),
                                   rtol=1e-5, atol=1e-5, err_msg=str(path))


def test_train_gradients_match_jax(train_step):
    """Every parameter's gradient of psmnet_loss against jax.grad, to a
    relative L2 error of GRAD_RTOL."""
    port, ref = train_step
    want = dict(jax.tree_util.tree_leaves_with_path(ref["grads"]))
    got = dict(jax.tree_util.tree_leaves_with_path(port["grads"]))
    assert want.keys() == got.keys()
    errs = {}
    for path, w in want.items():
        w = np.asarray(w, np.float64)
        g = np.asarray(got[path], np.float64)
        errs[jax.tree_util.keystr(path)] = (np.linalg.norm(g - w)
                                            / np.linalg.norm(w))
    worst = max(errs, key=errs.get)
    print(f"worst gradient relative L2 error {errs[worst]:.3g} ({worst})")
    assert errs[worst] <= GRAD_RTOL, (worst, errs[worst])


# -- the trilinear upsample ----------------------------------------------------

@pytest.mark.parametrize("shape,out", [
    ((2, 1, 4, 5, 6), (16, 10, 12)),     # the regress upsample, x2 / x4
    ((1, 1, 3, 4, 4), (3, 4, 4)),        # equal sizes: unchanged
    ((1, 1, 1, 4, 5), (8, 8, 10)),       # size 1 in: index 0
    ((1, 2, 6, 5, 4), (1, 9, 1)),        # size 1 out: index 0
    ((1, 1, 7, 9, 11), (5, 4, 3)),       # shrinking
    ((1, 1, 5, 3, 2), (97, 13, 7)),      # ratios that round in float32
], ids=["regress", "equal", "in1", "out1", "shrink", "odd"])
def test_resize_trilinear_matches_jax(shape, out):
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    got = resize_trilinear_align_corners(torch.from_numpy(x), out).numpy()
    resize = jax.jit(jax_resize, static_argnums=(1, 2))   # eager: ~10x slower
    want = np.asarray(resize(jnp.asarray(x), out, (2, 3, 4)))
    assert got.shape == want.shape == shape[:2] + out
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    if shape[2:] == out:
        np.testing.assert_array_equal(got, x)


# -- the slice: the MS-PSMNet server against the JAX server --------------------

def _serve_cfg(dtype="float32"):
    return Config(model=ModelConfig(name="MS-PSMNet", max_disp=32,
                                    base_filters=F, compute_dtype=dtype))


def test_psmnet_server_matches_jax_server():
    """60x120 pads to 64x128 and crops back; 8-channel features, BN folded,
    float32 on both sides."""
    rng = np.random.default_rng(0)
    iml = rng.integers(0, 256, (60, 120), dtype=np.uint8)
    imr = rng.integers(0, 256, (60, 120), dtype=np.uint8)
    sd = _model(32, seed=5).state_dict()
    got = StereoServer(_serve_cfg(), sd, device="cpu").predict(iml, imr)
    jcfg = JaxConfig(model=JaxModelConfig(name="MS-PSMNet", max_disp=32,
                                          base_filters=F,
                                          compute_dtype="float32"))
    ref = JS.StereoServer(jcfg, _convert(sd)).predict(iml, imr)
    assert got.shape == ref.shape == (60, 120) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, atol=2e-3)


def test_bf16_psmnet_server_close_to_f32():
    """bfloat16 serving casts every child (classifiers included); the
    upsample and softmax cast to float32 inside the model."""
    rng = np.random.default_rng(1)
    iml = rng.integers(0, 256, (64, 128), dtype=np.uint8)
    imr = np.roll(iml, -3, axis=1)
    sd = _model(32, seed=6).state_dict()
    d32 = StereoServer(_serve_cfg(), sd, device="cpu").predict(iml, imr)
    srv = StereoServer(_serve_cfg("bfloat16"), sd, device="cpu")
    assert MSPSMNet.FLOAT32_CHILDREN == ()
    assert srv.model.classif3[2].weight.dtype == torch.bfloat16
    assert srv.model.dres2.conv6.weight.dtype == torch.bfloat16
    d16 = srv.predict(iml, imr)
    assert np.isfinite(d16).all() and 0 <= d16.min() and d16.max() < 32
    assert np.abs(d16 - d32).mean() < 1.0
