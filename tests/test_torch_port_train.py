"""Port training path (msnets_tpu_torch.engine.trainer and the train-mode
BatchNorm) against the JAX Trainer on the same seeded inputs: both in
float32 on the CPU (the port with TF32 off). ms_features_train is held
against JAX in tests/test_torch_port_features.py."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from msnets_tpu.config import (Config as JaxConfig, DataConfig as JaxDataConfig,
                               MatchingConfig as JaxMC,
                               ModelConfig as JaxModelConfig,
                               TrainConfig as JaxTrainConfig)
from msnets_tpu.engine import Trainer as JaxTrainer, TrainState
from msnets_tpu.models.layers import PackedPhaseBN
from msnets_tpu.models.torch_convert import convert_state_dict
from msnets_tpu_torch.config import (Config, DataConfig, EvalConfig,
                                     MatchingConfig, ModelConfig, TrainConfig)
from msnets_tpu_torch.data.pipeline import synthetic_train_batch
from msnets_tpu_torch.engine import Trainer, epoch_lr
from msnets_tpu_torch.models.layers import BatchNorm3d
from msnets_tpu_torch.runtime import fp32_reference

MAX_DISP, F, CROP_H, CROP_W, LR = 32, 4, 32, 64, 1e-3
BIAS = 0.25       # deconv5's bias, made non-zero to see that it stays
GRAD_RTOL = 2e-4  # relative L2 error of a gradient tensor (6e-5 measured)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with fp32_reference():
        yield
    torch.set_num_threads(n)


def _cfg(batch_size=2, grad_accum=1, matching=MatchingConfig()):
    return Config(matching=matching,
                  model=ModelConfig(max_disp=MAX_DISP, base_filters=F,
                                    in_channels=matching.feature_channels,
                                    compute_dtype="float32"),
                  train=TrainConfig(crop_height=CROP_H, crop_width=CROP_W,
                                    batch_size=batch_size, lr=LR,
                                    grad_accum=grad_accum))


def _batch(seed, n=2, shift=5, left_only=True):
    return synthetic_train_batch(CROP_H, CROP_W, MAX_DISP, MatchingConfig(), n,
                                 shift, seed, left_only)


# -- train-mode BatchNorm ----------------------------------------------------

def _bn_case():
    """n = N*D*H*W = 16 elements a channel: the biased and the unbiased
    variance differ by 16/15, 7%."""
    rng = np.random.default_rng(5)
    x = rng.normal(0.3, 1.5, (1, 3, 2, 2, 4)).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, 3).astype(np.float32)
    bias = rng.normal(0, 0.2, 3).astype(np.float32)
    ra_mean = rng.normal(0, 0.3, 3).astype(np.float32)
    ra_var = rng.uniform(0.5, 2.0, 3).astype(np.float32)
    g = rng.normal(0, 1, x.shape).astype(np.float32)
    return x, scale, bias, ra_mean, ra_var, g


def _jax_bn(x, scale, bias, ra_mean, ra_var, g):
    bn = PackedPhaseBN(3, 1, 16)
    params = {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}
    stats = {"mean": jnp.asarray(ra_mean), "var": jnp.asarray(ra_var)}
    y = jnp.asarray(np.moveaxis(x, 1, -1))

    @jax.jit
    def f(y, p):
        return bn.apply({"params": p, "batch_stats": stats}, y,
                        mutable=["batch_stats"])
    (out, upd), vjp = jax.vjp(f, y, params)
    dy, dp = vjp(((jnp.asarray(np.moveaxis(g, 1, -1))),
                  jax.tree.map(jnp.zeros_like, upd)))
    return (np.moveaxis(np.asarray(out), -1, 1), upd["batch_stats"],
            np.moveaxis(np.asarray(dy), -1, 1), dp)


def _torch_bn(module, x, scale, bias, ra_mean, ra_var, g):
    with torch.no_grad():
        module.weight.copy_(torch.from_numpy(scale))
        module.bias.copy_(torch.from_numpy(bias))
        module.running_mean.copy_(torch.from_numpy(ra_mean))
        module.running_var.copy_(torch.from_numpy(ra_var))
    xt = torch.from_numpy(x).requires_grad_()
    out = module.train()(xt)
    out.backward(torch.from_numpy(g))
    return out.detach().numpy(), module, xt.grad.numpy()


def test_train_bn_matches_jax_forward_stats_and_gradient():
    """Output, running mean and (biased) running variance after one step,
    and the gradients of input, scale and bias, within 1e-6."""
    case = _bn_case()
    j_out, j_stats, j_dx, j_dp = _jax_bn(*case)
    out, m, dx = _torch_bn(BatchNorm3d(3, eps=1e-5, momentum=0.1), *case)
    np.testing.assert_allclose(out, j_out, atol=1e-6)
    np.testing.assert_allclose(m.running_mean.numpy(), j_stats["mean"], atol=1e-6)
    np.testing.assert_allclose(m.running_var.numpy(), j_stats["var"], atol=1e-6)
    assert int(m.num_batches_tracked) == 1
    np.testing.assert_allclose(dx, j_dx, atol=1e-6)
    np.testing.assert_allclose(m.weight.grad.numpy(), j_dp["scale"], atol=1e-6)
    np.testing.assert_allclose(m.bias.grad.numpy(), j_dp["bias"], atol=1e-6)


def test_stock_batchnorm_running_var_misses_jax():
    """The same check fails for ``nn.BatchNorm3d``: it puts the unbiased
    variance into running_var, 0.1 * var / 15 away at n = 16."""
    case = _bn_case()
    _, j_stats, _, _ = _jax_bn(*case)
    _, m, _ = _torch_bn(torch.nn.BatchNorm3d(3, eps=1e-5, momentum=0.1), *case)
    gap = np.abs(m.running_var.detach().numpy() - np.asarray(j_stats["var"]))
    assert gap.max() > 1e-3, gap


# -- two train steps against the JAX Trainer -------------------------------

def _copy(sd):
    """A state_dict that later in-place updates leave alone (the converter's
    arrays share the tensors' memory)."""
    return {k: v.clone() for k, v in sd.items()}


@pytest.fixture(scope="module")
def two_steps():
    """Two train steps of the JAX Trainer and of the port's from the same
    weights on the same two batches; returns both sides after each step."""
    port = Trainer(_cfg(), device="cpu", seed=3)
    with torch.no_grad():
        port.model.deconv5.bias.fill_(BIAS)
    variables = convert_state_dict(port.model.state_dict(), "MS-GCNet")
    jcfg = JaxConfig(matching=JaxMC(),
                     model=JaxModelConfig(max_disp=MAX_DISP, base_filters=F,
                                          compute_dtype="float32"),
                     train=JaxTrainConfig(crop_height=CROP_H, crop_width=CROP_W,
                                          batch_size=2, lr=LR),
                     data=JaxDataConfig())
    jtr = JaxTrainer(jcfg)
    # the state built directly from the converted weights: init_state's
    # eager flax init takes ~40 s here
    state = TrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                       batch_stats=variables["batch_stats"],
                       opt_state=jtr.tx.init(variables["params"]))
    batches = [_batch(10), _batch(11, shift=9)]
    geom = (batches[0]["board_h"], batches[0]["board_w_left"],
            batches[0]["board_w_right"])
    jfn, pfn = jtr.step_fn(*geom), port.step_fn(*geom)
    out = []
    for b in batches:
        state, jm, jd = jfn(state, jnp.asarray(b["iml"]), jnp.asarray(b["imr"]),
                            jnp.asarray(b["disp"]), jnp.asarray(LR, jnp.float32))
        pm, pd = pfn(b["iml"], b["imr"], b["disp"], LR)
        # the step's gradients in the JAX layout: parameters replaced by
        # their .grad (deconv5's bias has none: 0, as in JAX)
        grads = _copy(port.model.state_dict())
        for k, p in port.model.named_parameters():
            grads[k] = torch.zeros_like(p) if p.grad is None else p.grad.clone()
        out.append({"jax": (jax.device_get(state), {k: float(v) for k, v in jm.items()},
                            np.asarray(jd)),
                    "port": (convert_state_dict(_copy(port.model.state_dict()),
                                                "MS-GCNet"),
                             {k: float(v) for k, v in pm.items()}, pd.numpy()),
                    "port_grads": convert_state_dict(grads, "MS-GCNet")["params"]})
    return port, out


@pytest.mark.parametrize("step", [0, 1])
def test_train_step_losses_match_jax(two_steps, step):
    """Per-step loss, EPE and accu3 to rel 2e-3 (tests/test_train_golden.py's
    loss bound), disparities finite and of the crop's shape."""
    _, out = two_steps
    (_, jm, jd), (_, pm, pd) = out[step]["jax"], out[step]["port"]
    for k in ("loss", "epe", "accu3"):
        assert pm[k] == pytest.approx(jm[k], rel=2e-3, abs=2e-3), (k, pm, jm)
    assert pd.shape == jd.shape == (2, CROP_H, CROP_W) and np.isfinite(pd).all()


def test_bn_running_stats_after_one_step_match_jax(two_steps):
    """After step 1 the parameters are still equal, so the running statistics
    differ only by rounding: 1e-5."""
    _, out = two_steps
    want = dict(jax.tree_util.tree_leaves_with_path(out[0]["jax"][0].batch_stats))
    got = dict(jax.tree_util.tree_leaves_with_path(out[0]["port"][0]["batch_stats"]))
    assert want.keys() == got.keys() and len(want) == 36
    for path, w in want.items():
        np.testing.assert_allclose(np.asarray(got[path]), np.asarray(w),
                                   rtol=1e-5, atol=1e-5, err_msg=str(path))


def test_step_one_gradients_match_jax(two_steps):
    """Step 1's gradient of every parameter tensor, the port's ``.grad``
    against JAX's (read off its Adam state: after one step the first moment
    is (1 - b1) * g), to a relative L2 error of GRAD_RTOL."""
    _, out = two_steps
    mu = out[0]["jax"][0].opt_state.inner_state[0].mu
    want = dict(jax.tree_util.tree_leaves_with_path(mu))
    got = dict(jax.tree_util.tree_leaves_with_path(out[0]["port_grads"]))
    assert want.keys() == got.keys()
    errs = {}
    for path, m in want.items():
        w = np.asarray(m, np.float64) / (1 - 0.9)
        g = np.asarray(got[path], np.float64)
        norm = np.linalg.norm(w)
        if norm == 0:                              # deconv5's bias
            assert not g.any(), path
            continue
        errs[jax.tree_util.keystr(path)] = np.linalg.norm(g - w) / norm
    worst = max(errs, key=errs.get)
    print(f"worst gradient relative L2 error {errs[worst]:.3g} ({worst})")
    assert errs[worst] <= GRAD_RTOL, (worst, errs[worst])


def test_params_after_one_step_match_jax_in_sign(two_steps):
    """Adam's first update is lr * g / (|g| + eps), about lr * sign(g): more
    than 99% of the components must have moved the same way as in JAX
    (|d| < lr / 10); the rest are gradients near 0, whose sign is rounding."""
    _, out = two_steps
    want = dict(jax.tree_util.tree_leaves_with_path(out[0]["jax"][0].params))
    got = dict(jax.tree_util.tree_leaves_with_path(out[0]["port"][0]["params"]))
    d = np.concatenate([np.abs(np.asarray(got[p]) - np.asarray(w)).ravel()
                        for p, w in want.items()])
    assert (d < LR / 10).mean() > 0.99, (d < LR / 10).mean()


def test_params_after_two_steps_match_jax(two_steps):
    """Each parameter within 2*lr*steps (+10%): Adam moves a component whose
    gradient is ~0 by up to lr either way, and its sign may differ between
    two float32 conv implementations; the mean drift below 1.5e-3 is the
    real check (the bounds of tests/test_train_golden.py)."""
    _, out = two_steps
    want = dict(jax.tree_util.tree_leaves_with_path(out[1]["jax"][0].params))
    got = dict(jax.tree_util.tree_leaves_with_path(out[1]["port"][0]["params"]))
    assert want.keys() == got.keys()
    diffs = []
    for path, w in want.items():
        d = np.abs(np.asarray(got[path]) - np.asarray(w))
        diffs.append(d.ravel())
        assert d.max() <= 2 * LR * 2 * 1.1, (path, d.max())
    assert np.concatenate(diffs).mean() < 1.5e-3


def test_deconv5_bias_unchanged(two_steps):
    """The head leaves deconv5's bias out of its graph: no gradient, so
    Adam keeps it (JAX: an exactly-zero gradient)."""
    port, out = two_steps
    assert port.model.deconv5.bias.grad is None
    assert port.model.deconv5.bias.item() == BIAS
    assert float(np.asarray(out[1]["jax"][0].params["deconv5"]["bias"])[0]) == BIAS
    assert port.step == 2


# -- grad_accum and the lr schedule -----------------------------------------

def test_grad_accum_on_a_duplicated_batch_equals_the_batch_1_step():
    """Two identical micro-batches: the same update as one batch-1 step
    (bounds of tests/test_engine.py:272-323)."""
    b = _batch(20, n=1)
    geom = (b["board_h"], b["board_w_left"], b["board_w_right"])
    t1 = Trainer(_cfg(batch_size=1), device="cpu", seed=4)
    m1, d1 = t1.step_fn(*geom)(b["iml"], b["imr"], b["disp"], LR)
    t2 = Trainer(_cfg(batch_size=2, grad_accum=2), device="cpu", seed=4)
    dup = {k: np.concatenate([b[k], b[k]]) for k in ("iml", "imr", "disp")}
    m2, d2 = t2.step_fn(*geom)(dup["iml"], dup["imr"], dup["disp"], LR)
    assert abs(float(m1["loss"]) - float(m2["loss"])) < 1e-5
    drift = []
    for (k, a), (_, c) in zip(t1.model.named_parameters(),
                              t2.model.named_parameters()):
        np.testing.assert_allclose(c.detach().numpy(), a.detach().numpy(),
                                   rtol=1e-4, atol=2.2e-3, err_msg=k)
        drift.append((c - a).abs().detach().numpy().ravel())
    assert np.concatenate(drift).mean() < 1e-5
    for half in (d2[:1], d2[1:]):
        np.testing.assert_allclose(half.numpy(), d1.numpy(), rtol=1e-4, atol=1e-4)
    # BN statistics threaded through both micro-batches: two updates
    assert int(t2.model.conv3dbn_1[1].num_batches_tracked) == 2


def test_matcher_probe_finds_the_disparity():
    """The four matching-cost channels' argmin over disparity, on a crop of
    known disparity 6 (3 at the features' half resolution)."""
    t = Trainer(_cfg(), device="cpu")
    b = _batch(30, shift=6)
    geom = (b["board_h"], b["board_w_left"], b["board_w_right"])
    probe = t.matcher_probe_fn(*geom)(b["iml"], b["imr"])
    assert probe.dtype == torch.float32 and tuple(probe.shape) == (2, 4, 16, 32)
    census = probe[:, 0, 4:-4, 4:-4]
    assert (census == 3).float().mean().item() > 0.9


def test_epoch_lr():
    assert epoch_lr(1e-3, 1) == 1e-3
    assert epoch_lr(1e-3, 200) == 1e-3
    assert epoch_lr(1e-3, 201) == pytest.approx(1e-4)
    assert epoch_lr(2e-3, 11, decay_epoch=10, factor=0.5) == pytest.approx(1e-3)


@pytest.mark.parametrize("name", ["MatchingConfig", "ModelConfig",
                                  "TrainConfig", "DataConfig", "EvalConfig"])
def test_config_defaults_match_jax(name):
    """Every field the port carries has the JAX package's default."""
    import dataclasses
    import msnets_tpu.config as JC
    import msnets_tpu_torch.config as TC
    port = dataclasses.asdict(getattr(TC, name)())
    jax_side = dataclasses.asdict(getattr(JC, name)())
    assert port == {k: jax_side[k] for k in port}
    if name != "ModelConfig":          # TPU-only model fields stay out
        assert port.keys() == jax_side.keys()


def test_config_json_round_trip_and_jax_json():
    cfg = Config(matching=MatchingConfig(num_channels=16, board_h=4),
                 model=ModelConfig(max_disp=64, compute_dtype="float32"),
                 train=TrainConfig(lr=2e-3, grad_accum=2),
                 data=DataConfig(kitti2015=True),
                 eval=EvalConfig(result_dir="r", save_color=False), mode="test")
    assert Config.from_json(cfg.to_json()) == cfg
    jcfg = JaxConfig(model=JaxModelConfig(max_disp=64, quant_eval=True,
                                          quant_mode="static",
                                          quant_scope="stem",
                                          mid_deconv_mode="conv_shuffle"),
                     train=JaxTrainConfig(batch_size=4), mode="loop-train")
    got = Config.from_json(jcfg.to_json())
    assert (got.model.max_disp, got.model.quant_eval, got.model.quant_mode,
            got.model.quant_scope, got.train.batch_size,
            got.mode) == (64, True, "static", "stem", 4, "loop-train")
    # a layout knob the port does not carry is dropped; packed_eval_outer,
    # which changes which convs run int8, is carried with quant_eval or not
    off = JaxConfig(model=JaxModelConfig(quant_eval=True,
                                         packed_eval_outer=False))
    assert Config.from_json(off.to_json()).model == ModelConfig(
        quant_eval=True, packed_eval_outer=False)
    assert Config.from_json(JaxConfig(model=JaxModelConfig(
        packed_eval_outer=False, mid_deconv_mode="conv_shuffle")).to_json()
    ).model == ModelConfig(packed_eval_outer=False)


def test_trainer_config_checks():
    with pytest.raises(ValueError):
        Trainer(_cfg(batch_size=3, grad_accum=2), device="cpu")
    with pytest.raises(NotImplementedError, match="quarter_input.*ds_scale"):
        Trainer(Config(model=ModelConfig(quarter_input=True)), device="cpu")
    with pytest.raises(ValueError):
        Trainer(Config(model=ModelConfig(name="MS-PSMNet"),
                       train=TrainConfig(remat=True, remat_scope="stem")),
                device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            Trainer(_cfg())
    t = Trainer(_cfg(), device="cpu")
    assert t.feats_shape_for(2) == (2, 8, 16, 16, 32)
    assert t.model.training and t.model.compute_dtype == torch.float32
