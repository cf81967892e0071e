"""``remat`` in the port (layers.remat through torch.utils.checkpoint): with
it on, MS-PSMNet (both scopes) and MS-GCNet give the outputs, gradients and
BatchNorm running statistics of the plain graph, each BN updates its
statistics once a step, and the recomputation really runs."""
import numpy as np
import pytest
import torch

from msnets_tpu_torch.config import Config, ModelConfig, TrainConfig
from msnets_tpu_torch.data.pipeline import synthetic_train_batch
from msnets_tpu_torch.engine import Trainer
from msnets_tpu_torch.models import MSGCNet, MSPSMNet
from msnets_tpu_torch.models.layers import BatchNorm3d, ConvBN3D, remat
from msnets_tpu_torch.runtime import fp32_reference

TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with fp32_reference():
        yield
    torch.set_num_threads(n)


def _psmnet(**kw):
    return MSPSMNet(16, 8, 4, generator=torch.Generator().manual_seed(1), **kw)


def _gcnet(**kw):
    return MSGCNet(32, 8, 4, generator=torch.Generator().manual_seed(1), **kw)


MODELS = {
    "psmnet-all": (_psmnet, {"remat": True, "remat_scope": "all"},
                   (2, 8, 8, 8, 16)),
    "psmnet-hourglass": (_psmnet, {"remat": True, "remat_scope": "hourglass"},
                         (2, 8, 8, 8, 16)),
    "gcnet": (_gcnet, {"remat": True}, (2, 8, 16, 16, 16)),
}


def _train_forward_backward(model, shape):
    """One train-mode forward and backward of a loss on every head; returns
    the outputs, the gradients and the state_dict after it."""
    x = torch.from_numpy(
        np.random.default_rng(0).standard_normal(shape).astype(np.float32))
    model.train()
    outs = model(x)
    outs = outs if isinstance(outs, tuple) else (outs,)
    sum((o - 3.0).square().mean() for o in outs).backward()
    grads = {k: p.grad.clone() for k, p in model.named_parameters()
             if p.grad is not None}
    return ([o.detach() for o in outs], grads,
            {k: v.clone() for k, v in model.state_dict().items()})


@pytest.mark.parametrize("name", list(MODELS))
def test_remat_matches_the_plain_graph(name):
    make, kw, shape = MODELS[name]
    outs, grads, state = _train_forward_backward(make(), shape)
    r_outs, r_grads, r_state = _train_forward_backward(make(**kw), shape)
    for a, b in zip(r_outs, outs):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=TOL, atol=TOL)
    assert r_grads.keys() == grads.keys() and grads
    for k, g in grads.items():
        np.testing.assert_allclose(r_grads[k].numpy(), g.numpy(), rtol=TOL,
                                   atol=TOL, err_msg=k)
    for k, v in state.items():
        np.testing.assert_allclose(r_state[k].numpy(), v.numpy(), rtol=TOL,
                                   atol=TOL, err_msg=k)


@pytest.mark.parametrize("name", list(MODELS))
def test_each_bn_updates_its_statistics_once_a_step(name, monkeypatch):
    """Every BN's num_batches_tracked is 1 after one forward and backward,
    while the wrapped stages' BNs ran twice (the recomputation) and only
    the stages outside the remat scope ran once."""
    make, kw, shape = MODELS[name]
    calls = {}
    forward = BatchNorm3d.forward

    def spy(self, x):
        calls[id(self)] = calls.get(id(self), 0) + 1
        return forward(self, x)

    monkeypatch.setattr(BatchNorm3d, "forward", spy)
    model = make(**kw)
    _, _, state = _train_forward_backward(model, shape)
    tracked = {k: int(v) for k, v in state.items()
               if k.endswith("num_batches_tracked")}
    assert set(tracked.values()) == {1}, tracked
    twice = {n for n, m in model.named_modules()
             if isinstance(m, BatchNorm3d) and calls[id(m)] == 2}
    once = {n for n, m in model.named_modules()
            if isinstance(m, BatchNorm3d) and calls[id(m)] == 1}
    assert len(twice) + len(once) == len(tracked)
    if kw.get("remat_scope") == "hourglass":
        assert twice and all(n.startswith(("dres2", "dres3", "dres4"))
                             for n in twice)
        assert {n.split(".")[0] for n in once} == {
            "dres0", "dres1", "classif1", "classif2", "classif3"}
    else:
        assert once == set(), once


def test_remat_is_plain_in_eval_and_without_gradients():
    """Eval mode and no_grad run the stage directly: no recomputation."""
    stage = ConvBN3D(2, 3)
    x = torch.randn(1, 2, 4, 4, 4)
    with torch.no_grad():
        y = remat(stage.train(), x)
    assert y.grad_fn is None and int(stage[1].num_batches_tracked) == 1
    y = remat(stage.eval(), x.requires_grad_())
    assert int(stage[1].num_batches_tracked) == 1
    assert "Checkpoint" not in type(y.grad_fn).__name__


def _trainer_cfg(name, remat, scope="all", grad_accum=1):
    return Config(model=ModelConfig(name=name, max_disp=32, base_filters=4,
                                    compute_dtype="float32"),
                  train=TrainConfig(crop_height=32, crop_width=64,
                                    batch_size=2, remat=remat,
                                    remat_scope=scope, grad_accum=grad_accum))


@pytest.mark.parametrize("name,scope", [("MS-PSMNet", "all"),
                                        ("MS-PSMNet", "hourglass"),
                                        ("MS-GCNet", "all")])
def test_trainer_step_with_remat_equals_the_plain_step(name, scope):
    """One Trainer step (features, model, loss, backward, Adam) from the
    same seed: the same loss, parameters and BN statistics."""
    b = synthetic_train_batch(32, 64, 32, Config().matching, 2, 5, 0)
    geom = (b["board_h"], b["board_w_left"], b["board_w_right"])
    out = []
    for remat_on in (False, True):
        tr = Trainer(_trainer_cfg(name, remat_on, scope), device="cpu", seed=2)
        assert tr.model.training
        m, d = tr.step_fn(*geom)(b["iml"], b["imr"], b["disp"], 1e-3)
        out.append((float(m["loss"]), d, tr.model.state_dict()))
    (l0, d0, s0), (l1, d1, s1) = out
    assert np.isfinite(l0) and l1 == pytest.approx(l0, rel=TOL)
    np.testing.assert_allclose(d1.numpy(), d0.numpy(), rtol=TOL, atol=TOL)
    for k, v in s0.items():
        np.testing.assert_allclose(s1[k].numpy(), v.numpy(), rtol=TOL,
                                   atol=TOL, err_msg=k)


def test_psmnet_trainer_grad_accum_threads_bn_statistics():
    """The CLI's MS-PSMNet default at batch 2 (no remat, grad_accum 2): each
    BN updated once per micro-batch."""
    b = synthetic_train_batch(32, 64, 32, Config().matching, 2, 5, 1)
    tr = Trainer(_trainer_cfg("MS-PSMNet", False, grad_accum=2), device="cpu")
    m, d = tr.step_fn(b["board_h"], b["board_w_left"], b["board_w_right"])(
        b["iml"], b["imr"], b["disp"], 1e-3)
    assert np.isfinite(float(m["loss"])) and tuple(d.shape) == (2, 32, 64)
    assert {int(v) for k, v in tr.model.state_dict().items()
            if k.endswith("num_batches_tracked")} == {2}
