"""The port's int8 eval of whole models (msnets_tpu_torch/models/quant.py
through the folded MS-GCNet and MS-PSMNet, the server and the evaluator)
against the JAX package's, float32 on the CPU, F=8, max_disp 32, a
16x16x32 volume.

Tolerance. Between the packages the float32 sums ahead of a quantizer run
in another order, so a value lying on a rounding boundary of the int8 grid
can land one step away; the disparity then moves by a fraction of what
int8 itself moves it. So the port-vs-JAX gap (mean |d disparity|) must be
at least 100 times below the same model's int8-vs-float32 gap in JAX, and
the tests count the quantized values that landed elsewhere (flips): the
JAX inputs of every int8 conv are captured (``flax.linen.intercept_methods``)
and quantized as JAX does, beside the port's."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from flax import linen as fnn

from msnets_tpu.models import MSGCNet as JaxMSGCNet, MSPSMNet as JaxMSPSMNet
from msnets_tpu.models.layers import ConvBN3D as JaxConvBN3D
from msnets_tpu.models.layers import _quant_act, hw_unpack
from msnets_tpu.models.torch_convert import convert_state_dict
from msnets_tpu_torch.config import Config, ModelConfig
from msnets_tpu_torch.models import build_model, fold_batchnorm, quant_convs
from msnets_tpu_torch.models import quant as Q
from msnets_tpu_torch.models.convert import quant_stats_from_jax
from msnets_tpu_torch.runtime import fp32_reference
from msnets_tpu_torch.serve import StereoServer

MAX_DISP, F = 32, 8
VOLUME = (1, 8, 16, 16, 32)
# name -> (model, quant_scope)
MODELS = {"gcnet-all": ("MS-GCNet", "all"), "gcnet-stem": ("MS-GCNet", "stem"),
          "psmnet": ("MS-PSMNet", "all"),
          "psmnet-full-outer": ("MS-PSMNet", "all")}
# MS-PSMNet's packed_eval_outer by name (JAX's default True elsewhere): at
# False dres3's and dres4's conv1 read the full layout, below the stride-2
# gate at VOLUME, and compute in float
OUTER = {"psmnet-full-outer": False}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with fp32_reference():
        yield
    torch.set_num_threads(n)


def _cfg(model, scope="all", mode="dynamic", quant=True, **kw):
    return ModelConfig(name=model, max_disp=MAX_DISP, base_filters=F,
                       compute_dtype="float32", quant_eval=quant,
                       quant_mode=mode, quant_scope=scope, **kw)


def _randomize_bn(m, seed):
    rng = np.random.default_rng(seed)
    f = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa: E731
    with torch.no_grad():
        for bn in m.modules():
            if isinstance(bn, torch.nn.BatchNorm3d):
                c = bn.num_features
                bn.weight.copy_(f(rng.uniform(0.5, 1.5, c)))
                bn.bias.copy_(f(rng.normal(0, 0.2, c)))
                bn.running_mean.copy_(f(rng.normal(0, 0.3, c)))
                bn.running_var.copy_(f(rng.uniform(0.5, 2.0, c)))
    return m


def _state_dict(model, seed=0):
    m = build_model(_cfg(model, quant=False), "cpu",
                    torch.Generator().manual_seed(seed))
    return _randomize_bn(m, seed + 1).state_dict()


def _port(cfg, sd):
    m = build_model(cfg, "cpu")
    m.load_state_dict(sd)
    return fold_batchnorm(m)


def _jax_model(model, scope, mode=None, outer=True):
    kw = dict(max_disp=MAX_DISP, dtype=jnp.float32)
    if mode is not None:
        kw.update(quant_eval=True, quant_mode=mode)
    if model == "MS-GCNet":
        return JaxMSGCNet(num_filters=F, quant_scope=scope, **kw)
    return JaxMSPSMNet(base_filters=F, packed_eval_outer=outer, **kw)


def _to_full(x, layout):
    """A JAX volume in ``layout`` as the full [N, D, H, W, C] one."""
    if layout == "std":
        return hw_unpack(x)
    if layout == "shift":
        return hw_unpack(x)[:, :, 1:-1, 1:-1]
    return x


def _jax_run(model, scope, mode, variables, cv, outer=True):
    """The JAX model's disparity and, for each int8 conv, the int8 values
    JAX quantizes its input to (full layout, NDHWC)."""
    jm = _jax_model(model, scope, mode, outer)
    seen = []

    def fn(v, f):
        inputs = []

        def capture(next_fun, args, kwargs, ctx):
            m = ctx.module
            if (isinstance(m, JaxConvBN3D) and m.quant
                    and ctx.method_name == "__call__" and not args[1]):
                lin = args[2] if len(args) > 2 else kwargs.get("lin", "full")
                seen.append(".".join(m.scope.path))
                inputs.append(_to_full(args[0], lin))
            return next_fun(*args, **kwargs)

        with fnn.intercept_methods(capture):
            out = jm.apply(v, f, train=False)
        return out, inputs

    out, inputs = jax.jit(fn)(variables, cv)
    stats = variables.get("quant_stats")
    xq = {}
    for path, x in zip(seen, inputs):
        scale = None
        if mode == "static":
            tree = stats
            for k in path.split("."):
                tree = tree[k]
            scale = tree["act_amax"] / 127.0
        xq[path] = np.asarray(jax.jit(_quant_act)(x, scale)[0])
    return np.asarray(out), xq


def _port_run(model, sd, scope, mode, cv, stats=None, outer=True):
    """The port's folded model's disparity and the int8 values of each
    int8 conv's input (NDHWC)."""
    m = _port(_cfg(model, scope, mode, packed_eval_outer=outer), sd)
    if stats is not None:
        Q.load_quant_stats(m, stats)
    xq, hooks = {}, []
    for path, qm in Q.quant_modules(m).items():
        def hook(mod, args, _out, path=path):
            if mod.site.runs_int8(tuple(args[0].shape[2:])):
                scale = mod._scale() if mod.mode == "static" else None
                q = Q.quantize_activation(args[0], scale)[0]
                xq[path] = q.permute(0, 2, 3, 4, 1).numpy()
        hooks.append(qm.register_forward_hook(hook))
    with torch.no_grad():
        out = m(torch.from_numpy(cv)).numpy()
    return out, xq, m


@pytest.fixture(scope="module")
def runs():
    """Per model: the port and JAX disparities, float32 and int8 in each
    mode, the calibrations and the quantized values."""
    cv = np.random.default_rng(3).random(VOLUME, dtype=np.float32)
    cvj = jnp.asarray(np.moveaxis(cv, 1, -1))
    out = {}
    for name, (model, scope) in MODELS.items():
        outer = OUTER.get(name, True)
        sd = _state_dict(model)
        v = convert_state_dict(sd, model)
        r = {"sd": sd, "cv": cv}
        r["jax_f32"] = np.asarray(jax.jit(lambda v, f: _jax_model(
            model, scope, outer=outer).apply(v, f, train=False))(v, cvj))
        r["jax_dynamic"], r["jax_xq_dynamic"] = _jax_run(
            model, scope, "dynamic", v, cvj, outer)
        _, qs = jax.jit(lambda v, f: _jax_model(
            model, scope, "calib", outer).apply(
            v, f, train=False, mutable=["quant_stats"]))(v, cvj)
        r["jax_stats"] = quant_stats_from_jax(qs)
        r["jax_static"], r["jax_xq_static"] = _jax_run(
            model, scope, "static", dict(v, **qs), cvj, outer)
        r["port_dynamic"], r["port_xq_dynamic"], _ = _port_run(
            model, sd, scope, "dynamic", cv, outer=outer)
        calib = _port(_cfg(model, scope, "calib",
                           packed_eval_outer=outer), sd)
        with torch.no_grad():
            calib(torch.from_numpy(cv))
        r["port_stats"] = Q.quant_stats(calib, recorded=True)
        r["port_static_jax_stats"], r["port_xq_static"], _ = _port_run(
            model, sd, scope, "static", cv, r["jax_stats"], outer)
        r["port_static"], r["port_xq_own"], _ = _port_run(
            model, sd, scope, "static", cv, r["port_stats"], outer)
        out[name] = r
    return out


def _gap(a, b):
    return float(np.abs(a - b).mean())


def _flips(name, port_xq, jax_xq):
    """(values that differ, values, the largest difference in steps) over
    the convs that run int8; JAX captures every flagged conv's input."""
    model, scope = MODELS[name]
    int8 = quant_convs(model, _cfg(model, scope, packed_eval_outer=OUTER.get(
        name, True)), VOLUME)
    assert sorted(port_xq) == sorted(p for p, v in int8.items() if v)
    assert set(port_xq) <= set(jax_xq)
    n = sum(int((port_xq[p] != jax_xq[p]).sum()) for p in port_xq)
    total = sum(v.size for v in port_xq.values())
    steps = max(int(np.abs(port_xq[p].astype(np.int32)
                           - jax_xq[p].astype(np.int32)).max())
                for p in port_xq)
    return n, total, steps


@pytest.mark.parametrize("name", list(MODELS))
def test_dynamic_int8_matches_jax(runs, name):
    """The same weights and volume through both packages' int8 models:
    the int8 convs are the ones JAX quantizes, their int8 inputs equal
    JAX's but for a few one-step flips, and the disparity gap is at least
    100 times below int8's own move from float32."""
    r = runs[name]
    n, total, steps = _flips(name, r["port_xq_dynamic"], r["jax_xq_dynamic"])
    gap = _gap(r["port_dynamic"], r["jax_dynamic"])
    int8 = _gap(r["jax_dynamic"], r["jax_f32"])
    print(f"{name} dynamic: {n} of {total} int8 values flipped (<= {steps} "
          f"step); port-JAX {gap:.3g} px, int8-float32 {int8:.3g} px")
    assert r["port_dynamic"].shape == (1, 32, 64)
    assert steps <= 1 and n <= total * 1e-3
    assert int8 > 0 and gap * 100 <= int8


@pytest.mark.parametrize("name", list(MODELS))
def test_calibration_matches_jax(runs, name):
    """A "calib" forward records the input absmax of the same convs as
    JAX's quant_stats collection, to 1e-6 relative (the inputs differ by
    float32 summation order)."""
    r = runs[name]
    assert sorted(r["port_stats"]) == sorted(r["jax_stats"])
    model, scope = MODELS[name]
    assert sorted(r["port_stats"]) == sorted(
        quant_convs(model, _cfg(model, scope), VOLUME))
    for p, v in r["jax_stats"].items():
        assert v > 0 and abs(r["port_stats"][p] - v) <= 1e-6 * v, p


@pytest.mark.parametrize("name", list(MODELS))
def test_static_int8_matches_jax(runs, name):
    """Static int8 with JAX's calibration (quant_stats_from_jax): flips and
    the 100x gap bound as in dynamic mode. With each package's own
    calibration the scales themselves differ by up to 1e-6 relative, which
    moves every value on the int8 grid, not only those on a boundary: more
    values flip (MS-PSMNet: 334 of 393,216, one step each, across its 6
    int8 convs; none with JAX's calibration), and the gap is held to 20
    times below int8's move (measured 82 times for MS-PSMNet, 5,900 for
    MS-GCNet)."""
    r = runs[name]
    n, total, steps = _flips(name, r["port_xq_static"], r["jax_xq_static"])
    n_own, _, steps_own = _flips(name, r["port_xq_own"], r["jax_xq_static"])
    gap = _gap(r["port_static_jax_stats"], r["jax_static"])
    own = _gap(r["port_static"], r["jax_static"])
    int8 = _gap(r["jax_static"], r["jax_f32"])
    print(f"{name} static: {n} of {total} int8 values flipped (<= {steps} "
          f"step), port-JAX {gap:.3g} px with JAX's calibration; {n_own} "
          f"flipped (<= {steps_own}), {own:.3g} px with its own; "
          f"int8-float32 {int8:.3g} px")
    assert steps <= 1 and n <= total * 1e-3
    assert int8 > 0 and gap * 100 <= int8
    assert steps_own <= 1 and n_own <= total * 1e-2
    assert own * 20 <= int8


@pytest.mark.parametrize("name", list(MODELS))
def test_jax_calibration_through_the_bridge(runs, name):
    """quant_stats_from_jax reads a JAX quant_stats tree into the port's
    dotted mapping: a tree of JAX's structure holding the port's own
    calibration gives the port's static forward bit for bit."""
    r = runs[name]
    model, scope = MODELS[name]
    tree = {}
    for p, v in r["port_stats"].items():
        node = tree
        for k in p.split("."):
            node = node.setdefault(k, {})
        node["act_amax"] = jnp.float32(v)
    stats = quant_stats_from_jax({"quant_stats": tree})
    assert stats == r["port_stats"]
    out, _, _ = _port_run(model, r["sd"], scope, "static", r["cv"], stats,
                          OUTER.get(name, True))
    np.testing.assert_array_equal(out, r["port_static"])


@pytest.mark.parametrize("model", ["MS-GCNet", "MS-PSMNet"])
def test_train_mode_with_quant_eval_is_the_plain_model(model):
    """Train mode never quantizes (JAX gcnet.py:67, psmnet.py:173): the
    forward and the gradients of a quant_eval model equal the plain
    model's bit for bit."""
    sd = _state_dict(model, 5)
    x = torch.from_numpy(np.random.default_rng(6).random(
        VOLUME, dtype=np.float32))
    outs = []
    for quant in (False, True):
        m = build_model(_cfg(model, quant=quant), "cpu")
        m.load_state_dict(sd)
        m.train()
        y = m(x)
        loss = sum(t.square().mean() for t in (y if isinstance(y, tuple)
                                               else (y,)))
        loss.backward()
        outs.append([loss.detach()] + [p.grad for p in m.parameters()]
                    + [b.clone() for b in m.buffers()])
    for a, b in zip(*outs):           # deconv5.bias takes no gradient
        assert (a is None and b is None) or torch.equal(a, b)


# -- the server ----------------------------------------------------------------

def _server_cfg(model="MS-GCNet", mode="dynamic", dtype="float32"):
    return Config(model=ModelConfig(name=model, max_disp=MAX_DISP,
                                    base_filters=F, compute_dtype=dtype,
                                    quant_eval=True, quant_mode=mode))


def _pair(h=64, w=128, seed=0):
    base = np.random.default_rng(seed).integers(0, 256, (h, w + 6),
                                                dtype=np.uint8)
    return np.ascontiguousarray(base[:, 6:]), np.ascontiguousarray(base[:, :w])


def test_server_applies_the_jax_checks():
    """As msnets_tpu/serve.py: static without quant_stats raises; an
    all-zero mapping counts as uncalibrated (static raises, dynamic serves
    without it); a zero layer under static raises naming it; a layer the
    model does not quantize raises."""
    sd = _state_dict("MS-GCNet")
    paths = sorted(quant_convs("MS-GCNet", _cfg("MS-GCNet"), VOLUME))
    zeros = {p: 0.0 for p in paths}
    static = _server_cfg(mode="static")
    with pytest.raises(ValueError, match="quant_stats"):
        StereoServer(static, sd, device="cpu")
    with pytest.raises(ValueError, match="quant_stats"):
        StereoServer(static, sd, device="cpu", quant_stats=zeros)
    one_zero = dict({p: 1.0 for p in paths}, conv3dbn_2=0.0)
    with pytest.raises(ValueError, match="conv3dbn_2"):
        StereoServer(static, sd, device="cpu", quant_stats=one_zero)
    with pytest.raises(KeyError, match="dres0_2"):
        StereoServer(static, sd, device="cpu",
                     quant_stats=dict(one_zero, conv3dbn_2=1.0, dres0_2=2.0))
    srv = StereoServer(_server_cfg(), sd, device="cpu", quant_stats=zeros)
    assert not any(srv.quant_stats().values())
    d = srv.predict(*_pair())
    assert d.shape == (64, 128) and np.isfinite(d).all()


def test_bf16_server_keeps_the_int8_convs_float32():
    """The folded kernels the quantizer reads stay float32 in a bfloat16
    server (JAX quantizes kf = kernel * a in float32); every other conv is
    bfloat16; the forward is the folded model's on the features."""
    sd = _state_dict("MS-PSMNet")
    srv = StereoServer(_server_cfg("MS-PSMNet", dtype="bfloat16"), sd,
                       device="cpu")
    qm = Q.quant_modules(srv.model)
    assert len(qm) == 9
    for m in srv.model.modules():
        if isinstance(m, Q.QuantConv3d):
            assert m.weight.dtype == m.bias.dtype == torch.float32
        elif isinstance(m, (torch.nn.Conv3d, torch.nn.ConvTranspose3d)):
            assert m.weight.dtype == torch.bfloat16
    il, ir = (torch.from_numpy(a) for a in _pair())
    with torch.inference_mode():
        want = srv.model(srv.features(il, ir)[None])
    np.testing.assert_array_equal(srv.forward(il, ir).numpy(), want.numpy())
    assert np.isfinite(want.numpy()).all()


def test_server_calibration_widens_over_shapes():
    """A "calib" server records each conv's absmax over the frames it
    serves, max-accumulated: a second, brighter frame of another shape
    only widens it; "static" then serves with those scales."""
    sd = _state_dict("MS-GCNet")
    srv = StereoServer(_server_cfg(mode="calib"), sd, device="cpu")
    l, r = _pair(64, 128, 1)
    srv.predict(l // 2, r // 2)
    first = srv.quant_stats(recorded=True)
    assert sorted(first) == sorted(quant_convs(
        "MS-GCNet", _cfg("MS-GCNet"), (1, 8, 16, 32, 64)))
    srv.predict(*_pair(96, 160, 2))
    both = srv.quant_stats(recorded=True)
    assert all(both[p] >= first[p] for p in first)
    assert any(both[p] > first[p] for p in first)
    static = StereoServer(_server_cfg(mode="static"), sd, device="cpu",
                          quant_stats=both)
    assert static.quant_stats() == both
    d = static.predict(l, r)
    assert d.shape == (64, 128) and np.isfinite(d).all()
    srv.set_quant_mode("static")
    np.testing.assert_array_equal(srv.predict(l, r), d)


def test_from_checkpoint_and_stream_serve_int8(tmp_path):
    """StereoServer.from_checkpoint passes quant_stats on to the server it
    builds; predict_stream serves int8 frames as predict does."""
    sd = _state_dict("MS-GCNet")
    torch.save({"state_dict": sd}, tmp_path / "ref.tar")
    stats = {p: 1.5 for p in quant_convs("MS-GCNet", _cfg("MS-GCNet"),
                                         VOLUME)}
    srv = StereoServer.from_checkpoint(_server_cfg(mode="static"),
                                       str(tmp_path / "ref.tar"),
                                       device="cpu", quant_stats=stats)
    assert srv.quant_stats() == stats
    pairs = [_pair(64, 128, 3), _pair(64, 96, 4)]
    want = [srv.predict(a, b) for a, b in pairs]
    for got, w in zip(srv.predict_stream(iter(pairs)), want):
        np.testing.assert_array_equal(got, w)
