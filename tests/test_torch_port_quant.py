"""The port's int8 eval building blocks (msnets_tpu_torch/models/quant.py,
ops/cuda/int8_quantize.py, ops/cuda/int8_conv3d.py) against the JAX
package's: the quantizers ``_quant_act`` and ``_quant_kernels`` bit for bit,
the quantized conv (the plain versions of its kernels on the CPU) against
each quantized JAX lowering bit for bit, the coverage rule ``quant_convs``
against the layouts' table, the keys of JAX's calibration and the convs
JAX quantizes, and the int32 conv's plain version against a direct integer
sum; the plain versions of the fused kernels against the unfused passes
they replace, bit for bit."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from msnets_tpu.models import MSGCNet as JaxMSGCNet, MSPSMNet as JaxMSPSMNet
from msnets_tpu.models.layers import (_quant_act, _quant_kernels,
                                      conv3d_ndhwc, conv3d_s1_full_to_packed,
                                      conv3d_s1_hw_packed, conv3d_s2_hw_s2d,
                                      hw_pack, hw_unpack)
from msnets_tpu.models.torch_convert import convert_state_dict
from msnets_tpu_torch.config import ModelConfig
from msnets_tpu_torch.models import build_model, quant_convs
from msnets_tpu_torch.models.convert import quant_stats_from_jax
from msnets_tpu_torch.models.quant import (QuantConv3d, QuantSite,
                                           activation_scale,
                                           quantize_activation,
                                           quantize_kernel, sample_absmax)
from msnets_tpu_torch.ops.cuda.int8_conv3d import (
    int8_conv3d, int8_conv3d_dequant, int8_conv3d_dequant_reference,
    int8_conv3d_reference, pack_weights)
from msnets_tpu_torch.ops.cuda.int8_quantize import (int8_absmax,
                                                     int8_quantize,
                                                     int8_quantize_reference)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_quant_act_jit = jax.jit(_quant_act)
_quant_kernels_jit = jax.jit(lambda k: _quant_kernels([k]))
_quant_act_static = jax.jit(lambda x, a: _quant_act(
    x, jnp.where(a > 0, a, jnp.nan) / 127.0))


def _random_scales(rng, n):
    return [float(10 ** rng.uniform(-6, 6)) for _ in range(n)]


def test_quantize_activation_dynamic_matches_jax_bitwise():
    """Per-sample scales over 200 random magnitudes, samples of unequal
    scale, and an all-zero sample (the 1e-12 clamp): int8 values and the
    float32 scale equal JAX's bit for bit. The scale is max/127 as XLA
    compiles it, a multiply by float32(1/127); a true division differs."""
    rng = np.random.default_rng(0)
    for i, sc in enumerate(_random_scales(rng, 200)):
        x = (rng.standard_normal((3, 4, 5, 6, 7)) * sc).astype(np.float32)
        x[1] *= rng.uniform(1e-3, 1e3)
        if i % 10 == 0:
            x[2] = 0.0
        xq, s = _quant_act_jit(jnp.asarray(x))
        got, gs = quantize_activation(torch.from_numpy(x))
        assert got.dtype == torch.int8
        np.testing.assert_array_equal(got.numpy(), np.asarray(xq))
        np.testing.assert_array_equal(gs.numpy(), np.asarray(s))
        if i % 10 == 0:
            assert not got[2].any()


def test_quantize_activation_static_matches_jax_bitwise():
    """A calibrated absmax: scale act_amax/127 (a float32 reciprocal
    multiply, as JAX's ConvBN3D computes it), then saturation at +-127 for
    values past the calibrated range."""
    from msnets_tpu_torch.ops.matchers import _div_const
    rng = np.random.default_rng(1)
    for sc in _random_scales(rng, 200):
        x = (rng.standard_normal((2, 3, 4, 5, 6)) * sc).astype(np.float32)
        amax = np.float32(np.abs(x).max() * rng.uniform(0.3, 1.5))
        xq, s = _quant_act_static(jnp.asarray(x), jnp.float32(amax))
        scale = _div_const(torch.tensor(amax), 127.0)
        got, gs = quantize_activation(torch.from_numpy(x), scale)
        np.testing.assert_array_equal(gs.numpy(), np.asarray(s))
        np.testing.assert_array_equal(got.numpy(), np.asarray(xq))


def test_quantize_kernel_matches_jax_bitwise():
    """Per-output-channel scales over all 27 taps (JAX _quant_kernels on
    the DHWIO kernel), with a zero output channel and channels of unequal
    magnitude."""
    rng = np.random.default_rng(2)
    for i, sc in enumerate(_random_scales(rng, 100)):
        k = (rng.standard_normal((3, 3, 3, 5, 7)) * sc).astype(np.float32)
        k[..., 3] *= rng.uniform(1e-3, 1e3)
        if i % 10 == 0:
            k[..., 1] = 0.0
        (kq,), sk = _quant_kernels_jit(jnp.asarray(k))
        got, gs = quantize_kernel(torch.from_numpy(
            np.ascontiguousarray(np.transpose(k, (4, 3, 0, 1, 2)))))
        np.testing.assert_array_equal(gs.numpy(), np.asarray(sk))
        np.testing.assert_array_equal(
            np.transpose(got.numpy(), (2, 3, 4, 1, 0)), np.asarray(kq))


# -- the quantized conv against each quantized JAX lowering -------------------

def _port_conv(x, k, stride, kind, dtype=torch.float32, amax=None):
    """QuantConv3d with the kernel ``k`` (DHWIO) and a zero bias on the
    NDHWC volume ``x``; NDHWC out. ``amax``: static mode."""
    site = QuantSite("t", kind)
    m = QuantConv3d(torch.from_numpy(np.ascontiguousarray(
        np.transpose(k, (4, 3, 0, 1, 2)))), torch.zeros(k.shape[-1]), stride,
        site, "dynamic" if amax is None else "static")
    if amax is not None:
        m.set_amax(amax)
    xt = torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1))).to(dtype)
    with torch.no_grad():
        y = m(xt)
    return np.moveaxis(y.float().numpy(), 1, -1)


def _xla_order(x, k, stride, dtype=torch.float32, amax=None):
    """The port's int32 sums dequantized in the order XLA's algebraic
    simplifier gives JAX's ``out * (sx * sk)`` when the activation scale
    is a scalar or of one sample: the two float32(1/127) factors folded
    into one constant, ``kmax * (xmax * c)`` (the compiled HLO shows it);
    JAX's source order otherwise."""
    xt = torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1))).to(dtype)
    kt = torch.from_numpy(np.ascontiguousarray(np.transpose(k, (4, 3, 0, 1, 2))))
    scale = None if amax is None else torch.tensor(
        np.float32(amax) * np.float32(1 / 127))
    xq, _ = quantize_activation(xt, scale)
    kq, _ = quantize_kernel(kt)
    acc = int8_conv3d(xq.permute(0, 2, 3, 4, 1).contiguous(),
                      kq.permute(0, 2, 3, 4, 1).contiguous(), stride)
    kmax = kt.abs().amax(dim=(1, 2, 3, 4)).clamp_min(1e-12).view(1, -1, 1, 1, 1)
    xmax = (torch.tensor(np.float32(amax)) if amax is not None else
            xt.float().abs().amax(dim=(1, 2, 3, 4), keepdim=True).clamp_min(1e-12))
    c = torch.tensor(np.float32(1 / 127) * np.float32(1 / 127))
    y = (acc.float() * (kmax * (xmax * c))).to(dtype)
    return np.moveaxis(y.float().numpy(), 1, -1)


def _ulps(a, b):
    """The largest distance in float32 units in the last place."""
    ia = a.astype(np.float32).view(np.int32).astype(np.int64)
    ib = b.astype(np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(ia - ib).max())


def _shift_pack(x):
    """The shifted packed layout of a full volume: block j holds rows
    (2j - 1, 2j), the out-of-image halo zero."""
    return hw_pack(jnp.pad(x, ((0, 0), (0, 0), (1, 1), (1, 1), (0, 0))))


def _trim(y):
    """A shifted packed output unpacked, without its halo."""
    return hw_unpack(y)[:, :, 1:-1, 1:-1]


LOWERINGS = {
    # name: (stride, port kind, JAX lowering of (x, k, dtype, q, scale))
    "full_to_packed_std": (1, "packed", lambda x, k, dt, s: hw_unpack(
        conv3d_s1_full_to_packed(x, k, dt, False, quantized=True,
                                 act_scale=s))),
    "full_to_packed_shift": (1, "packed", lambda x, k, dt, s: _trim(
        conv3d_s1_full_to_packed(x, k, dt, True, quantized=True,
                                 act_scale=s))),
    "hw_packed_std_to_shift": (1, "packed", lambda x, k, dt, s: _trim(
        conv3d_s1_hw_packed(hw_pack(x), k, dt, True, quantized=True,
                            act_scale=s))),
    "hw_packed_shift_to_std": (1, "packed", lambda x, k, dt, s: hw_unpack(
        conv3d_s1_hw_packed(_shift_pack(x), k, dt, False, quantized=True,
                            act_scale=s))),
    "s2_hw_s2d_packed_input": (2, "entry", lambda x, k, dt, s:
                               conv3d_s2_hw_s2d(hw_pack(x), k, dt,
                                                packed_input=True,
                                                quantized=True, act_scale=s)),
    "s2_hw_s2d_full_input": (2, "entry", lambda x, k, dt, s:
                             conv3d_s2_hw_s2d(x, k, dt, quantized=True,
                                              act_scale=s)),
}


@pytest.mark.parametrize("mode", ["dynamic", "static"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("lowering", list(LOWERINGS))
def test_quantized_conv_matches_jax_lowering_bitwise(lowering, dtype, mode):
    """The same float input and kernel through JAX's quantized lowering
    (packed 2-D int8 convolutions summed over the depth taps, in its
    layout, unpacked) and through the port's QuantConv3d (one int32 3-D
    convolution, its plain version on the CPU), two samples of unequal
    scale, float32 and bfloat16. Dynamic: equal bit for bit. Static: XLA
    folds the two 1/127 factors of the scalar scale product into one
    constant (``_xla_order``); the port keeps JAX's source order, one
    float32 rounding of the scale apart. Its int32 sums dequantized in XLA's order
    equal JAX's bit for bit, which shows the int8 values and the sums
    equal."""
    stride, kind, fn = LOWERINGS[lowering]
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 6, 8, 10, 8)).astype(np.float32)
    x[1] *= 37.0
    k = (rng.standard_normal((3, 3, 3, 8, 16)) * 0.1).astype(np.float32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    xj = jnp.asarray(x).astype(jdt)
    amax = None
    if mode == "static":
        # the calibrated absmax reaches the lowering as a traced value, as
        # from the JAX model's quant_stats (a constant scale would let XLA
        # turn the quantizer's division into a reciprocal multiply)
        amax = float(np.abs(np.asarray(xj.astype(jnp.float32))).max() * 0.8)
        want = jax.jit(lambda x, k, a: fn(x, k, jdt, a / 127.0))(
            xj, jnp.asarray(k), jnp.float32(amax))
    else:
        want = jax.jit(lambda x, k: fn(x, k, jdt, None))(xj, jnp.asarray(k))
    want = np.asarray(want.astype(jnp.float32))
    xf = np.asarray(xj.astype(jnp.float32))
    got = _port_conv(xf, k, stride, kind, tdt, amax)
    assert got.shape == want.shape
    if mode == "dynamic":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_array_equal(_xla_order(xf, k, stride, tdt, amax),
                                      want)
        # the scale products differ by at most one rounding; the product
        # with the sum rounds once more
        assert _ulps(got, want) <= (2 if dtype == "float32" else 2 ** 16)
        if dtype == "bfloat16":     # the bf16 rounding absorbs the ulp
            np.testing.assert_array_equal(got, want)


def test_quantized_conv_is_per_sample():
    """JAX's test_quant_act_scale_is_per_sample on the port: the batch
    [x, 1000 x] gives x's own output for its first sample, bit for bit."""
    rng = np.random.default_rng(11)
    k = (rng.standard_normal((3, 3, 3, 8, 16)) * 0.1).astype(np.float32)
    x0 = rng.standard_normal((1, 6, 10, 10, 8)).astype(np.float32)
    solo = _port_conv(x0, k, 1, "packed")
    both = _port_conv(np.concatenate([x0, 1000 * x0]), k, 1, "packed")
    np.testing.assert_array_equal(both[:1], solo)


@pytest.mark.parametrize("shape,int8", [
    ((1, 64, 128, 128, 4), True),       # 1,048,576 voxels: past the gate
    ((1, 60, 128, 128, 4), False),      # 983,040 voxels: below it
    ((1, 64, 129, 128, 4), False),      # odd H
], ids=["at_gate", "below_gate", "odd_dim"])
def test_stride2_gate_matches_conv3d_ndhwc(shape, int8):
    """conv3d_ndhwc's space-to-depth gate, narrow and cheap (4 channels):
    a full-layout stride-2 conv runs int8 only with D, H and W even and
    D*H*W >= 1,000,000. At the gate the port's int32 sums equal JAX's
    quantized conv bit for bit in XLA's order of the one-sample scale
    product (``_xla_order``) and the port's output is within 2 ulp of it
    (the scale products one rounding apart); below the gate, and with an odd dim, both compute the
    float conv (the port's exactly its plain float conv; against JAX's
    within float32 summation order)."""
    rng = np.random.default_rng(12)
    x = rng.standard_normal(shape).astype(np.float32)
    k = (rng.standard_normal((3, 3, 3, 4, 4)) * 0.2).astype(np.float32)
    site = QuantSite("t", "gate", even_d=True)
    assert site.runs_int8(shape[1:4]) == int8
    want = np.asarray(jax.jit(lambda x, k: conv3d_ndhwc(
        x, k, 2, 1, jnp.float32, quantized=True))(
            jnp.asarray(x), jnp.asarray(k)))
    got = _port_conv(x, k, 2, "gate")
    if int8:
        np.testing.assert_array_equal(_xla_order(x, k, 2), want)
        assert _ulps(got, want) <= 2
    else:
        xt = torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1)))
        kt = torch.from_numpy(np.ascontiguousarray(
            np.transpose(k, (4, 3, 0, 1, 2))))
        plain = np.moveaxis(torch.nn.functional.conv3d(
            xt, kt, torch.zeros(4), 2, 1).numpy(), 1, -1)
        np.testing.assert_array_equal(got, plain)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


# -- the int32 conv ------------------------------------------------------------

def _direct(xq, wq, stride, pad):
    """The int32 convolution as an explicit integer sum (numpy int64)."""
    x = np.pad(xq.astype(np.int64), ((0, 0),) + tuple((p, p) for p in pad)
               + ((0, 0),))
    w = wq.astype(np.int64)
    N, D, H, W, _ = x.shape
    do, ho, wo = ((n - 3) // stride + 1 for n in (D, H, W))
    out = np.zeros((N, w.shape[0], do, ho, wo), np.int64)
    for kd in range(3):
        for kh in range(3):
            for kw in range(3):
                win = x[:, kd:kd + stride * (do - 1) + 1:stride,
                        kh:kh + stride * (ho - 1) + 1:stride,
                        kw:kw + stride * (wo - 1) + 1:stride]
                out += np.einsum("ndhwc,oc->nodhw", win, w[:, kd, kh, kw])
    return out


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("pad", [(1, 1, 1), (0, 1, 1), (1, 0, 1)])
@pytest.mark.parametrize("cin", [4, 8, 5])
def test_int8_conv3d_plain_version_is_exact(stride, pad, cin):
    """The plain version (float64 conv3d) equals the integer sum exactly,
    at odd D, H and W, N = 2, full-range int8 values and per-dim padding;
    CPU tensors take it through the wrapper."""
    rng = np.random.default_rng(stride * 100 + cin + 10 * pad[0] + pad[1])
    xq = rng.integers(-127, 128, (2, 5, 7, 9, cin), dtype=np.int8)
    wq = rng.integers(-127, 128, (6, 3, 3, 3, cin), dtype=np.int8)
    xt, wt = torch.from_numpy(xq), torch.from_numpy(wq)
    got = int8_conv3d(xt, wt, stride, pad)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), _direct(xq, wq, stride, pad))
    assert int8_conv3d.launches == 0             # no kernel on the CPU
    np.testing.assert_array_equal(
        int8_conv3d_reference(xt, wt, stride, pad).numpy(), got.numpy())


def test_int8_conv3d_extreme_sums_are_exact():
    """The largest sums the model's convs make (cin 64, every product
    127^2 or -127*127): 27 * 64 * 127^2 = 27,870,912, past float32's 2^24,
    exact in the plain version."""
    xq = torch.full((1, 3, 3, 3, 64), 127, dtype=torch.int8)
    wq = torch.full((2, 3, 3, 3, 64), 127, dtype=torch.int8)
    wq[1] = -127
    got = int8_conv3d(xq, wq, 1, (0, 0, 0))
    assert got.flatten().tolist() == [27 * 64 * 127 ** 2, -27 * 64 * 127 ** 2]


def test_int8_conv3d_checks_its_inputs():
    xq = torch.zeros((1, 4, 4, 4, 8), dtype=torch.int8)
    wq = torch.zeros((4, 3, 3, 3, 8), dtype=torch.int8)
    with pytest.raises(TypeError):
        int8_conv3d(xq.float(), wq, 1)
    with pytest.raises(ValueError, match="contiguous"):
        int8_conv3d(xq.transpose(1, 2), wq, 1)
    with pytest.raises(ValueError, match="kernel"):
        int8_conv3d(xq, wq[..., :4].contiguous(), 1)
    with pytest.raises(ValueError, match="stride"):
        int8_conv3d(xq, wq, 3)
    with pytest.raises(ValueError, match="padding"):
        int8_conv3d(xq, wq, 1, (2, 1, 1))


# -- coverage ------------------------------------------------------------------

def _int8(model, scope, dhw):
    cfg = ModelConfig(name=model, quant_eval=True, quant_scope=scope)
    return quant_convs(model, cfg, (1, 8) + dhw)


GCNET_ALL = ["conv3dbn_2"] + [f"block_3d_{i}.convbn_3d_1" for i in range(1, 5)]
PSMNET_ALL = (["dres0_2", "dres1_1", "dres1_2"]
              + [f"dres{i}.{c}" for i in (2, 3, 4) for c in ("conv1", "conv3")])


@pytest.mark.parametrize("model,scope,dhw,want", [
    # the card's buckets, D_in = 96: 256x512 -> 96x128x256, 375x1242 ->
    # the 384x1248 bucket, 96x192x624
    ("MS-GCNet", "all", (96, 128, 256),
     ["conv3dbn_2", "block_3d_1.convbn_3d_1"]),
    ("MS-GCNet", "all", (96, 192, 624),
     ["conv3dbn_2", "block_3d_1.convbn_3d_1", "block_3d_2.convbn_3d_1"]),
    ("MS-GCNet", "stem", (96, 128, 256), ["conv3dbn_2"]),
    ("MS-GCNet", "stem", (96, 192, 624), ["conv3dbn_2"]),
    ("MS-PSMNet", "all", (96, 128, 256),
     ["dres0_2", "dres1_1", "dres1_2", "dres2.conv1", "dres3.conv1",
      "dres4.conv1"]),
    ("MS-PSMNet", "all", (96, 192, 624),
     ["dres0_2", "dres1_1", "dres1_2", "dres2.conv1", "dres3.conv1",
      "dres4.conv1", "dres2.conv3", "dres3.conv3", "dres4.conv3"]),
], ids=["gcnet-all-256", "gcnet-all-384", "gcnet-stem-256", "gcnet-stem-384",
        "psmnet-256", "psmnet-384"])
def test_quant_convs_table(model, scope, dhw, want):
    """The layouts' decisions at the card's shapes: 2/3 int8 convs for
    MS-GCNet "all" (block_3d_2's input 48x96x312 = 1,437,696 voxels passes
    the gate at 375x1242), 1/1 for "stem", 6/9 for MS-PSMNet (the
    hourglass conv3 inputs 48x64x128 = 393,216 voxels do not at
    256x512); every flagged conv is listed."""
    got = _int8(model, scope, dhw)
    flagged = GCNET_ALL if model == "MS-GCNet" else PSMNET_ALL
    if scope == "stem":
        flagged = ["conv3dbn_2"]
    assert sorted(got) == sorted(flagged)
    assert sorted(p for p, v in got.items() if v) == sorted(want)


def test_quant_convs_off_the_packed_layouts():
    """Shapes where the JAX models leave their packed layouts: an odd W
    (MS-GCNet then does not flag conv3dbn_2 at all, and block_3d_1 needs
    the gate), an odd D (MS-GCNet only), H < 4; and the gate on a
    full-layout block entry."""
    odd_w = _int8("MS-GCNet", "all", (16, 16, 33))
    assert "conv3dbn_2" not in odd_w and not any(odd_w.values())
    assert _int8("MS-GCNet", "all", (15, 16, 32)).keys() == set(GCNET_ALL[1:])
    # odd D: not packed, block_3d_1 fails the gate, block_3d_2's input
    # 48x128x256 = 1,572,864 voxels passes it, block_3d_3's does not
    assert _int8("MS-GCNet", "all", (95, 256, 512)) == {
        **{p: False for p in GCNET_ALL[1:]}, "block_3d_2.convbn_3d_1": True}
    # packed, block_3d_2's input 48x64x129 has an odd W
    assert _int8("MS-GCNet", "all", (96, 128, 258)) == {
        **{p: False for p in GCNET_ALL}, "conv3dbn_2": True,
        "block_3d_1.convbn_3d_1": True}
    psm = _int8("MS-PSMNet", "all", (15, 16, 32))    # no D condition
    assert sorted(p for p, v in psm.items() if v) == sorted(
        PSMNET_ALL[:3] + ["dres2.conv1", "dres3.conv1", "dres4.conv1"])
    assert not any(_int8("MS-PSMNet", "all", (16, 2, 32)).values())
    with pytest.raises(ValueError, match="quant_scope"):
        _int8("MS-GCNet", "blocks", (16, 16, 32))


def _jax_calib_keys(model, scope, dhw, stop_at):
    """The keys of the JAX model's calibration at a volume of ``dhw``,
    as the port's dotted paths."""
    cfg = ModelConfig(name=model, max_disp=2 * dhw[0], base_filters=4,
                      compute_dtype="float32")
    sd = build_model(cfg, "cpu", torch.Generator().manual_seed(0)).state_dict()
    v = convert_state_dict(sd, model)
    kw = dict(max_disp=2 * dhw[0], dtype=jnp.float32, quant_eval=True,
              quant_mode="calib")
    if model == "MS-GCNet":
        jm = JaxMSGCNet(num_filters=4, quant_scope=scope, **kw)
    else:
        jm = JaxMSPSMNet(base_filters=4, **kw)
    x = jnp.asarray(np.random.default_rng(0).random((1,) + dhw + (8,)),
                    jnp.float32)
    _, qs = jax.jit(lambda v, x: jm.apply(v, x, train=False, stop_at=stop_at,
                                          mutable=["quant_stats"]))(v, x)
    return sorted(quant_stats_from_jax(qs))


@pytest.mark.parametrize("model,scope,dhw,stop_at", [
    ("MS-GCNet", "all", (16, 16, 32), ""),
    ("MS-GCNet", "stem", (16, 16, 32), ""),
    ("MS-GCNet", "all", (16, 16, 33), "block4"),
    ("MS-PSMNet", "all", (8, 16, 32), ""),
    ("MS-PSMNet", "all", (8, 16, 33), "dres1"),
], ids=["gcnet-all", "gcnet-stem", "gcnet-odd-w", "psmnet",
        "psmnet-odd-w"])
def test_quant_convs_keys_match_jax_calibration(model, scope, dhw, stop_at):
    """The convs quant_convs lists are those whose absmax the JAX model's
    calib forward records, at a packed shape and off it (an odd W: the
    models then fail at their first skip add, so the JAX forward stops at
    the encoder's end, or, for MS-PSMNet, after dres1)."""
    want = _jax_calib_keys(model, scope, dhw, stop_at)
    cfg = ModelConfig(name=model, quant_eval=True, quant_scope=scope)
    got = sorted(quant_convs(model, cfg, dhw))
    if stop_at == "dres1":
        got = [p for p in got if p.startswith(("dres0", "dres1"))]
    assert got == want


# -- the fused kernels' plain versions against the unfused passes ------------

def _unfused(x, wq, sk, bias, stride, pad, scale):
    """The int8 conv as the unfused passes compute it: quantize_activation,
    the channels-last copy, the int32 conv and the dequantization in JAX's
    order, ``(float32(acc) * (sx * sk)).to(dtype) + bias.to(dtype)``."""
    xq, sx = quantize_activation(x, scale)
    acc = int8_conv3d(xq.permute(0, 2, 3, 4, 1).contiguous(), wq, stride, pad)
    c = (1, -1, 1, 1, 1)
    y = (acc.float() * (sx * sk.view(c))).to(x.dtype)
    return xq, y + bias.to(x.dtype).view(c)


def _fused_operands(rng, n, cin, cout, dhw, dtype):
    x = rng.standard_normal((n, cin) + dhw).astype(np.float32) * 4.0
    x[-1] *= 30.0                     # samples of unequal scale
    xt = torch.from_numpy(x).to(dtype)
    wq = torch.from_numpy(rng.integers(-127, 128, (cout, 3, 3, 3, cin),
                                       dtype=np.int8))
    sk = torch.from_numpy(rng.uniform(1e-4, 1e-2, cout).astype(np.float32))
    bias = torch.from_numpy(rng.standard_normal(cout).astype(np.float32))
    return xt, wq, sk, bias


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("scale", ["sample", "scalar"])
@pytest.mark.parametrize("cin", [4, 5, 8, 64])
def test_int8_quantize_plain_version_matches_the_unfused_passes(dtype, scale,
                                                                cin):
    """int8_quantize (its plain version on the CPU) equals
    quantize_activation, moved channels last and zero-padded to 32 or 64
    channels, bit for bit: per-sample (dynamic) and scalar (static)
    scales, values past the calibrated range saturating."""
    rng = np.random.default_rng(cin + (dtype == "float32"))
    tdt = getattr(torch, dtype)
    x, _, _, _ = _fused_operands(rng, 2, cin, 4, (3, 5, 7), tdt)
    s = (activation_scale(x) if scale == "sample" else
         torch.tensor(np.float32(np.abs(x.float().numpy()).max() / 300)))
    got = int8_quantize(x, s)
    want = quantize_activation(x, s)[0].permute(0, 2, 3, 4, 1)
    assert got.dtype == torch.int8 and got.is_contiguous()
    assert got.shape == (2, 3, 5, 7, 64 if cin == 64 else 32)
    assert torch.equal(got[..., :cin], want)
    assert not got[..., cin:].any()
    if scale == "scalar":
        assert int(want.abs().max()) == 127       # saturated
    np.testing.assert_array_equal(int8_quantize_reference(x, s).numpy(),
                                  got.numpy())
    assert int8_quantize.launches == 0            # no kernel on the CPU


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("pad", [(1, 1, 1), (0, 1, 1), (1, 0, 1)])
@pytest.mark.parametrize("cin", [4, 5, 8, 64])
def test_fused_int8_conv_plain_version_matches_the_unfused_passes(
        stride, pad, cin):
    """int8_quantize and int8_conv3d_dequant (their plain versions on the
    CPU) equal the unfused passes bit for bit, in float32 and bfloat16,
    with per-sample and scalar scales, at per-dim padding, odd dims, N = 2
    and output channels that are no multiple of 32."""
    rng = np.random.default_rng(1000 + 10 * cin + stride + 3 * pad[0])
    cout = {4: 12, 5: 8, 8: 40, 64: 64}[cin]
    for dtype in (torch.float32, torch.bfloat16):
        x, wq, sk, bias = _fused_operands(rng, 2, cin, cout, (5, 7, 9), dtype)
        for scale in (None, torch.tensor(np.float32(0.05))):
            want_q, want = _unfused(x, wq, sk, bias, stride, pad, scale)
            sx = activation_scale(x) if scale is None else scale
            xq = int8_quantize(x, sx)
            got = int8_conv3d_dequant(xq, pack_weights(wq), sx, sk, bias,
                                      stride, pad, dtype)
            assert got.dtype == dtype and got.shape == want.shape
            assert torch.equal(xq[..., :cin],
                               want_q.permute(0, 2, 3, 4, 1))
            np.testing.assert_array_equal(got.float().numpy(),
                                          want.float().numpy())
            np.testing.assert_array_equal(
                int8_conv3d_dequant_reference(xq, pack_weights(wq), sx, sk,
                                              bias, stride, pad,
                                              dtype).float().numpy(),
                got.float().numpy())
    assert int8_conv3d.launches == 0


def test_pack_weights_layout():
    """pack_weights: [Cout_pad, 27, Cp], the taps in (kd, kh, kw) order,
    the channels zero-padded to 32, 64 or 128 and the output channels to a
    multiple of 32 (<= 32 of them) or 64."""
    rng = np.random.default_rng(7)
    for cout, cin, shape in ((12, 5, (32, 27, 32)), (40, 8, (64, 27, 32)),
                             (64, 64, (64, 27, 64)), (100, 33, (128, 27, 64)),
                             (40, 65, (64, 27, 128))):
        wq = torch.from_numpy(rng.integers(-127, 128, (cout, 3, 3, 3, cin),
                                           dtype=np.int8))
        wp = pack_weights(wq)
        assert tuple(wp.shape) == shape and wp.is_contiguous()
        assert torch.equal(wp[:cout, :, :cin], wq.reshape(cout, 27, cin))
        assert not wp[cout:].any() and not wp[:, :, cin:].any()


def test_fused_int8_conv_checks_its_inputs():
    x = torch.zeros((1, 4, 4, 4, 32), dtype=torch.int8)
    wp = pack_weights(torch.zeros((8, 3, 3, 3, 32), dtype=torch.int8))
    sx, sk, b = torch.ones(1), torch.ones(8), torch.zeros(8)
    args = (1, (1, 1, 1), torch.float32)
    with pytest.raises(TypeError, match="xq"):
        int8_conv3d_dequant(x.float(), wp, sx, sk, b, *args)
    with pytest.raises(ValueError, match="channels padded"):
        int8_conv3d_dequant(x[..., :8].contiguous(), wp, sx, sk, b, *args)
    with pytest.raises(TypeError, match="sk"):
        int8_conv3d_dequant(x, wp, sx, sk.double(), b, *args)
    with pytest.raises(ValueError, match="sx"):
        int8_conv3d_dequant(x, wp, torch.ones(3), sk, b, *args)
    with pytest.raises(TypeError, match="dtype"):
        int8_conv3d_dequant(x, wp, sx, sk, b, 1, (1, 1, 1), torch.float16)
    with pytest.raises(ValueError, match="at most 128"):
        int8_conv3d(torch.zeros((1, 4, 4, 4, 129), dtype=torch.int8),
                    torch.zeros((8, 3, 3, 3, 129), dtype=torch.int8), 1)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        int8_quantize(torch.zeros((1, 2, 3, 3, 3), dtype=torch.float16),
                      torch.ones(1))
    with pytest.raises(ValueError, match="samples"):
        int8_quantize(torch.zeros((2, 2, 3, 3, 3)), torch.ones(3))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sample_absmax_is_exact(dtype):
    """The one-pass aminmax absmax equals x.float().abs().amax() bit for
    bit: samples dominated by a negative value, by a positive one, an
    all-zero sample (a positive zero) and a sample of negative zeros."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((5, 3, 4, 5, 6)).astype(
        np.float32) * 7.0).to(getattr(torch, dtype))
    x[0, 1, 2, 3, 4] = -1e4
    x[1, 0, 0, 0, 0] = 3e4
    x[2] = 0.0
    x[3] = -0.0
    got = sample_absmax(x)
    want = x.float().abs().amax(dim=(1, 2, 3, 4), keepdim=True)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  want.numpy().view(np.int32))


_abs_max_jit = jax.jit(lambda x: jnp.max(jnp.abs(x.astype(jnp.float32)),
                                         axis=tuple(range(1, x.ndim))))
ABSMAX_CASES = ["negative_extreme", "zero_and_negative_zero", "inf",
                "subnormal", "nan"]


def _absmax_input(case, n, rng):
    """float32 [n, 3, 4, 5, 6] values of ``case``: each sample's extreme
    negative or positive, an all-zero sample beside one of negative zeros,
    +-inf, subnormal samples (one with a normal extreme), a NaN in sample
    0 only."""
    x = rng.standard_normal((n, 3, 4, 5, 6)).astype(np.float32) * 7.0
    if case == "negative_extreme":
        x[0, 1, 2, 3, 4] = -1e4
        x[-1, 0, 0, 0, 0] = -3e4 if n == 1 else 3e4
    elif case == "zero_and_negative_zero":
        x[0] = 0.0
        x[0, :, :2] = -0.0
        x[-1] = -0.0 if n == 2 else x[-1]
    elif case == "inf":
        x[0, 2, 1, 0, 3] = -np.inf
        x[-1, 0, 3, 4, 5] = np.inf
    elif case == "subnormal":
        x *= np.float32(1e-40)
        x[0, 0, 0, 0, 0] = -3e-39
        if n == 2:
            x[1, 2, 2, 2, 2] = -2.5
    elif case == "nan":
        x[0, 1, 1, 1, 1] = np.nan
    return x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [1, 2])
@pytest.mark.parametrize("case", ABSMAX_CASES)
def test_sample_absmax_matches_jax_max_pass(case, n, dtype):
    """sample_absmax (the int8_absmax wrapper, its plain version on the
    CPU) against the max pass of JAX's _quant_act, jnp.max(jnp.abs(xf))
    over every axis but the batch, on float32 and bfloat16 inputs (JAX is
    given their float32 values): bit for bit, NaNs by position. XLA:CPU
    flushes subnormals to zero, so a sample whose max is subnormal reads 0
    there; the port keeps the exact subnormal (numpy's max) as the card's
    kernel does. The dynamic scale, max(amax, 1e-12) / 127, equals
    _quant_act's bit for bit in every case."""
    rng = np.random.default_rng(ABSMAX_CASES.index(case) + 10 * n)
    x = torch.from_numpy(_absmax_input(case, n, rng)).to(getattr(torch, dtype))
    xf = x.float().numpy()
    got = sample_absmax(x)
    assert got.dtype == torch.float32 and got.shape == (n, 1, 1, 1, 1)
    got = got.reshape(n).numpy()
    jax_max = np.asarray(_abs_max_jit(xf))
    exact = np.abs(xf).reshape(n, -1).max(axis=1)
    nan = np.isnan(got)
    np.testing.assert_array_equal(nan, np.isnan(jax_max))
    np.testing.assert_array_equal(nan, np.isnan(exact))
    assert nan.any() == (case == "nan")
    sub = ~nan & (got != 0) & (got < np.finfo(np.float32).tiny)
    assert sub.any() == (case == "subnormal")
    assert (jax_max[sub] == 0).all()
    keep = ~nan & ~sub
    np.testing.assert_array_equal(got[keep].view(np.int32),
                                  jax_max[keep].view(np.int32))
    np.testing.assert_array_equal(got[~nan].view(np.int32),
                                  exact[~nan].view(np.int32))
    scale = activation_scale(x).reshape(n).numpy()
    want = np.asarray(_quant_act_jit(xf)[1]).reshape(n)
    np.testing.assert_array_equal(np.isnan(scale), nan)
    np.testing.assert_array_equal(scale[~nan].view(np.int32),
                                  want[~nan].view(np.int32))
    assert int8_absmax.launches == 0              # no kernel on the CPU


BAD_ABSMAX_INPUTS = {
    "float16": (lambda: torch.ones((2, 3, 4), dtype=torch.float16),
                TypeError),
    "empty": (lambda: torch.ones((2, 0, 4)), ValueError),
    "zero_samples": (lambda: torch.ones((0, 3)), ValueError),
    "scalar": (lambda: torch.tensor(1.0), ValueError),
    "non_contiguous": (lambda: torch.ones((4, 3, 5)).transpose(1, 2),
                       ValueError),
    "meta_device": (lambda: torch.ones((2, 3), device="meta"), ValueError),
}


@pytest.mark.parametrize("bad", list(BAD_ABSMAX_INPUTS))
def test_int8_absmax_checks_its_input(bad):
    """The wrapper refuses float16, an empty input, a non-contiguous one
    and a device that is neither the CPU nor CUDA; int8_quantize refuses a
    scale on another device than x. Nothing launches."""
    make, err = BAD_ABSMAX_INPUTS[bad]
    with pytest.raises(err, match="int8_absmax"):
        int8_absmax(make())
    with pytest.raises(ValueError, match="int8_quantize: x on cpu"):
        int8_quantize(torch.ones((1, 2, 3, 3, 3)),
                      torch.ones(1, device="meta"))
    assert int8_absmax.launches == 0 and int8_quantize.launches == 0


# -- packed_eval_outer ---------------------------------------------------------

def _jax_int8_and_calib_keys(outer, dhw, stop_at):
    """JAX's MS-PSMNet at ``packed_eval_outer=outer``, traced (no compute)
    at a volume of ``dhw``: the paths of the convs whose dynamic eval calls
    ``_quant_act`` (the convs that run int8), and the keys of its "calib"
    forward's quant_stats."""
    import msnets_tpu.models.layers as jl
    from flax import linen as fnn
    kw = dict(max_disp=2 * dhw[0], base_filters=4, dtype=jnp.float32,
              quant_eval=True, packed_eval_outer=outer)
    x = jax.ShapeDtypeStruct((1,) + dhw + (8,), jnp.float32)
    v = jax.eval_shape(JaxMSPSMNet(**kw).init, jax.random.PRNGKey(0), x)
    stack, int8 = [], set()

    def capture(next_fun, args, kwargs, ctx):
        if isinstance(ctx.module, jl.ConvBN3D) and ctx.method_name == "__call__":
            stack.append(".".join(ctx.module.scope.path))
            try:
                return next_fun(*args, **kwargs)
            finally:
                stack.pop()
        return next_fun(*args, **kwargs)

    quant_act = jl._quant_act

    def recording(x, scale=None):
        int8.add(stack[-1])
        return quant_act(x, scale)

    jl._quant_act = recording
    try:
        with fnn.intercept_methods(capture):
            jax.eval_shape(lambda v, x: JaxMSPSMNet(**kw).apply(
                v, x, train=False, stop_at=stop_at), v, x)
    finally:
        jl._quant_act = quant_act
    _, qs = jax.eval_shape(lambda v, x: JaxMSPSMNet(
        **dict(kw, quant_mode="calib")).apply(
            v, x, train=False, stop_at=stop_at, mutable=["quant_stats"]),
        v, x)
    keys = sorted(".".join(k.key for k in path[:-1]) for path, _ in
                  jax.tree_util.tree_flatten_with_path(qs["quant_stats"])[0])
    return sorted(int8), keys


@pytest.mark.parametrize("outer", [True, False], ids=["packed", "full"])
@pytest.mark.parametrize("dhw", [(8, 16, 32), (64, 128, 128)],
                         ids=["under_gate", "over_gate"])
def test_psmnet_packed_eval_outer_matches_jax(outer, dhw):
    """MS-PSMNet's quant_convs at packed_eval_outer True and False against
    JAX's own model, traced: the keys of its calibration and the convs
    that call _quant_act. Under the stride-2 gate (8x16x32) the full-layout
    dres3.conv1 and dres4.conv1 of packed_eval_outer=False compute in
    float; over it (64x128x128 = 1,048,576 voxels, even) they run int8
    either way; dres2.conv1 reads the packed volume in both."""
    int8, keys = _jax_int8_and_calib_keys(outer, dhw, "hg3")
    cfg = ModelConfig(name="MS-PSMNet", quant_eval=True,
                      packed_eval_outer=outer)
    got = quant_convs("MS-PSMNet", cfg, dhw)
    assert sorted(got) == keys == sorted(PSMNET_ALL)
    assert sorted(p for p, v in got.items() if v) == int8
    moved = {"dres3.conv1", "dres4.conv1"}
    assert moved <= set(int8) if outer or dhw[0] == 64 else not (
        moved & set(int8))
    assert "dres2.conv1" in int8


def test_psmnet_float_output_does_not_depend_on_packed_eval_outer():
    """Without quant_eval the flag moves only the JAX model's layouts: the
    port's MS-PSMNet gives the same output either way, and its int8 model
    quantizes dres3.conv1 only where quant_convs says."""
    rng = np.random.default_rng(9)
    cv = torch.from_numpy(rng.random((1, 8, 8, 16, 32), dtype=np.float32))
    outs = []
    for outer in (True, False):
        cfg = ModelConfig(name="MS-PSMNet", max_disp=16, base_filters=4,
                          compute_dtype="float32", packed_eval_outer=outer)
        m = build_model(cfg, "cpu", torch.Generator().manual_seed(0))
        with torch.no_grad():
            outs.append(m(cv))
    assert torch.equal(outs[0], outs[1])
    for outer in (True, False):
        cfg = ModelConfig(name="MS-PSMNet", max_disp=16, base_filters=4,
                          compute_dtype="float32", quant_eval=True,
                          packed_eval_outer=outer)
        m = build_model(cfg, "cpu")
        kinds = {name: c.quant.kind for name, c in m.named_modules()
                 if getattr(c, "quant", None) is not None}
        assert kinds["dres2.conv1.0"] == "entry"
        assert kinds["dres3.conv1.0"] == ("entry" if outer else "gate")
        assert kinds["dres4.conv1.0"] == ("entry" if outer else "gate")
