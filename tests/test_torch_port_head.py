"""MS-GCNet's served head (``ops/cuda/subpixel_soft_argmin.py``) on the CPU:
its plain version against deconv5 as a conv plus ``soft_argmin``
(``layers.conv_head``, the path training keeps), the wrapper's checks, and
which path ``MSGCNet.forward`` takes: the fused head in eval mode without
gradients at a width the kernel takes, the conv head in train mode, with
gradients, over a mesh or at another width.
The kernel itself runs on the card (``tests/test_torch_port_cuda.py``)."""
import json

import numpy as np
import pytest
import torch

from msnets_tpu_torch import Config, ModelConfig, StereoServer
from msnets_tpu_torch.models import MSGCNet
from msnets_tpu_torch.models import gcnet as G
from msnets_tpu_torch.models.layers import conv_head, one_channel_conv
from msnets_tpu_torch.ops.cuda.subpixel_soft_argmin import (
    MAX_CHANNELS, fits, phase_taps, subpixel_soft_argmin,
    subpixel_soft_argmin_reference)
from msnets_tpu_torch.utils import profiling as P

NDHWC = torch.channels_last_3d
F_ = 8


def _head_inputs(n, d, h, w, stride, peak, seed=0):
    """x NDHWC [n, 8, d, h, w] and deconv5's kernel, scaled so that the
    largest |logit| is ``peak``."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((n, F_, d, h, w), generator=g).to(memory_format=NDHWC)
    k = torch.randn((F_, 1, 3, 3, 3), generator=g)
    top = one_channel_conv(x, k, stride, stride - 1).abs().max()
    return x, k * (peak / top)


@pytest.mark.parametrize("peak", [4.0, 80.0])
@pytest.mark.parametrize("n", [1, 2])
@pytest.mark.parametrize("dhw", [(16, 8, 16), (15, 7, 13), (8, 6, 9),
                                 (7, 5, 12)],
                         ids=["even", "odd", "oddW", "oddDH"])
@pytest.mark.parametrize("stride", [2, 4])
def test_reference_matches_the_conv_head(stride, dhw, n, peak):
    """Within float32 reassociation (1e-4 px); logits up to +-80 exercise
    the max-subtracted softmax."""
    d, h, w = dhw
    d = d if stride == 2 else (d + 1) // 2       # max_disp <= 32
    x, k = _head_inputs(n, d, h, w, stride, peak)
    want = conv_head(x, k, stride, stride * d)
    got = subpixel_soft_argmin_reference(x, k, stride)
    assert got.dtype == torch.float32
    assert got.shape == want.shape == (n, stride * h, stride * w)
    assert (got - want).abs().max().item() <= 1e-4
    # the wrapper on CPU tensors is the plain version, bit for bit
    assert torch.equal(subpixel_soft_argmin(x, k, stride, stride * d), got)


def test_reference_in_float64_keeps_float64():
    x, k = _head_inputs(1, 8, 5, 6, 2, 10.0)
    got = subpixel_soft_argmin_reference(x.double(), k.double(), 2)
    logits = torch.nn.functional.conv_transpose3d(
        x.double(), k.double(), None, 2, 1, 1).squeeze(1)
    d = torch.arange(16, dtype=torch.float64).view(1, -1, 1, 1)
    want = (torch.softmax(logits, 1) * d).sum(1)
    assert got.dtype == torch.float64
    assert (got - want).abs().max().item() <= 1e-10


def test_bfloat16_input_is_widened_exactly():
    x, k = _head_inputs(1, 8, 5, 6, 2, 10.0)
    xb = x.to(torch.bfloat16)
    assert torch.equal(subpixel_soft_argmin(xb, k, 2, 16),
                       subpixel_soft_argmin(xb.float(), k, 2, 16))


@pytest.mark.parametrize("stride", [2, 4])
def test_phase_taps_are_the_transposed_conv(stride):
    """Output o = s*i + k - 1 takes tap k of input i: with o = s*m + r and
    i = m + off, r = s*off + k - 1; every tap lands on one phase, and with
    s = 4 phase 2 takes none."""
    taps = phase_taps(stride)
    assert sorted(k for t in taps for k, _ in t) == [0, 1, 2]
    for r, t in enumerate(taps):
        for k, off in t:
            assert r == stride * off + k - 1 and off in (0, 1)
    assert [r for r, t in enumerate(taps) if not t] == (
        [2] if stride == 4 else [])


def _bad(**kw):
    x, k = _head_inputs(1, 8, 4, 4, 2, 4.0)
    args = dict(x=x, weight=k, stride=2, max_disp=16)
    args.update(kw)
    return args


@pytest.mark.parametrize("case,exc", [
    ("ncdhw", ValueError), ("float16", TypeError), ("float64", TypeError),
    ("weight_bf16", TypeError), ("stride3", ValueError),
    ("max_disp", ValueError), ("weight_shape", ValueError),
    ("four_dims", ValueError)])
def test_wrapper_rejects_what_it_does_not_take(case, exc):
    args = _bad()
    x, k = args["x"], args["weight"]
    args.update({
        "ncdhw": dict(x=x.contiguous()),
        "float16": dict(x=x.half()),
        "float64": dict(x=x.double()),
        "weight_bf16": dict(weight=k.bfloat16()),
        "stride3": dict(stride=3, max_disp=24),
        "max_disp": dict(max_disp=32),
        "weight_shape": dict(weight=k[:4]),
        "four_dims": dict(x=x[0]),
    }[case])
    with pytest.raises(exc):
        subpixel_soft_argmin(**args)


class _Calls:
    """Counts the calls of the two head paths of ``models/gcnet.py``."""

    def __init__(self, monkeypatch):
        self.fused = self.conv = 0
        fused, conv = G.subpixel_soft_argmin, G.conv_head

        def count_fused(*a, **k):
            self.fused += 1
            return fused(*a, **k)

        def count_conv(*a, **k):
            self.conv += 1
            return conv(*a, **k)
        monkeypatch.setattr(G, "subpixel_soft_argmin", count_fused)
        monkeypatch.setattr(G, "conv_head", count_conv)

    def __call__(self):
        return self.fused, self.conv


def _model(quarter=False, width=4, dtype=torch.float32):
    return MSGCNet(64 if quarter else 32, 8, width,
                   generator=torch.Generator().manual_seed(5),
                   compute_dtype=dtype, quarter_input=quarter)


@pytest.mark.parametrize("quarter", [False, True])
@pytest.mark.parametrize("mode", ["no_grad", "inference_mode", "grad",
                                  "train"])
def test_forward_takes_the_fused_head_only_when_served(monkeypatch, mode,
                                                       quarter):
    calls = _Calls(monkeypatch)
    m = _model(quarter)
    cv = torch.randn(2, 8, 16, 16, 32,
                     generator=torch.Generator().manual_seed(1))
    m.train(mode == "train")
    ctx = {"no_grad": torch.no_grad, "inference_mode": torch.inference_mode,
           "grad": torch.enable_grad, "train": torch.enable_grad}[mode]
    with ctx():
        out = m(cv)
    fused = mode in ("no_grad", "inference_mode")
    assert calls() == ((1, 0) if fused else (0, 1))
    s = 4 if quarter else 2
    assert out.shape == (2, 16 * s, 32 * s)
    assert out.requires_grad == (not fused)


def test_eval_heads_agree():
    """The fused head (no gradients) and the conv head (gradients on) of
    one eval model give the same disparity up to float32 reassociation."""
    m = _model().eval()
    cv = torch.randn(2, 8, 16, 16, 32,
                     generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        fused = m(cv)
    conv = m(cv).detach()
    assert (fused - conv).abs().max().item() <= 1e-4


def test_served_request_takes_the_fused_head_under_its_span(monkeypatch,
                                                            tmp_path):
    calls = _Calls(monkeypatch)
    cfg = Config(model=ModelConfig(max_disp=32, base_filters=4,
                                   compute_dtype="float32"))
    srv = StereoServer(cfg, _model().state_dict(), device="cpu")
    r = np.random.default_rng(0)
    pair = [r.integers(0, 256, (60, 120), dtype=np.uint8) for _ in range(2)]
    with P.trace(str(tmp_path)):
        srv.predict(*pair)
    assert calls() == (1, 0)
    names = [e["name"] for e in json.loads(
        (tmp_path / "trace.json").read_text())["traceEvents"]
        if e.get("cat") == "user_annotation"]
    assert names.count("msn.regularizer.head") == 1


@pytest.mark.parametrize("channels,dtype,takes", [
    (8, torch.bfloat16, True), (4, torch.bfloat16, False),
    (12, torch.bfloat16, False), (4, torch.float32, True),
    (6, torch.float32, False), (MAX_CHANNELS, torch.float32, True),
    (MAX_CHANNELS + 8, torch.bfloat16, False), (8, torch.float64, False)])
def test_fits_is_the_kernels_plan(channels, dtype, takes):
    """Whole 16-byte copies of the dtype's channels, at most MAX_CHANNELS,
    bfloat16 or float32."""
    assert fits(torch.empty((1, channels, 2, 2, 2), dtype=dtype)) == takes


@pytest.mark.parametrize("width,dtype,fused", [
    (8, torch.bfloat16, True), (4, torch.bfloat16, False),
    (6, torch.float32, False)])
def test_forward_takes_the_conv_head_at_a_width_the_kernel_refuses(
        monkeypatch, width, dtype, fused):
    """Served at a width outside the kernel's plan the model keeps the conv
    head rather than failing on the card, and both heads agree."""
    calls = _Calls(monkeypatch)
    m = _model(width=width, dtype=dtype).eval()
    cv = torch.randn(1, 8, 16, 16, 32,
                     generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        out = m(cv)
    assert calls() == ((1, 0) if fused else (0, 1))
    assert out.shape == (1, 32, 64) and out.dtype == torch.float32
    conv = m(cv).detach()                            # gradients on: the conv
    assert (out - conv).abs().max().item() <= 1e-4
