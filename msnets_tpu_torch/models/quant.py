"""int8 eval of the stem and encoder convs (counterpart of the JAX package's
``quant_eval``: ``msnets_tpu/models/layers.py:_quant_act``,
``_quant_kernels`` and the quant modes of its ``ConvBN3D``).

A quantized conv computes, in eval mode with the BatchNorm folded into its
float32 kernel ``kf`` and bias ``b``::

    xq, sx = quantize_activation(x)       # int8, per-sample float32 scale
    kq, sk = quantize_kernel(kf)          # int8, per-output-channel scale
    acc = int8 conv3d(xq, kq)             # exact int32 sums
    y = (float32(acc) * (sx * sk)).to(dtype) + b.to(dtype)

in that order, as the JAX lowerings do. It runs as kernels on the card:
``ops/cuda/int8_quantize.py`` writes ``xq`` channels last, and
``ops/cuda/int8_conv3d.py``'s ``int8_conv3d_dequant`` sums on the int8
tensor cores and writes ``y``; the dynamic scale's max-abs pass is a third
kernel (``int8_absmax``, beside the quantize). On the CPU the kernels take
their plain versions.

**Which convs run int8.** The JAX models flag some convs ``quant`` and a
flagged conv runs int8 only in its TPU layouts: (a) a stride-1 conv that
reads or writes the packed H,W space-to-depth layout, (b) a stride-2 conv
that reads the packed "std" layout, (c) a full-layout stride-2 conv whose
input passes ``conv3d_ndhwc``'s space-to-depth gate (D, H and W even and
D*H*W >= 1,000,000). Any other flagged conv computes as an unflagged one.
The port runs none of those layouts, so each flagged conv carries a
``QuantSite`` that reproduces the decision from the global shape of its
input, and ``coverage`` gives the whole model's decisions from the
volume's shape alone. Each model lists its flagged convs
(``MSGCNet.quant_sites``, ``MSPSMNet.quant_sites``) with the facts the rule
needs: whether the model packs only on an even D, and whether it flags the
conv only when it packs.

The paths are the JAX ``quant_stats`` collection's, joined with dots.

**Modes** (``ModelConfig.quant_mode``): ``dynamic`` takes each sample's
scale from a max-abs pass over the conv's input; ``static`` takes the
scalar ``act_amax / 127`` of a calibration; ``calib`` computes the
ordinary folded conv in the compute dtype and records ``max(act_amax,
max|x|)`` of every flagged conv's input as it arrives. Train mode never
quantizes. A division by a constant is a multiply by its float32
reciprocal (``_div_const``), as XLA compiles it: the tests hold both scales
to JAX's bit for bit, and a true division by 127 differs in the last bit.

On a ``parallel.Sharded`` volume the scale is the global one (an
``all_reduce_max`` over the ranks that split the sample), the coverage
reads the global shape, and the int conv runs on ``halo.py``'s windows.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Mapping, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.cuda.int8_conv3d import int8_conv3d_dequant, pack_weights
from ..ops.cuda.int8_quantize import (int8_absmax, int8_absmax_reference,
                                      int8_quantize, quantize_values)
from ..ops.matchers import _div_const
from ..parallel import halo
from ..parallel import mesh as pm

QUANT_MODES = ("dynamic", "static", "calib")
QUANT_SCOPES = ("all", "stem")
# conv3d_ndhwc's space-to-depth gate (msnets_tpu/models/layers.py:86)
S2D_MIN_VOXELS = 1_000_000
_EPS = 1e-12


def sample_absmax(x: torch.Tensor) -> torch.Tensor:
    """Each sample's max-abs in float32, shape ``[N, 1, ...]``, equal to
    ``x.float().abs().amax(every dim but the first)`` bit for bit: the
    ``int8_absmax`` kernel on a CUDA tensor, ``sample_absmax_reference`` on
    a CPU one."""
    amax = int8_absmax(x.contiguous())
    return amax.view((-1,) + (1,) * (x.dim() - 1))


def sample_absmax_reference(x: torch.Tensor) -> torch.Tensor:
    """The plain version of ``sample_absmax``: one ``aminmax`` pass
    (``int8_absmax_reference``)."""
    amax = int8_absmax_reference(x.contiguous())
    return amax.view((-1,) + (1,) * (x.dim() - 1))


def activation_scale(x: torch.Tensor, group=None) -> torch.Tensor:
    """The dynamic scale of ``x``: each sample's ``max(amax over every dim
    but the first, 1e-12) / 127`` in float32, shape ``[N, 1, ...]``, its
    amax (``sample_absmax``) taken over ``group`` too when the sample is
    split over ranks."""
    amax = sample_absmax(x)
    pm.all_reduce_max(amax, group)
    return _div_const(amax.clamp_min(_EPS), 127.0)


def quantize_activation(x: torch.Tensor, scale: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 quantization of an activation (JAX ``_quant_act``):
    ``(round(x / scale) clipped to +-127 as int8, scale)`` in float32.
    ``scale=None`` is the dynamic mode (``activation_scale``)."""
    if scale is None:
        scale = activation_scale(x)
    return quantize_values(x, scale), scale


def quantize_kernel(kf: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel int8 quantization of a float32 conv kernel
    ``[Cout, Cin, 3, 3, 3]`` (JAX ``_quant_kernels``): one scale over all
    27 taps of each output channel, ``max(amax, 1e-12) / 127``. Returns
    ``(int8 kernel, scale [Cout] float32)``."""
    kf = kf.float()
    amax = kf.abs().amax(dim=tuple(range(1, kf.dim())))
    sk = _div_const(amax.clamp_min(_EPS), 127.0)
    kq = torch.round(kf / sk.view((-1,) + (1,) * (kf.dim() - 1)))
    return kq.clamp_(-127, 127).to(torch.int8), sk


# -- coverage ---------------------------------------------------------------

def packed(dhw: Sequence[int], even_d: bool) -> bool:
    """Whether a JAX model's eval runs its packed H,W layouts on a volume
    of ``(D, H, W)``: H and W even and >= 4, and D even where the model
    needs it (``gcnet.py``'s and ``psmnet.py``'s ``use_packed``)."""
    d, h, w = dhw
    hw = h % 2 == 0 and w % 2 == 0 and h >= 4 and w >= 4
    return hw and (d % 2 == 0 or not even_d)


def s2d_gate(dhw: Sequence[int]) -> bool:
    """``conv3d_ndhwc``'s space-to-depth gate on a stride-2 conv's input."""
    return all(n % 2 == 0 for n in dhw) and math.prod(dhw) >= S2D_MIN_VOXELS


@dataclasses.dataclass(frozen=True)
class QuantSite:
    """A conv the JAX model flags ``quant``. ``path``: its ``quant_stats``
    path; ``kind``: "packed" (int8 in the packed stride-1 layouts),
    "entry" (a stride-2 conv that reads the packed layout when the model
    packs, else the gate decides) or "gate" (a full-layout stride-2 conv);
    ``halvings``: the stride-2 convs between the volume and its input;
    ``even_d``: the model packs only on an even D; ``packed_only``: the
    model flags it only on its packed branch. The model's ``quant_sites``
    gives them."""
    path: str
    kind: str
    halvings: int = 0
    even_d: bool = False
    packed_only: bool = False

    def flagged(self, dhw: Sequence[int]) -> bool:
        """Whether the JAX model flags the conv at an input of ``dhw``."""
        return not self.packed_only or packed(dhw, self.even_d)

    def runs_int8(self, dhw: Sequence[int]) -> bool:
        if self.kind == "packed":
            return packed(dhw, self.even_d)
        if self.kind == "entry":
            return packed(dhw, self.even_d) or s2d_gate(dhw)
        return s2d_gate(dhw)


def _halve(dhw: Sequence[int], times: int) -> Tuple[int, ...]:
    for _ in range(times):                    # k3, stride 2, padding 1
        dhw = tuple((n - 1) // 2 + 1 for n in dhw)
    return tuple(dhw)


def coverage(sites: Sequence[QuantSite], volume_shape: Sequence[int]
             ) -> Dict[str, bool]:
    """For each of ``sites`` that the model flags at a volume of
    ``volume_shape`` (``[N, C, D, H, W]``, or its last three dims), whether
    it runs int8: ``{quant_stats path: bool}``."""
    dhw = tuple(volume_shape[-3:])
    out = {}
    for site in sites:
        shape = _halve(dhw, site.halvings)
        if site.flagged(shape):
            out[site.path] = site.runs_int8(shape)
    return out


# -- the eval conv ----------------------------------------------------------

def _sample_group(x: "pm.Sharded"):
    """The ranks that split each sample of ``x`` (not the data axis)."""
    return x.mesh.group_over(tuple(a for a in x.spec
                                   if a is not None and a != "data"))


class QuantConv3d(nn.Module):
    """The eval conv of a ``quant``-flagged ``ConvBN3D``: k3, padding 1,
    the BatchNorm folded into the float32 ``weight`` and ``bias`` (kept
    float32 when the model is cast to bfloat16: the quantizer re-scales
    from float32, as in JAX). ``mode`` is one of ``QUANT_MODES``;
    ``act_amax`` (not in the state_dict: the JAX checkpoints never hold
    it) is the calibrated absmax of the input. Where the site does not run
    int8 the conv is the ordinary folded conv in the input's dtype."""

    def __init__(self, weight: torch.Tensor, bias: torch.Tensor, stride: int,
                 site: QuantSite, mode: str):
        super().__init__()
        if mode not in QUANT_MODES:
            raise ValueError(f"quant_mode={mode!r}, expected one of "
                             f"{QUANT_MODES}")
        self.register_buffer("weight", weight.detach().float().clone())
        self.register_buffer("bias", bias.detach().float().clone())
        self.register_buffer("act_amax", torch.zeros((), device=weight.device),
                             persistent=False)
        self.stride, self.site, self.mode = stride, site, mode
        self._kernel: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
        self._host_amax: Optional[float] = 0.0   # act_amax on the host
        self.recorded = False     # recorded since set_quant_mode("calib")

    def extra_repr(self) -> str:
        return (f"{self.weight.shape[1]}, {self.weight.shape[0]}, "
                f"stride={self.stride}, site={self.site.path!r}, "
                f"mode={self.mode!r}")

    def quantized_kernel(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """``quantize_kernel(weight)`` in the int8 conv kernel's layout
        (``pack_weights`` of the channels-last ``[Cout, 3, 3, 3, Cin]``),
        and the scale; made once."""
        if self._kernel is None or self._kernel[0].device != self.weight.device:
            kq, sk = quantize_kernel(self.weight)
            self._kernel = pack_weights(kq.permute(0, 2, 3, 4, 1)), sk
        return self._kernel

    def _plain(self, x):
        return F.conv3d(x, self.weight.to(x.dtype), self.bias.to(x.dtype),
                        self.stride, 1)

    def set_amax(self, value: float) -> None:
        with torch.no_grad():
            self.act_amax.fill_(float(value))
        self._host_amax = float(value)

    def _scale(self) -> torch.Tensor:
        """The static scale ``act_amax / 127`` (act_amax read back once
        after each calibration, not on every forward)."""
        if self._host_amax is None:
            self._host_amax = float(self.act_amax)
        if not self._host_amax > 0:
            raise ValueError(
                f"static int8: layer {self.site.path} has no calibrated "
                "absmax (act_amax 0); calibrate on a representative frame "
                "or use quant_mode 'dynamic'")
        return _div_const(self.act_amax, 127.0)

    def forward(self, x):
        sharded = isinstance(x, pm.Sharded)
        dhw = tuple(x.shape[2:])
        if self.mode == "calib":
            if self.site.flagged(dhw):
                t = x.local if sharded else x
                amax = sample_absmax(t.detach()).amax().reshape(1)
                if sharded:
                    pm.all_reduce_max(amax, x.group)
                self.act_amax.copy_(torch.maximum(self.act_amax, amax[0]))
                self._host_amax = None
                self.recorded = True
            return self._plain(x)
        if not self.site.runs_int8(dhw):
            return self._plain(x)
        wp, sk = self.quantized_kernel()
        if self.mode == "static":
            scale = self._scale()
        elif sharded:
            scale = activation_scale(x.local, _sample_group(x))
        else:
            scale = activation_scale(x)
        if not sharded:
            return int8_conv3d_dequant(int8_quantize(x, scale), wp, scale, sk,
                                       self.bias, self.stride, (1, 1, 1),
                                       x.dtype)
        t, _, pad, out_shape, rec = halo.conv3d_input(
            x, self.weight.shape[0], self.stride)
        y = int8_conv3d_dequant(int8_quantize(t, scale), wp, scale, sk,
                                self.bias, self.stride, pad, x.dtype)
        rec["int8"] = self.site.path
        return halo.finish(y, out_shape, x, rec)


# -- the model's quantized convs ---------------------------------------------

def quant_modules(model: nn.Module) -> Dict[str, QuantConv3d]:
    """``{quant_stats path: QuantConv3d}`` of a folded model."""
    return {m.site.path: m for m in model.modules()
            if isinstance(m, QuantConv3d)}


def set_quant_mode(model: nn.Module, mode: str) -> None:
    if mode not in QUANT_MODES:
        raise ValueError(f"quant_mode={mode!r}, expected one of {QUANT_MODES}")
    for m in quant_modules(model).values():
        m.mode = mode
        m.recorded = False


def quant_stats(model: nn.Module, recorded: bool = False
                ) -> Dict[str, float]:
    """The calibrated absmax of each quantized conv, by path; with
    ``recorded`` only those that recorded an input since the model was set
    to "calib" (the convs the JAX model flags at the shapes it saw)."""
    return {p: float(m.act_amax) for p, m in quant_modules(model).items()
            if m.recorded or not recorded}


def load_quant_stats(model: nn.Module, stats: Mapping[str, float]) -> None:
    """Set each quantized conv's absmax from ``stats`` (by path; a path the
    model does not have raises ``KeyError``); the others keep theirs."""
    mods = quant_modules(model)
    unknown = sorted(set(stats) - set(mods))
    if unknown:
        raise KeyError(f"quant_stats for layers the model does not quantize: "
                       f"{unknown}; it has {sorted(mods)}")
    for p, v in stats.items():
        mods[p].set_amax(v)
