"""The control of the cells' comparison: the reference with every
convolution, of any rank, transposed or not, computed in fp8, the precision
next below the bfloat16 the configurations state. Each convolution's input
and weight are rounded to float8 e4m3 and the gradient reaching them to
float8 e5m2, each with one scale per tensor (its max-abs at the format's
largest value), as fp8 training recipes do; the arithmetic in between
stays float32.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.nn.modules.conv import _ConvNd

_E4M3_MAX, _E5M2_MAX = 448.0, 57344.0


def _round(x: torch.Tensor, dtype, top: float) -> torch.Tensor:
    s = x.detach().abs().amax().clamp(min=1e-30) / top
    return (x / s).to(dtype).to(x.dtype) * s


class _FP8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _round(x, torch.float8_e4m3fn, _E4M3_MAX)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2, _E5M2_MAX)


def _fp8_forward(mod: _ConvNd):
    rank = mod.weight.dim() - 2
    if mod.transposed:
        conv = getattr(F, f"conv_transpose{rank}d")

        def forward(x):
            return conv(_FP8.apply(x), _FP8.apply(mod.weight), mod.bias,
                        mod.stride, mod.padding, mod.output_padding,
                        mod.groups, mod.dilation)
    else:
        conv = getattr(F, f"conv{rank}d")

        def forward(x):
            return conv(_FP8.apply(x), _FP8.apply(mod.weight), mod.bias,
                        mod.stride, mod.padding, mod.dilation, mod.groups)
    return forward


def fp8_convs(model: nn.Module) -> None:
    """Make every convolution of ``model`` compute in fp8 (in place)."""
    for m in model.modules():
        if isinstance(m, _ConvNd):
            if isinstance(m.padding, str) or m.padding_mode != "zeros":
                raise NotImplementedError(f"fp8 control of {m}")
            m.forward = _fp8_forward(m)
