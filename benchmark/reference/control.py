"""The control of the train cells' comparison: the reference with every
3-D convolution computed in fp8, the precision next below the bfloat16 the
configurations state. Each convolution's input and weight are rounded to
float8 e4m3 and the gradient reaching them to float8 e5m2, each with one
scale per tensor (its max-abs at the format's largest value), as fp8
training recipes do; the arithmetic in between stays float32.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

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


def _fp8_forward(mod: nn.Module):
    def forward(x):
        x, w = _FP8.apply(x), _FP8.apply(mod.weight)
        if isinstance(mod, nn.ConvTranspose3d):
            return F.conv_transpose3d(x, w, mod.bias, mod.stride, mod.padding,
                                      mod.output_padding)
        return F.conv3d(x, w, mod.bias, mod.stride, mod.padding)
    return forward


def fp8_convs(model: nn.Module) -> None:
    """Make every Conv3d and ConvTranspose3d of ``model`` compute in fp8
    (in place)."""
    for m in model.modules():
        if isinstance(m, (nn.Conv3d, nn.ConvTranspose3d)):
            m.forward = _fp8_forward(m)
