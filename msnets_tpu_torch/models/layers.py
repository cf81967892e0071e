"""3-D CNN building blocks in NCDHW (counterpart of
``msnets_tpu/models/layers.py``).

The port carries the JAX layers' math, not their TPU layouts: the packed
space-to-depth convolutions, ``PackedPhaseBN``, the pz-slab head, the W-fold
and the int8 paths exist there only for the TPU matrix unit's lane layout.
Here a conv is ``nn.Conv3d(k3, p1)``, a deconv
``nn.ConvTranspose3d(k3, s2, p1, output_padding=1)`` and BN
``nn.BatchNorm3d(eps=1e-5, momentum=0.1)``, with the reference checkpoint's
module names (a ConvBN3D is ``Sequential(conv, bn)``, keys ``.0.weight``,
``.1.running_var``).

Eval folds BN into the preceding conv or deconv (``fold_batchnorm``), in
float32, as the JAX eval path does: y = conv(x, k*a) + (beta - mu*a) with
a = gamma * rsqrt(var + eps).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F


def he_normal_(weight: torch.Tensor, out_channels: int,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """N(0, sqrt(2/n)) with n = k^3 * out_channels (reference net_init)."""
    n = math.prod(weight.shape[2:]) * out_channels
    with torch.no_grad():
        return weight.normal_(0.0, math.sqrt(2.0 / n), generator=generator)


def _bn(cout: int) -> nn.BatchNorm3d:
    return nn.BatchNorm3d(cout, eps=1e-5, momentum=0.1)


class ConvBN3D(nn.Sequential):
    """conv3d (k3, p1, no bias) + BatchNorm (reference convbn_3d)."""

    def __init__(self, cin: int, cout: int, stride: int = 1):
        super().__init__(nn.Conv3d(cin, cout, 3, stride=stride, padding=1,
                                   bias=False), _bn(cout))

    def folded(self) -> nn.Conv3d:
        """Eval conv with the BN affine folded into kernel and bias (f32)."""
        conv, bn = self[0], self[1]
        a, b = _bn_affine(bn)
        out = nn.Conv3d(conv.in_channels, conv.out_channels, 3,
                        stride=conv.stride, padding=1, bias=True,
                        device=conv.weight.device)
        with torch.no_grad():
            out.weight.copy_(conv.weight.float() * a.view(-1, 1, 1, 1, 1))
            out.bias.copy_(b)
        return out


class DeconvBN3D(nn.Sequential):
    """ConvTranspose3d(k3, s2, p1, output_padding 1, no bias) + BatchNorm
    (reference deconvbn_3d); doubles D, H and W."""

    def __init__(self, cin: int, cout: int):
        super().__init__(nn.ConvTranspose3d(cin, cout, 3, stride=2, padding=1,
                                            output_padding=1, bias=False),
                         _bn(cout))

    def folded(self) -> nn.ConvTranspose3d:
        deconv, bn = self[0], self[1]
        a, b = _bn_affine(bn)
        out = nn.ConvTranspose3d(deconv.in_channels, deconv.out_channels, 3,
                                 stride=2, padding=1, output_padding=1,
                                 bias=True, device=deconv.weight.device)
        with torch.no_grad():
            # ConvTranspose3d weight is [in, out, kd, kh, kw]
            out.weight.copy_(deconv.weight.float() * a.view(1, -1, 1, 1, 1))
            out.bias.copy_(b)
        return out


def _bn_affine(bn: nn.BatchNorm3d):
    """Eval BatchNorm as y = a*x + b per channel, in float32."""
    a = bn.weight.float() * torch.rsqrt(bn.running_var.float() + bn.eps)
    return a, bn.bias.float() - bn.running_mean.float() * a


class Conv3DBlock(nn.Module):
    """3x (conv+BN+ReLU), the first conv strided (reference Conv3DBlock)."""

    def __init__(self, cin: int, cout: int, stride: int = 2):
        super().__init__()
        self.convbn_3d_1 = ConvBN3D(cin, cout, stride)
        self.convbn_3d_2 = ConvBN3D(cout, cout)
        self.convbn_3d_3 = ConvBN3D(cout, cout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.convbn_3d_1(x))
        x = F.relu(self.convbn_3d_2(x))
        return F.relu(self.convbn_3d_3(x))


def fold_batchnorm(module: nn.Module) -> nn.Module:
    """Replace every ConvBN3D / DeconvBN3D under ``module`` (in place) by
    its folded eval conv; returns ``module``."""
    for name, child in module.named_children():
        if isinstance(child, (ConvBN3D, DeconvBN3D)):
            setattr(module, name, child.folded())
        else:
            fold_batchnorm(child)
    return module


def soft_argmin(logits: torch.Tensor, max_disp: int) -> torch.Tensor:
    """softmax over D (float32) + expectation sum_d d*p(d):
    [N, D, H, W] -> [N, H, W] (reference disparityregression)."""
    N, D, H, W = logits.shape
    if D != max_disp:
        raise ValueError(f"soft_argmin: {D} disparities != max_disp {max_disp}")
    p = torch.softmax(logits.float(), dim=1)
    d = torch.arange(max_disp, dtype=torch.float32,
                     device=logits.device).view(1, max_disp, 1, 1)
    return (p * d).sum(dim=1)
