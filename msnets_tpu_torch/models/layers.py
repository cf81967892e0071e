"""3-D CNN building blocks in NCDHW (counterpart of
``msnets_tpu/models/layers.py``).

The port carries the JAX layers' math, not their TPU layouts: the packed
space-to-depth convolutions, the phase packing of ``PackedPhaseBN``, the
pz-slab head, the W-fold and the int8 paths exist there only for the TPU
matrix unit's lane layout. Here a conv is ``nn.Conv3d(k3, p1)``, a deconv
``nn.ConvTranspose3d(k3, s2, p1, output_padding=1)`` and BN a
``BatchNorm3d(eps=1e-5, momentum=0.1)``, with the reference checkpoint's
module names (a ConvBN3D is ``Sequential(conv, bn)``, keys ``.0.weight``,
``.1.running_var``, ``.1.num_batches_tracked``).

Parameters are float32. ConvBN3D and DeconvBN3D cast their kernel to the
input's dtype, so a float32 model computes in bfloat16 when its input is
bfloat16 (the JAX train path's dtype placement, without ``autocast``).

Train-mode BN has the JAX package's semantics (``BatchNorm3d``): batch
statistics in float32 with the *biased* variance, which also feeds the
running variance, where ``nn.BatchNorm3d`` feeds the unbiased one.

Eval folds BN into the preceding conv or deconv (``fold_batchnorm``), in
float32, as the JAX eval path does: y = conv(x, k*a) + (beta - mu*a) with
a = gamma * rsqrt(var + eps).

``remat`` runs a stage through ``torch.utils.checkpoint`` (the JAX models'
``nn.remat``): its activations are recomputed in the backward, and the
recomputation leaves the BN running statistics as the forward left them.
"""
from __future__ import annotations

import contextlib
import math
from typing import Iterator, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..ops.matchers import _div_const


def he_normal_(weight: torch.Tensor, out_channels: int,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """N(0, sqrt(2/n)) with n = k^3 * out_channels (reference net_init)."""
    n = math.prod(weight.shape[2:]) * out_channels
    with torch.no_grad():
        return weight.normal_(0.0, math.sqrt(2.0 / n), generator=generator)


def _bcast(v: torch.Tensor, ndim: int) -> torch.Tensor:
    """A per-channel vector [C] shaped to broadcast over [N, C, ...]."""
    return v.view((1, -1) + (1,) * (ndim - 2))


class _BatchNormTrain(torch.autograd.Function):
    """Batch-statistics normalization with the JAX package's forward and
    hand-written backward (``msnets_tpu/models/layers.py:_phase_bn_fwd``,
    ``_phase_bn_bwd``).

    Forward: mean and E[x^2] summed in float32 straight off the input,
    var = E[x^2] - mean^2 (biased), and the affine in the input's dtype.
    Returns (out, mean, var); mean and var feed the running averages only
    and take no gradient. Backward saves the input in its own dtype and the
    per-channel (mean, rinv), not a float32 copy of the volume."""

    @staticmethod
    def forward(ctx, y, scale, bias, eps: float):
        red = [0] + list(range(2, y.dim()))
        n = y.numel() // y.shape[1]
        mean = _div_const(y.sum(red, dtype=torch.float32), n)
        sq = _div_const(y.float().square().sum(red), n)
        var = sq - mean * mean
        rinv = torch.rsqrt(var + eps)
        a = rinv * scale
        b = bias - mean * rinv * scale
        out = y * _bcast(a.to(y.dtype), y.dim()) + _bcast(b.to(y.dtype), y.dim())
        ctx.save_for_backward(y, scale, mean, rinv)
        ctx.n = n
        ctx.mark_non_differentiable(mean, var)
        return out, mean, var

    @staticmethod
    def backward(ctx, g, _g_mean, _g_var):
        y, scale, mean, rinv = ctx.saved_tensors
        red = [0] + list(range(2, y.dim()))
        nd, n = y.dim(), ctx.n
        sg = g.sum(red, dtype=torch.float32)
        sgx = (g.float() * (y.float() - _bcast(mean, nd))
               * _bcast(rinv, nd)).sum(red)
        # dL/dy = gamma*rinv * (g - (sg + xhat*sgx)/n) = a1*g + c1*y + c0
        a1 = scale * rinv
        c1 = _div_const(-scale * rinv * rinv * sgx, n)
        c0 = _div_const(-a1 * sg, n) - c1 * mean
        dy = (g * _bcast(a1.to(g.dtype), nd) + y * _bcast(c1.to(y.dtype), nd)
              + _bcast(c0.to(g.dtype), nd))
        return dy, sgx, sg, None


class BatchNorm3d(nn.BatchNorm3d):
    """``nn.BatchNorm3d`` whose train mode follows the JAX package
    (``PackedPhaseBN``, flax momentum 0.9 = torch momentum 0.1):

        mean, var = batch mean and *biased* variance (float32)
        running_mean = 0.9 * running_mean + 0.1 * mean
        running_var  = 0.9 * running_var  + 0.1 * var

    where ``nn.BatchNorm3d`` puts the unbiased variance into running_var.
    ``num_batches_tracked`` counts as in torch. Eval mode is torch's.
    While ``frozen_stats`` is set (``remat``'s recomputation) train mode
    normalizes with the batch statistics and updates nothing."""

    frozen_stats = False

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        out, mean, var = _BatchNormTrain.apply(x, self.weight, self.bias,
                                               self.eps)
        if self.frozen_stats:
            return out
        m = self.momentum
        with torch.no_grad():
            self.running_mean.copy_((1 - m) * self.running_mean + m * mean)
            self.running_var.copy_((1 - m) * self.running_var + m * var)
            self.num_batches_tracked.add_(1)
        return out


def _bn(cout: int) -> BatchNorm3d:
    return BatchNorm3d(cout, eps=1e-5, momentum=0.1)


class ConvBN3D(nn.Sequential):
    """conv3d (k3, p1, no bias) + BatchNorm (reference convbn_3d)."""

    def __init__(self, cin: int, cout: int, stride: int = 1):
        super().__init__(nn.Conv3d(cin, cout, 3, stride=stride, padding=1,
                                   bias=False), _bn(cout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        conv, bn = self[0], self[1]
        return bn(F.conv3d(x, conv.weight.to(x.dtype), None, conv.stride, 1))

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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        deconv, bn = self[0], self[1]
        return bn(F.conv_transpose3d(x, deconv.weight.to(x.dtype), None,
                                     stride=2, padding=1, output_padding=1))

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


@contextlib.contextmanager
def _frozen_stats(module: nn.Module) -> Iterator[None]:
    bns = [m for m in module.modules() if isinstance(m, BatchNorm3d)]
    for bn in bns:
        bn.frozen_stats = True
    try:
        yield
    finally:
        for bn in bns:
            bn.frozen_stats = False


def remat(module: nn.Module, *args, on: bool = True):
    """``module(*args)``; with ``on``, in training and with gradients
    enabled, through ``torch.utils.checkpoint``: the backward recomputes the
    stage's activations instead of keeping them. The recomputation runs
    with the stage's BatchNorms' statistics frozen, so each updates its
    running statistics once per forward, as under JAX's ``nn.remat``."""
    if not (on and module.training and torch.is_grad_enabled()):
        return module(*args)
    return checkpoint(module, *args, use_reentrant=False,
                      context_fn=lambda: (contextlib.nullcontext(),
                                          _frozen_stats(module)))


def _linear_resize_axis(x: torch.Tensor, axis: int,
                        out_size: int) -> torch.Tensor:
    """1-D linear resize with align_corners=True, in the JAX package's
    index arithmetic (``msnets_tpu/models/layers.py:_linear_resize_axis``):
    source positions arange(out) * float32((in-1)/(out-1))."""
    in_size = x.shape[axis]
    if in_size == out_size:
        return x
    if out_size == 1 or in_size == 1:
        idx = torch.zeros(out_size, dtype=torch.long, device=x.device)
        return x.index_select(axis, idx)
    step = torch.tensor((in_size - 1) / (out_size - 1), dtype=torch.float32)
    src = torch.arange(out_size, dtype=torch.float32) * step
    lo = src.floor().long().clamp(0, in_size - 2)
    w = src - lo.float()
    shape = [1] * x.dim()
    shape[axis] = out_size
    w = w.view(shape).to(x.device)
    a = x.index_select(axis, lo.to(x.device))
    b = x.index_select(axis, (lo + 1).to(x.device))
    return a * (1.0 - w) + b * w


def resize_trilinear_align_corners(x: torch.Tensor,
                                   out_dhw: Tuple[int, int, int],
                                   axes: Tuple[int, int, int] = (2, 3, 4)
                                   ) -> torch.Tensor:
    """Trilinear resize with align_corners=True, one linear resize per axis
    (D, then H, then W), written as gathers and products: ``F.interpolate``
    computes its source indices otherwise and misses JAX in the last
    bits."""
    for ax, n in zip(axes, out_dhw):
        x = _linear_resize_axis(x, ax, n)
    return x


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
