"""3-D CNN building blocks on [N, C, D, H, W] volumes held channels last
(counterpart of ``msnets_tpu/models/layers.py``).

The port carries the JAX layers' math, not their TPU layouts: the packed
space-to-depth convolutions, the phase packing of ``PackedPhaseBN``, the
pz-slab head and the W-fold exist there only for the TPU matrix unit's
lane layout. Which convs the JAX int8 eval quantizes depends on those
layouts; ``quant.py`` reproduces the decision. Here a conv is ``nn.Conv3d(k3, p1)``, a deconv
``nn.ConvTranspose3d(k3, s2, p1, output_padding=1)`` and BN a
``BatchNorm3d(eps=1e-5, momentum=0.1)``, with the reference checkpoint's
module names (a ConvBN3D is ``Sequential(conv, bn)``, keys ``.0.weight``,
``.1.running_var``, ``.1.num_batches_tracked``).

Parameters are float32. ConvBN3D and DeconvBN3D cast their kernel to the
input's dtype, so a float32 model computes in bfloat16 when its input is
bfloat16 (the JAX train path's dtype placement, without ``autocast``).

**Layout.** Every 5-D activation of a regularizer has the logical shape
[N, C, D, H, W] and the memory format ``torch.channels_last_3d`` (NDHWC
strides), the layout of cuDNN's 3-D conv kernels: handed NCDHW, cuDNN
transposes each conv's input in and its output back. ``to_ndhwc`` copies
the volume into it once, at the model's entry, together with the cast to
the compute dtype; each conv and deconv casts its kernel to the input's
dtype and to NDHWC in one copy, and cuDNN, BN, ReLU and the adds keep the
format from there; a conv of one output channel runs padded to 16 bytes
of channels (``one_channel_conv``). Parameters, their gradients and the
state_dict stay NCDHW float32; ``cast_eval_model`` converts a served
model's 5-D kernels once.

Train-mode BN has the JAX package's semantics (``BatchNorm3d``): batch
statistics in float32 with the *biased* variance, which also feeds the
running variance, where ``nn.BatchNorm3d`` feeds the unbiased one. Under a
data-parallel step the batch is the global one (all ranks' samples); on a
volume split over a mesh (``parallel.Sharded``) the statistics are those of
the global volume, summed over the ranks that hold its blocks.

Eval folds BN into the preceding conv or deconv (``fold_batchnorm``), in
float32, as the JAX eval path does: y = conv(x, k*a) + (beta - mu*a) with
a = gamma * rsqrt(var + eps).

``BatchNorm2d`` and ``ConvBN2D`` are the same on [N, C, H, W], for a
learned 2-D feature tower (GC-Net's, ``gcnet_kendall.py``), which has no
JAX counterpart; ``fold_batchnorm`` folds them too.

``remat`` runs a stage through ``torch.utils.checkpoint`` (the JAX models'
``nn.remat``): its activations are recomputed in the backward, and the
recomputation leaves the BN running statistics as the forward left them.
A stage's input may be a ``Sharded`` volume: the recomputation runs its
collectives again, in the same order on every rank.
"""
from __future__ import annotations

import contextlib
import math
import threading
from typing import Iterator, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..ops.matchers import _div_const
from ..parallel import mesh as pm
from ..parallel.mesh import (all_reduce_max, all_reduce_sum, group_size,
                             sum_over)
from .quant import NDHWC, QuantConv3d, QuantSite, is_ndhwc, kernel

_COUNT_LOCK = threading.Lock()    # servers call from several threads
_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def compute_dtype(model_cfg) -> torch.dtype:
    """A ``ModelConfig``'s ``compute_dtype`` as a torch dtype."""
    if model_cfg.compute_dtype not in _DTYPES:
        raise ValueError(f"compute_dtype={model_cfg.compute_dtype!r}")
    return _DTYPES[model_cfg.compute_dtype]


def he_normal_(weight: torch.Tensor, out_channels: int,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """N(0, sqrt(2/n)) with n = k^3 * out_channels (reference net_init)."""
    n = math.prod(weight.shape[2:]) * out_channels
    with torch.no_grad():
        return weight.normal_(0.0, math.sqrt(2.0 / n), generator=generator)


def _bcast(v: torch.Tensor, ndim: int) -> torch.Tensor:
    """A per-channel vector [C] shaped to broadcast over [N, C, ...]."""
    return v.view((1, -1) + (1,) * (ndim - 2))


def one_channel_width(dtype: torch.dtype) -> int:
    """The output channels ``one_channel_conv`` runs a one-channel conv
    with in ``dtype``: 16 bytes of them (8 in bfloat16, 4 in float32)."""
    return 16 // (torch.finfo(dtype).bits // 8)


def one_channel_conv(x, weight: torch.Tensor, stride: int = 1,
                     output_padding: Optional[int] = None):
    """``F.conv3d(x, weight, None, stride, 1)`` for a kernel of one output
    channel, or with ``output_padding`` ``F.conv_transpose3d(x, weight,
    None, stride, 1, output_padding)``: [N, 1, D', H', W'] in x's dtype
    (``x`` NDHWC, or a ``parallel.Sharded`` volume).

    cuDNN takes a one-channel tensor for NCDHW: it transposes its NDHWC
    kernels' output into it, and the gradient out of it, and in the
    backward picks slower kernels. So the kernel gets zero output channels
    up to ``one_channel_width(x.dtype)``, the conv writes an NDHWC volume
    of them, and channel 0 is returned: a view of the same values as the
    one-channel conv's (the others are 0)."""
    extra = one_channel_width(x.dtype) - 1
    if output_padding is None:
        w = kernel(F.pad(weight, (0, 0) * 4 + (0, extra)), x.dtype)
        y = F.conv3d(x, w, None, stride, 1)
    else:
        w = kernel(F.pad(weight, (0, 0) * 3 + (0, extra)), x.dtype)
        y = F.conv_transpose3d(x, w, None, stride, 1, output_padding)
    if isinstance(y, pm.Sharded):
        return pm.Sharded(y.local[:, :1], (y.shape[0], 1) + tuple(y.shape[2:]),
                          y.mesh, y.spec)
    return y[:, :1]


class _ToNDHWC(torch.autograd.Function):
    """``x.to(dtype)`` written NDHWC; the backward hands the gradient back
    in ``x``'s dtype and format (NCDHW unless ``x`` was NDHWC)."""

    @staticmethod
    def forward(ctx, x, dtype):
        ctx.dtype = x.dtype
        ctx.format = NDHWC if is_ndhwc(x) else torch.contiguous_format
        return x.to(dtype, memory_format=NDHWC)

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.dtype, memory_format=ctx.format), None


def to_ndhwc(x, dtype: torch.dtype):
    """The regularizer's entry: the volume ``x`` ([N, C, D, H, W], or a
    ``parallel.Sharded`` one) in ``dtype`` and NDHWC, as one copy, or ``x``
    itself when it is both already. Differentiable; the gradient goes back
    in ``x``'s dtype and layout.

    Counters, kept as attributes: ``copies`` counts the volumes that came
    in another layout and were copied into NDHWC, ``bytes`` the bytes those
    copies wrote."""
    if isinstance(x, pm.Sharded):
        return x._like(to_ndhwc(x.local, dtype))
    if x.dtype == dtype and is_ndhwc(x):
        return x
    relaid = not is_ndhwc(x)
    out = _ToNDHWC.apply(x, dtype)
    if relaid:
        with _COUNT_LOCK:
            to_ndhwc.copies += 1
            to_ndhwc.bytes += out.numel() * out.element_size()
    return out


to_ndhwc.copies = 0
to_ndhwc.bytes = 0


class _BatchNormTrain(torch.autograd.Function):
    """Batch-statistics normalization with the JAX package's forward and
    hand-written backward (``msnets_tpu/models/layers.py:_phase_bn_fwd``,
    ``_phase_bn_bwd``).

    Forward: mean and E[x^2] summed in float32 straight off the input,
    var = E[x^2] - mean^2 (biased), and the affine in the input's dtype.
    Returns (out, mean, var); mean and var feed the running averages only
    and take no gradient. Backward saves the input in its own dtype and the
    per-channel (mean, rinv), not a float32 copy of the volume.

    With a process ``group`` (the data axis, or the ranks holding the
    blocks of a sharded volume) the statistics are those of the global
    batch, as under GSPMD: the forward all-reduces the packed [sum, sum of
    squares] and counts every rank's elements (the blocks are of one size),
    the backward all-reduces the packed [sg, sgx] before forming dL/dy. The
    scale and bias gradients it returns are the *local* sgx and sg: the
    step's gradient all-reduce sums them over the ranks."""

    @staticmethod
    def forward(ctx, y, scale, bias, eps: float, group=None):
        red = [0] + list(range(2, y.dim()))
        c = y.shape[1]
        n = y.numel() // c
        sums = torch.cat([y.sum(red, dtype=torch.float32),
                          y.float().square().sum(red)])
        if group is not None:
            all_reduce_sum(sums, group)
            n *= group_size(group)
        mean = _div_const(sums[:c], n)
        sq = _div_const(sums[c:], n)
        var = sq - mean * mean
        rinv = torch.rsqrt(var + eps)
        a = rinv * scale
        b = bias - mean * rinv * scale
        out = y * _bcast(a.to(y.dtype), y.dim()) + _bcast(b.to(y.dtype), y.dim())
        ctx.save_for_backward(y, scale, mean, rinv)
        ctx.n, ctx.group = n, group
        ctx.mark_non_differentiable(mean, var)
        return out, mean, var

    @staticmethod
    def backward(ctx, g, _g_mean, _g_var):
        y, scale, mean, rinv = ctx.saved_tensors
        red = [0] + list(range(2, y.dim()))
        nd, n, c = y.dim(), ctx.n, y.shape[1]
        local = torch.cat([g.sum(red, dtype=torch.float32),
                           (g.float() * (y.float() - _bcast(mean, nd))
                            * _bcast(rinv, nd)).sum(red)])
        sums = local
        if ctx.group is not None:
            sums = all_reduce_sum(local.clone(), ctx.group)
        sg, sgx = sums[:c], sums[c:]
        # dL/dy = gamma*rinv * (g - (sg + xhat*sgx)/n) = a1*g + c1*y + c0
        a1 = scale * rinv
        c1 = _div_const(-scale * rinv * rinv * sgx, n)
        c0 = _div_const(-a1 * sg, n) - c1 * mean
        dy = (g * _bcast(a1.to(g.dtype), nd) + y * _bcast(c1.to(y.dtype), nd)
              + _bcast(c0.to(g.dtype), nd))
        return dy, local[c:], local[:c], None, None


class BatchNorm3d(nn.BatchNorm3d):
    """``nn.BatchNorm3d`` whose train mode follows the JAX package
    (``PackedPhaseBN``, flax momentum 0.9 = torch momentum 0.1):

        mean, var = batch mean and *biased* variance (float32)
        running_mean = 0.9 * running_mean + 0.1 * mean
        running_var  = 0.9 * running_var  + 0.1 * var

    where ``nn.BatchNorm3d`` puts the unbiased variance into running_var.
    ``num_batches_tracked`` counts as in torch. Eval mode is torch's.
    On a ``parallel.Sharded`` volume the batch is the global one: the
    statistics are taken over the ranks that hold its blocks
    (``Sharded.group``: the data group and the group of every axis that
    splits the volume, not an axis along which it is whole), so the running
    statistics stay equal on every rank, and the output is sharded alike.
    While ``frozen_stats`` is set (``remat``'s recomputation) train mode
    normalizes with the batch statistics and updates nothing."""

    frozen_stats = False

    def forward(self, x):
        sharded = isinstance(x, pm.Sharded)
        y = x.local if sharded else x
        if not self.training:
            out = super().forward(y)
        else:
            out, mean, var = _BatchNormTrain.apply(
                y, self.weight, self.bias, self.eps,
                x.group if sharded else None)
            if not self.frozen_stats:
                m = self.momentum
                with torch.no_grad():
                    self.running_mean.copy_((1 - m) * self.running_mean
                                            + m * mean)
                    self.running_var.copy_((1 - m) * self.running_var
                                           + m * var)
                    self.num_batches_tracked.add_(1)
        return x._like(out) if sharded else out


class BatchNorm2d(BatchNorm3d):
    """``BatchNorm3d`` (the JAX package's train statistics) on
    [N, C, H, W]."""

    def _check_input_dim(self, input):
        if input.dim() != 4:
            raise ValueError(f"expected 4D input (got {input.dim()}D input)")


def _bn(cout: int) -> BatchNorm3d:
    return BatchNorm3d(cout, eps=1e-5, momentum=0.1)


class ConvBN3D(nn.Sequential):
    """conv3d (k3, p1, no bias) + BatchNorm (reference convbn_3d).

    ``quant``: the conv is one the JAX model flags for int8 eval
    (``quant.QuantSite``); it folds into a ``quant.QuantConv3d`` running
    ``quant_mode``. Train mode and the unfolded eval never quantize: the
    JAX eval folds BN before it quantizes, and so does the port's server."""

    def __init__(self, cin: int, cout: int, stride: int = 1,
                 quant: Optional[QuantSite] = None,
                 quant_mode: str = "dynamic"):
        super().__init__(nn.Conv3d(cin, cout, 3, stride=stride, padding=1,
                                   bias=False), _bn(cout))
        self.quant, self.quant_mode = quant, quant_mode

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        conv, bn = self[0], self[1]
        return bn(F.conv3d(x, kernel(conv.weight, x.dtype), None,
                           conv.stride, 1))

    def folded(self) -> nn.Module:
        """Eval conv with the BN affine folded into kernel and bias (f32);
        a ``QuantConv3d`` for a ``quant`` conv."""
        conv, bn = self[0], self[1]
        a, b = _bn_affine(bn)
        if self.quant is not None:
            return QuantConv3d(conv.weight.float() * a.view(-1, 1, 1, 1, 1),
                               b, conv.stride[0], self.quant, self.quant_mode)
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
        return bn(F.conv_transpose3d(x, kernel(deconv.weight, x.dtype), None,
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


class ConvBN2D(nn.Sequential):
    """conv2d (k, padding k // 2, no bias) + ``BatchNorm2d``: a learned
    feature tower's layer (``gcnet_kendall.UnaryTower``). Like ``ConvBN3D``
    its kernel is cast to the input's dtype and BN keeps float32
    statistics; eval folds BN into the conv (``folded``)."""

    def __init__(self, cin: int, cout: int, kernel: int = 3, stride: int = 1):
        super().__init__(nn.Conv2d(cin, cout, kernel, stride=stride,
                                   padding=kernel // 2, bias=False),
                         BatchNorm2d(cout, eps=1e-5, momentum=0.1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        conv, bn = self[0], self[1]
        return bn(F.conv2d(x, conv.weight.to(x.dtype), None, conv.stride,
                           conv.padding))

    def folded(self) -> nn.Conv2d:
        conv, bn = self[0], self[1]
        a, b = _bn_affine(bn)
        out = nn.Conv2d(conv.in_channels, conv.out_channels, conv.kernel_size,
                        stride=conv.stride, padding=conv.padding, bias=True,
                        device=conv.weight.device)
        with torch.no_grad():
            out.weight.copy_(conv.weight.float() * a.view(-1, 1, 1, 1))
            out.bias.copy_(b)
        return out


def _bn_affine(bn: nn.BatchNorm3d):
    """Eval BatchNorm as y = a*x + b per channel, in float32."""
    a = bn.weight.float() * torch.rsqrt(bn.running_var.float() + bn.eps)
    return a, bn.bias.float() - bn.running_mean.float() * a


class Conv3DBlock(nn.Module):
    """3x (conv+BN+ReLU), the first conv strided (reference Conv3DBlock);
    ``quant`` flags the first (the JAX block quantizes its entry only)."""

    def __init__(self, cin: int, cout: int, stride: int = 2,
                 quant: Optional[QuantSite] = None,
                 quant_mode: str = "dynamic"):
        super().__init__()
        self.convbn_3d_1 = ConvBN3D(cin, cout, stride, quant, quant_mode)
        self.convbn_3d_2 = ConvBN3D(cout, cout)
        self.convbn_3d_3 = ConvBN3D(cout, cout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.convbn_3d_1(x))
        x = F.relu(self.convbn_3d_2(x))
        return F.relu(self.convbn_3d_3(x))


def fold_batchnorm(module: nn.Module) -> nn.Module:
    """Replace every ConvBN3D / DeconvBN3D / ConvBN2D under ``module`` (in
    place) by its folded eval conv; returns ``module``."""
    for name, child in module.named_children():
        if isinstance(child, (ConvBN3D, DeconvBN3D, ConvBN2D)):
            setattr(module, name, child.folded())
        else:
            fold_batchnorm(child)
    return module


def cast_eval_model(model: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Cast a folded eval model's floating parameters and buffers to
    ``dtype`` (in place), except the children the model names in
    ``FLOAT32_CHILDREN`` and the ``QuantConv3d`` convs, whose quantizer
    re-scales from float32 (JAX's "quantized lowerings re-scale from
    f32"); the 5-D kernels of the cast children go to NDHWC in the same
    copy, so that no conv copies its kernel on a call. Returns
    ``model``."""
    keep = getattr(model, "FLOAT32_CHILDREN", ())
    for name, child in model.named_children():
        if name in keep:
            continue
        for m in child.modules():
            if isinstance(m, QuantConv3d):
                continue
            for key, p in m.named_parameters(recurse=False):
                p.data = (kernel(p.data, dtype) if p.dim() == 5
                          else p.data.to(dtype))
            for key, b in m.named_buffers(recurse=False):
                if b.is_floating_point():
                    m._buffers[key] = b.to(dtype)
    return model


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


def _linear_resize_axis(x: torch.Tensor, axis: int, out_size: int,
                        rows: Optional[Tuple[int, int]] = None
                        ) -> torch.Tensor:
    """1-D linear resize with align_corners=True, in the JAX package's
    index arithmetic (``msnets_tpu/models/layers.py:_linear_resize_axis``):
    source positions arange(out) * float32((in-1)/(out-1)). With ``rows``
    ``(o0, o1)``, only those output rows, each computed as in the whole."""
    in_size = x.shape[axis]
    o0, o1 = rows or (0, out_size)
    if in_size == out_size:
        return x.narrow(axis, o0, o1 - o0)
    if out_size == 1 or in_size == 1:
        idx = torch.zeros(o1 - o0, dtype=torch.long, device=x.device)
        return x.index_select(axis, idx)
    step = torch.tensor((in_size - 1) / (out_size - 1), dtype=torch.float32)
    src = torch.arange(o0, o1, dtype=torch.float32) * step
    lo = src.floor().long().clamp(0, in_size - 2)
    w = src - lo.float()
    shape = [1] * x.dim()
    shape[axis] = o1 - o0
    w = w.view(shape).to(x.device)
    a = x.index_select(axis, lo.to(x.device))
    b = x.index_select(axis, (lo + 1).to(x.device))
    return a * (1.0 - w) + b * w


def resize_trilinear_align_corners(x, out_dhw: Tuple[int, int, int],
                                   axes: Tuple[int, int, int] = (2, 3, 4)):
    """Trilinear resize with align_corners=True, one linear resize per axis
    (D, then H, then W), written as gathers and products: ``F.interpolate``
    computes its source indices otherwise and misses JAX in the last
    bits.

    On a sharded [N, C, D, H, W] volume every rank gathers the input (the
    one-channel cost of MS-PSMNet's head, 1/F of a volume; its data share
    of N) and computes the block of the output that the output's layout
    gives it. In the backward each rank's gradient of the gathered input
    is a share, which the gather's adjoint sums over the axis group."""
    if not isinstance(x, pm.Sharded):
        for ax, n in zip(axes, out_dhw):
            x = _linear_resize_axis(x, ax, n)
        return x
    out_shape = tuple(x.shape[:2]) + tuple(out_dhw)
    spec = pm.volume_layout(out_shape, x.mesh.shape)
    t = pm.gather_volume(x)
    for ax, n in zip(axes, out_dhw):
        t = _linear_resize_axis(t, ax, n, pm.block(n, x.mesh, spec[ax]))
    return pm.Sharded(t, out_shape, x.mesh, spec)


def soft_argmin(logits, max_disp: int):
    """softmax over D (float32) + expectation sum_d d*p(d):
    [N, D, H, W] -> [N, H, W] (reference disparityregression).

    On sharded logits whose D the disp axis splits, the softmax is split:
    the maximum over the disp group (no gradient: the softmax does not
    depend on it), then sum(exp) and sum(d * exp), with d each row's global
    disparity, summed over the group together (``sum_over``, whose adjoint
    is the same all-reduce). The disparity is whole on every rank of the
    disp group; the losses count it once (``Sharded.owner``)."""
    N, D, H, W = logits.shape
    if D != max_disp:
        raise ValueError(f"soft_argmin: {D} disparities != max_disp {max_disp}")
    if not isinstance(logits, pm.Sharded):
        return _soft_argmin(logits.float())
    mesh, spec = logits.mesh, logits.spec
    x = logits.local.float()
    axis = spec[1]
    out_spec = (spec[0], spec[2], spec[3])
    if axis is None:
        return pm.Sharded(_soft_argmin(x), (N, H, W), mesh, out_spec)
    d0 = pm.block(D, mesh, axis)[0]
    group = mesh.axis_groups[axis]
    m = all_reduce_max(x.detach().amax(1, keepdim=True), group)
    e = torch.exp(x - m)
    d = torch.arange(d0, d0 + x.shape[1], dtype=torch.float32,
                     device=x.device).view(1, -1, 1, 1)
    sums = sum_over(torch.stack([e.sum(1), (e * d).sum(1)]), group)
    return pm.Sharded(sums[1] / sums[0], (N, H, W), mesh, out_spec)


def _soft_argmin(x: torch.Tensor) -> torch.Tensor:
    p = torch.softmax(x, dim=1)
    d = torch.arange(x.shape[1], dtype=torch.float32,
                     device=x.device).view(1, -1, 1, 1)
    return (p * d).sum(dim=1)


def conv_head(x, weight: torch.Tensor, stride: int, max_disp: int,
              dtype: torch.dtype = torch.float32):
    """MS-GCNet's head as a conv: deconv5 (``weight`` [C, 1, 3, 3, 3],
    ``stride``, output_padding stride - 1) on ``x`` cast to ``dtype``,
    writing the logits, then ``soft_argmin``: [N, C, D, H, W] ->
    [N, stride*H, stride*W] (``x`` NDHWC, or a ``parallel.Sharded``
    volume). The path ``MSGCNet.head`` keeps where it needs the logits."""
    logits = one_channel_conv(x.to(dtype), weight, stride, stride - 1)
    return soft_argmin(logits.squeeze(1), max_disp)
