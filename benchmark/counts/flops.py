"""Model FLOPs of a served pair and of a train step, counted on the plain
reference architecture at the cell's shapes (on the ``meta`` device, so no
memory or time is spent), never on the port's modules.

A convolution costs its output voxels x Cout x Cin x k^3 multiply-adds (its
zero-padding taps included, as the cuDNN kernels compute them). A
transposed convolution costs its *input* voxels x Cin x Cout x k^3: each
input voxel scatters to k^3 outputs, and the zeros a stride-2 dilation
would insert are no work. A FLOP is half a multiply-add. A train step is
the forward, the weight gradient of every convolution and the input
gradient of every convolution but the first (nothing asks for the
gradient of the feature volume): 3x the forward less the first layer's
input gradient. The softmax, the soft-argmin, BN and the feature stage
are not counted.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn as nn

from ..reference import models as RM


def conv_macs(model_cfg: dict, volume_shape: Sequence[int]) -> list:
    """[(module name, multiply-adds)] of each 3-D convolution of a forward
    of the reference model over a volume [N, C, D, H, W], in call order."""
    model = RM.build(model_cfg, "meta")
    names = {m: n for n, m in model.named_modules()}
    out = []

    def hook(mod, inp, res):
        k = mod.weight.shape[2] * mod.weight.shape[3] * mod.weight.shape[4]
        if isinstance(mod, nn.ConvTranspose3d):
            vox = inp[0].numel() // mod.in_channels
        else:
            vox = res.numel() // mod.out_channels
        out.append((names[mod], vox * mod.in_channels * mod.out_channels * k))

    hooks = [m.register_forward_hook(hook) for m in RM.conv_modules(model)]
    try:
        with torch.no_grad():
            model(torch.empty(tuple(volume_shape), device="meta"))
    finally:
        for h in hooks:
            h.remove()
    return out


def volume_shape(model_cfg: dict, matching: dict, batch: int,
                 hw: Tuple[int, int]) -> Tuple[int, ...]:
    """The feature volume of ``batch`` frames of full-resolution size
    ``hw`` (a bucket, or a train crop without its margins)."""
    s = matching["ds_scale"]
    return (batch, model_cfg["in_channels"], model_cfg["max_disp"] // s,
            hw[0] // s, hw[1] // s)


def forward_flops(model_cfg: dict, matching: dict, batch: int,
                  hw: Tuple[int, int]) -> float:
    macs = conv_macs(model_cfg, volume_shape(model_cfg, matching, batch, hw))
    return 2.0 * sum(m for _, m in macs)


def train_step_flops(model_cfg: dict, matching: dict, batch: int,
                     hw: Tuple[int, int]) -> float:
    macs = conv_macs(model_cfg, volume_shape(model_cfg, matching, batch, hw))
    return 2.0 * (3 * sum(m for _, m in macs) - macs[0][1])
