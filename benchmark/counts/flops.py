"""Model FLOPs of a served pair and of a train step, counted on the
configuration's reference system (``reference/__init__.py``) at the cell's
shapes, from the input its entry point takes (the padded pair, the crops
with their margins), on the ``meta`` device, so no memory or time is
spent, never on the port's modules.

Every convolution of the system counts, of any rank, those of a learned
feature stage included. A convolution costs its output positions x Cout x
Cin x k / groups multiply-adds, k its kernel's taps (its zero-padding taps
included, as the cuDNN kernels compute them). A transposed convolution
costs its *input* positions x Cin x Cout x k / groups: each input position
scatters to k outputs, and the zeros a stride-2 dilation would insert are
no work. A FLOP is half a multiply-add. A train step is the forward, the
weight gradient of every convolution and the input gradient of every
convolution whose input needs one: 3x the forward less the input gradient
of the convolutions that the input reaches first (the first conv on a
matching-space volume; both views' first conv of a learned 2-D tower),
since nothing asks for the gradient of the input. The softmax, the
soft-argmin, BN and the classical matchers (which hold no convolution)
are not counted.
"""
from __future__ import annotations

import math
from typing import Callable, Tuple

import torch
from torch.nn.modules.conv import _ConvNd

from .. import reference


def conv_macs(system: torch.nn.Module, run: Callable[[], object]) -> list:
    """[(module name, multiply-adds, whether its input needs a gradient)]
    of each convolution of ``system`` that ``run()`` calls, in call
    order."""
    names = {m: n for n, m in system.named_modules()}
    out = []

    def hook(mod, inp, res):
        k = math.prod(mod.weight.shape[2:])
        if mod.transposed:
            pos = inp[0].numel() // mod.in_channels
        else:
            pos = res.numel() // mod.out_channels
        out.append((names[mod], pos * mod.in_channels * mod.out_channels * k
                    // mod.groups, inp[0].requires_grad))

    hooks = [m.register_forward_hook(hook) for m in system.modules()
             if isinstance(m, _ConvNd)]
    try:
        with torch.enable_grad():
            run()
    finally:
        for h in hooks:
            h.remove()
    return out


def _image(shape, channels: int) -> torch.Tensor:
    return torch.empty(tuple(shape) + ((channels,) if channels > 1 else ()),
                       dtype=torch.uint8, device="meta")


def serve_macs(config: dict, hw: Tuple[int, int], channels: int = 1) -> list:
    """``conv_macs`` of serving one pair padded to the bucket ``hw``."""
    system = reference.build(config, "meta")
    img = _image(hw, channels)
    return conv_macs(system, lambda: system(system.serve_features(img,
                                                                  img)[None]))


def train_macs(config: dict, batch: int, crop: Tuple[int, int],
               channels: int = 1) -> list:
    """``conv_macs`` of the forward of a train step over ``batch`` crops of
    ``crop`` with the system's margins."""
    system = reference.build(config, "meta")
    bh, bwl, bwr = system.train_margins(config)
    img = _image((batch, crop[0] + 2 * bh, crop[1] + bwl + bwr), channels)
    return conv_macs(system, lambda: system(system.train_features(
        img, img, bh, bwl, bwr)))


def forward_flops(config: dict, hw: Tuple[int, int],
                  channels: int = 1) -> float:
    return 2.0 * sum(m for _, m, _ in serve_macs(config, hw, channels))


def train_step_flops(config: dict, batch: int, crop: Tuple[int, int],
                     channels: int = 1) -> float:
    macs = train_macs(config, batch, crop, channels)
    return 2.0 * sum((3 if grad_in else 2) * m for _, m, grad_in in macs)
