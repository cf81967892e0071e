"""Weights of a cell, made on the device from the seed in a few large
calls, in the state_dict schema of the configuration's reference system
(``reference/__init__.py``), which is the port's: every convolution of the
system, of any rank, transposed or not, and every BatchNorm of any rank,
in the order of ``named_modules``.

Convolution kernels are He-normal, N(0, sqrt(2 / (k * out channels))) with
k the kernel's taps, as the published ``net_init``, except the one-channel
logit projections before the softmax over disparity: no ReLU follows them,
and they are drawn as a linear output layer is,
N(0, sqrt(1 / (k * in channels))). At net_init's k * 1 their logits
reach a std of 7 (more where heads are summed), the soft-argmin becomes
an argmax over noise, and bfloat16 rounding alone moves 10-41% of the
stacked-hourglass model's pixels by more than 1 px against float32, which
leaves the check nothing to hold; BatchNorm scale 0.5 + U(0, 1),
shift 0.2 N(0, 1), running mean 0.3 N(0, 1), running variance
0.5 + 1.5 U(0, 1), so that folding them is not the identity; biases 0.
All float32, the type the port keeps its parameters in.
"""
from __future__ import annotations

import math
from typing import Dict

import torch
from torch.nn.modules.batchnorm import _BatchNorm
from torch.nn.modules.conv import _ConvNd

from . import reference


def make(config: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The seed's state_dict of ``config``'s reference system."""
    system = reference.build(config, "meta")
    normal, uniform = [], []          # (key, shape, scale, offset)
    out: Dict[str, torch.Tensor] = {}
    for mname, mod in system.named_modules():
        p = f"{mname}." if mname else ""
        if isinstance(mod, _ConvNd):
            w = mod.weight
            k = math.prod(w.shape[2:])
            std = (math.sqrt(1.0 / (k * mod.in_channels))
                   if mod.out_channels == 1
                   else math.sqrt(2.0 / (k * mod.out_channels)))
            normal.append((p + "weight", w.shape, std, 0.0))
            if mod.bias is not None:
                out[p + "bias"] = torch.zeros(mod.bias.shape, device=device)
        elif isinstance(mod, _BatchNorm):
            c = (mod.num_features,)
            uniform.append((p + "weight", c, 1.0, 0.5))
            normal.append((p + "bias", c, 0.2, 0.0))
            normal.append((p + "running_mean", c, 0.3, 0.0))
            uniform.append((p + "running_var", c, 1.5, 0.5))
            out[p + "num_batches_tracked"] = torch.zeros(
                (), dtype=torch.long, device=device)
    g = torch.Generator(device=device).manual_seed(int(seed))
    for specs, draw in ((normal, torch.randn), (uniform, torch.rand)):
        total = sum(math.prod(s) for _, s, _, _ in specs)
        flat = draw(total, generator=g, device=device)
        at = 0
        for key, shape, scale, offset in specs:
            n = math.prod(shape)
            out[key] = flat[at:at + n].view(shape) * scale + offset
            at += n
    return {k: out[k] for k in system.state_dict().keys()}
