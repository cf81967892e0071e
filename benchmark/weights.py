"""Weights of a cell, made on the device from the seed in a few large
calls, in the published state_dict schema (the reference model's, which is
the port's): convolution kernels He-normal, N(0, sqrt(2 / (k^3 * out
channels))) as the published ``net_init``, except the one-channel logit
projections (MS-GCNet's deconv5, MS-PSMNet's classifiers): no ReLU
follows them, and they are drawn as a linear output layer is,
N(0, sqrt(1 / (k^3 * in channels))). At net_init's k^3 * 1 their logits
reach a std of 7 (MS-PSMNet sums three), the soft-argmin becomes an
argmax over noise, and bfloat16 rounding alone moves 10-41% of
MS-PSMNet's pixels by more than 1 px against float32, which leaves the
check nothing to hold; BatchNorm scale 0.5 + U(0, 1),
shift 0.2 N(0, 1), running mean 0.3 N(0, 1), running variance
0.5 + 1.5 U(0, 1), so that folding them is not the identity; biases 0.
All float32, the type the port keeps its parameters in.
"""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn as nn

from .reference import models as RM


def make(model_cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    model = RM.build(model_cfg, "meta")
    normal, uniform = [], []          # (key, shape, scale, offset)
    out: Dict[str, torch.Tensor] = {}
    for mname, mod in model.named_modules():
        p = f"{mname}." if mname else ""
        if isinstance(mod, (nn.Conv3d, nn.ConvTranspose3d)):
            w = mod.weight
            k3 = math.prod(w.shape[2:])
            std = (math.sqrt(1.0 / (k3 * mod.in_channels))
                   if mod.out_channels == 1
                   else math.sqrt(2.0 / (k3 * mod.out_channels)))
            normal.append((p + "weight", w.shape, std, 0.0))
            if mod.bias is not None:
                out[p + "bias"] = torch.zeros(mod.bias.shape, device=device)
        elif isinstance(mod, nn.BatchNorm3d):
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
    order = model.state_dict().keys()
    return {k: out[k] for k in order}
