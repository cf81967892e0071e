"""The first train steps in plain float32 PyTorch: the reference feature
stage on each crop, the reference model in train mode, the published
Scene Flow loss of MS-GCNet (smooth-L1 on 0 < target < max_disp, a masked
mean), the backward and Adam(lr, betas (0.9, 0.999), eps 1e-8).

``steps`` returns each step's loss, each parameter's gradient norm at the
first step and each parameter's change after the last, by state_dict
name, all in float64, and the first step's disparity.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import torch

from . import features as RF
from . import models as RM


def smooth_l1(pred, target, max_disp: int) -> torch.Tensor:
    mask = (target - max_disp) * target < 0
    d = (pred - target).abs()
    elt = torch.where(d < 1.0, 0.5 * d * d, d - 0.5)
    return torch.where(mask, elt, 0.0).sum() / mask.sum().clamp(min=1)


def batch_features(batch: dict, max_disp: int, matching: dict,
                   device) -> torch.Tensor:
    """A batch's crops -> float32 [N, 8, D/2, crop_h/2, crop_w/2]."""
    geo = (batch["board_h"], batch["board_w_left"], batch["board_w_right"])
    out = []
    for a, b in zip(batch["iml"], batch["imr"]):
        out.append(RF.features_train(torch.from_numpy(a).to(device),
                                     torch.from_numpy(b).to(device),
                                     max_disp, matching, *geo))
    return torch.stack(out)


def steps(cfg: dict, state_dict, batches: Sequence[dict], lr: float,
          device, n: int,
          wrap: Optional[Callable[[torch.nn.Module], None]] = None) -> Dict:
    """``n`` train steps from ``state_dict`` over ``batches[:n]``; ``wrap``
    may change the model's convolutions in place (the control)."""
    model_cfg = cfg["model"]
    if model_cfg["name"] != "MS-GCNet":
        raise NotImplementedError("the reference train step covers MS-GCNet")
    max_disp = model_cfg["max_disp"]
    model = RM.build(model_cfg, device)
    model.load_state_dict(state_dict)
    model.train()
    if wrap is not None:
        wrap(model)
    params = dict(model.named_parameters())
    start = {k: p.detach().double().clone() for k, p in params.items()}
    opt = torch.optim.Adam(params.values(), lr=lr, betas=(0.9, 0.999),
                           eps=1e-8)
    losses, grad = [], {}
    for k in range(n):
        b = batches[k]
        feats = batch_features(b, max_disp, cfg["matching"], device)
        target = torch.from_numpy(b["disp"]).to(device)
        opt.zero_grad(set_to_none=True)
        disp = model(feats)
        loss = smooth_l1(disp, target, max_disp)
        loss.backward()
        if k == 0:
            first = disp.detach()
            grad = {name: (p.grad.double().norm().item()
                           if p.grad is not None else 0.0)
                    for name, p in params.items()}
        opt.step()
        losses.append(loss.item())
        del feats, loss, disp
    change = {k: (p.detach().double() - start[k]).norm().item()
              for k, p in params.items()}
    return {"loss": losses, "grad": grad, "change": change, "disp": first}
