"""The first train steps of a reference system (``reference/__init__.py``)
in plain float32 PyTorch: its feature stage on each crop, the system in
train mode, its loss, the backward and Adam(lr, betas (0.9, 0.999), eps
1e-8) over every parameter of the system, a feature stage's included.

``steps`` returns each step's loss, each parameter's gradient norm at the
first step and each parameter's change after the last, by the system's
state_dict name, all in float64, and the first step's disparity.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import torch


def steps(system: torch.nn.Module, state_dict, batches: Sequence[dict],
          lr: float, n: int,
          wrap: Optional[Callable[[torch.nn.Module], None]] = None) -> Dict:
    """``n`` train steps of ``system`` from ``state_dict`` over
    ``batches[:n]`` (on the system's device); ``wrap`` may change the
    system's convolutions in place (the control)."""
    device = next(system.parameters()).device
    system.load_state_dict(state_dict)
    system.train()
    if wrap is not None:
        wrap(system)
    params = dict(system.named_parameters())
    start = {k: p.detach().double().clone() for k, p in params.items()}
    opt = torch.optim.Adam(params.values(), lr=lr, betas=(0.9, 0.999),
                           eps=1e-8)
    losses, grad = [], {}
    for k in range(n):
        b = batches[k]
        geo = (b["board_h"], b["board_w_left"], b["board_w_right"])
        iml, imr = (torch.from_numpy(b[s]).to(device) for s in ("iml", "imr"))
        feats = system.train_features(iml, imr, *geo)
        target = torch.from_numpy(b["disp"]).to(device)
        opt.zero_grad(set_to_none=True)
        out = system(feats)
        loss = system.loss(out, target)
        loss.backward()
        if k == 0:
            first = system.disparity(out).detach()
            grad = {name: (p.grad.double().norm().item()
                           if p.grad is not None else 0.0)
                    for name, p in params.items()}
        opt.step()
        losses.append(loss.item())
        del feats, loss, out
    change = {k: (p.detach().double() - start[k]).norm().item()
              for k, p in params.items()}
    return {"loss": losses, "grad": grad, "change": change, "disp": first}
