"""Losses and metrics (counterpart of ``msnets_tpu/engine/loss.py``).

  * smooth-L1 with beta=1 (reference main_msnet.py:391);
  * ``my_loss2``, the GANet-style robust loss, in the JAX package's clean
    piecewise form (see its docstring);
  * valid masks: train (gt - max_disp) * gt < 0, eval 0.001 <= gt <= max_disp;
  * metrics: EPE, bad-tau rate, accu3.

Every reduction is a masked mean, sum / max(count, 1): an empty mask gives 0,
not the NaN of ``F.smooth_l1_loss(x[mask], y[mask])``. Divisions by
constants are reciprocal multiplies, as XLA compiles the JAX functions
(``ops.matchers._div_const``); the division by the count stays a division.

Over a mesh (the data axis alone included) the disparity, the target and
the mask are ``parallel.Sharded`` blocks of one layout (N over data, H over
spatial): the elementwise arithmetic runs blockwise, and a masked mean is a
rank's share of the global one, the block's sum over the count all-reduced
over the ranks that hold the blocks (``Sharded.group``). The losses and
metrics are linear in these means, so their sums over the ranks are the
global values. The disparity is whole along the disp axis, so of the ranks
that hold the same block only one counts it (``Sharded.owner``): the
others' term is 0 times theirs, which keeps their backward, and its
collectives, in step.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..ops.matchers import _div_const
from ..parallel.mesh import Sharded, all_reduce_sum


def masked_mean(x, mask) -> torch.Tensor:
    """sum(x[mask]) / max(count, 1). On ``Sharded`` values and mask (split
    alike) the count is the global one, all-reduced (no gradient) over the
    ranks holding the blocks: each rank returns its block's sum over the
    global count, and these terms summed over the ranks are the global
    masked mean; a rank that is not its block's owner returns 0 times its
    term."""
    if isinstance(x, Sharded):
        if (mask.shape, mask.spec) != (x.shape, x.spec):
            raise ValueError(f"mask {mask.spec} of {tuple(mask.shape)} for "
                             f"values {x.spec} of {tuple(x.shape)}")
        cnt = all_reduce_sum(mask.local.sum(), x.group).clamp(min=1)
        term = torch.where(mask.local, x.local, 0.0).sum() / cnt
        return term if x.owner else term * 0.0
    return torch.where(mask, x, 0.0).sum() / mask.sum().clamp(min=1)


def train_valid_mask(gt: torch.Tensor, max_disp: int) -> torch.Tensor:
    """0 < gt < max_disp (main_msnet.py:382)."""
    return (gt - max_disp) * gt < 0


def eval_valid_mask(gt: torch.Tensor, max_disp: int) -> torch.Tensor:
    """0.001 <= gt <= max_disp (main_msnet.py:709)."""
    return (gt >= 0.001) & (gt <= max_disp)


def smooth_l1(pred: torch.Tensor, target: torch.Tensor,
              mask: torch.Tensor) -> torch.Tensor:
    d = (pred - target).abs()
    elt = torch.where(d < 1.0, 0.5 * d * d, d - 0.5)
    return masked_mean(elt, mask)


def my_loss2(pred: torch.Tensor, target: torch.Tensor, mask: torch.Tensor,
             thresh: float = 3.0, alpha: float = 2.0) -> torch.Tensor:
    """GANet robust loss (reference loss.py:26-36), masked mean: t^2/thresh
    below thresh, 2t - (t-thresh)^2/(2 alpha) - thresh up to thresh+alpha,
    t + alpha/2 above.

    Deliberate divergence, as in the JAX package: the reference mutates its
    temporary in place, so values that cross thresh+alpha inside the middle
    branch also get the final ``+= alpha/2``. Its hand-written backward
    ignores that, so the gradients equal this clean form's; only the
    reported loss differs."""
    t = (pred - target).abs()
    low = _div_const(t * t, thresh)
    mid = t * 2.0 - _div_const((t - thresh) ** 2, 2.0 * alpha) - thresh
    high = t + alpha / 2.0
    elt = torch.where(t < thresh, low,
                      torch.where(t <= thresh + alpha, mid, high))
    return masked_mean(elt, mask)


def gcnet_loss(disp: torch.Tensor, target: torch.Tensor, mask: torch.Tensor,
               is_kitti: bool, thresh: float = 3.0,
               alpha: float = 2.0) -> torch.Tensor:
    """MS-GCNet loss (main_msnet.py:389-395)."""
    l0 = smooth_l1(disp, target, mask)
    if is_kitti:
        return 0.4 * l0 + 0.6 * my_loss2(disp, target, mask, thresh, alpha)
    return l0


def psmnet_loss(disp0, disp1, disp2, target, mask, is_kitti: bool,
                thresh: float = 3.0, alpha: float = 2.0) -> torch.Tensor:
    """MS-PSMNet 3-head loss 0.2/0.6/1.0 (main_msnet.py:396-405)."""
    l0 = smooth_l1(disp0, target, mask)
    l1 = smooth_l1(disp1, target, mask)
    if is_kitti:
        l2 = my_loss2(disp2, target, mask, thresh, alpha)
    else:
        l2 = smooth_l1(disp2, target, mask)
    return 0.2 * l0 + 0.6 * l1 + l2


def disparity(out):
    """A model's disparity: the last of its train heads, or its one map."""
    return out[-1] if isinstance(out, tuple) else out


def train_loss(out, target, mask, is_kitti: bool, thresh: float = 3.0,
               alpha: float = 2.0):
    """A model's train output -> (loss, disparity): three heads (MS-PSMNet)
    take ``psmnet_loss``, one map (MS-GCNet, GC-Net) ``gcnet_loss``."""
    heads = out if isinstance(out, tuple) else (out,)
    loss = psmnet_loss if len(heads) == 3 else gcnet_loss
    return loss(*heads, target, mask, is_kitti, thresh, alpha), heads[-1]


def valid_accu3(target, pred, mask, thred: float = 3.0) -> torch.Tensor:
    """Fraction of valid pixels with |err| <= thred (reference loss.py:17-21)."""
    return masked_mean(((target - pred).abs() <= thred).float(), mask)


def epe(pred, target, mask) -> torch.Tensor:
    return masked_mean((pred - target).abs(), mask)


def epe_rate(gt, pred, max_disp: int,
             threshold: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(EPE, bad-tau rate) on the eval mask (main_msnet.py:708-713)."""
    mask = eval_valid_mask(gt, max_disp)
    err = (pred - gt).abs()
    return (masked_mean(err, mask),
            masked_mean((err > threshold).float(), mask))
