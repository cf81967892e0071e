"""The reference system of GC-Net (Kendall et al., "End-to-End Learning of
Geometry and Context for Deep Stereo Regression", ICCV 2017,
arXiv:1703.04309, Table 1) with the MS-Nets regularizer
(``reference/__init__.py`` names what a system provides), in plain float32
PyTorch; it imports nothing of the port.

  * unary features, one tower for both views, which go through it as one
    batch (train BN over the 2N images): L1 a 5x5 conv 3 -> F at stride 2
    (padding 2), BN, ReLU; L2-L17 8 residual blocks
    y = x + relu(bn(conv3x3(relu(bn(conv3x3(x)))))); L18 a 3x3 conv F -> F
    with a bias; F is ``in_channels`` / 2. Convs have no bias unless said;
    BN eps 1e-5, momentum 0.1.
    The input is uint8 RGB scaled to [0, 1] and normalised by ImageNet's
    mean and std per channel, after the bucket pad;
  * the concat volume [N, 2F, max_disp / 2, H / 2, W / 2], built with a
    loop over d: at disparity d the left map's columns x >= d and the
    right map's columns x - d, zeros where x < d;
  * ``models.GCNet`` (MS-GCNet's regularizer, MS-Nets
    ``src/models/gcnet_3dcnn.py``) at ``in_channels`` 2F, its soft-argmin
    over max_disp, and smooth-L1 over 0 < target < max_disp.

Module names follow the port's (``unary.conv1``, ``unary.blocks.<i>.
convbn_<j>``, ``unary.conv_out``), so one state_dict loads into both.
A train crop has no margins.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from . import models as RM
from .systems import smooth_l1

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)


def _convbn(cin: int, cout: int, kernel: int, stride: int = 1):
    return nn.Sequential(nn.Conv2d(cin, cout, kernel, stride, kernel // 2,
                                   bias=False),
                         nn.BatchNorm2d(cout, eps=1e-5, momentum=0.1))


class Residual(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.convbn_1 = _convbn(c, c, 3)
        self.convbn_2 = _convbn(c, c, 3)

    def forward(self, x):
        return x + F.relu(self.convbn_2(F.relu(self.convbn_1(x))))


class Unary(nn.Module):
    def __init__(self, filters: int):
        super().__init__()
        self.conv1 = _convbn(3, filters, 5, 2)
        self.blocks = nn.Sequential(*(Residual(filters) for _ in range(8)))
        self.conv_out = nn.Conv2d(filters, filters, 3, 1, 1)

    def forward(self, x):
        return self.conv_out(self.blocks(F.relu(self.conv1(x))))


class GCNetKendall(RM.GCNet):
    def __init__(self, config: dict):
        m = config["model"]
        super().__init__(m["max_disp"], m["in_channels"], m["base_filters"])
        self.unary = Unary(m["in_channels"] // 2)

    @classmethod
    def train_margins(cls, config: dict):
        return (0, 0, 0)

    def _volume(self, iml, imr) -> torch.Tensor:
        """uint8 [N, H, W, 3] views -> [N, 2F, max_disp / 2, H/2, W/2], in
        the parameters' dtype (float32; float64 where a test asks)."""
        dtype = self.unary.conv_out.weight.dtype
        x = torch.cat([iml, imr]).permute(0, 3, 1, 2).to(dtype) / 255.0
        mean = torch.tensor(MEAN, device=x.device).view(1, 3, 1, 1)
        std = torch.tensor(STD, device=x.device).view(1, 3, 1, 1)
        fl, fr = self.unary((x - mean) / std).chunk(2)
        W = fl.shape[-1]
        return torch.stack([torch.cat([F.pad(fl[..., d:], (d, 0)),
                                       F.pad(fr[..., :W - d], (d, 0))], 1)
                            for d in range(self.max_disp // 2)], 2)

    def serve_features(self, left, right) -> torch.Tensor:
        return self._volume(left[None], right[None])[0]

    def train_features(self, iml, imr, board_h: int, bwl: int,
                       bwr: int) -> torch.Tensor:
        return self._volume(iml, imr)

    def loss(self, disp, target) -> torch.Tensor:
        return smooth_l1(disp, target, self.max_disp)

    def disparity(self, disp) -> torch.Tensor:
        return disp
