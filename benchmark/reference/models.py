"""MS-GCNet and MS-PSMNet in plain float32 PyTorch (NCDHW), with the
published module names, so that one state_dict loads into the reference
and into the port alike.

MS-GCNet (MS-Nets ``src/models/gcnet_3dcnn.py``): a 2-conv stem, four
stride-2 blocks of three conv+BN+ReLU, four deconv+BN stages with additive
skips and a ReLU, a stride-2 transposed conv to one channel at full D, H
and W, softmax over D and the soft-argmin. MS-PSMNet (``psmnet_3dcnn.py``):
dres0, dres1, three hourglasses with their pre/post skips, three
classifiers summed cumulatively, each upsampled (trilinear, corners
aligned) to full size and regressed. Train mode uses the batch's
statistics; eval the running ones (no folding). The reference systems
(``systems.py``) put a feature stage and a loss on these.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F


class ConvBN(nn.Sequential):
    def __init__(self, cin: int, cout: int, stride: int = 1):
        super().__init__(nn.Conv3d(cin, cout, 3, stride, 1, bias=False),
                         nn.BatchNorm3d(cout, eps=1e-5, momentum=0.1))


class DeconvBN(nn.Sequential):
    def __init__(self, cin: int, cout: int):
        super().__init__(nn.ConvTranspose3d(cin, cout, 3, 2, 1, 1, bias=False),
                         nn.BatchNorm3d(cout, eps=1e-5, momentum=0.1))


class Block(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.convbn_3d_1 = ConvBN(cin, cout, 2)
        self.convbn_3d_2 = ConvBN(cout, cout)
        self.convbn_3d_3 = ConvBN(cout, cout)

    def forward(self, x):
        x = F.relu(self.convbn_3d_1(x))
        x = F.relu(self.convbn_3d_2(x))
        return F.relu(self.convbn_3d_3(x))


def soft_argmin(logits: torch.Tensor) -> torch.Tensor:
    """[N, D, H, W] -> [N, H, W]: sum_d d * softmax(logits)_d."""
    p = torch.softmax(logits.float(), dim=1)
    d = torch.arange(logits.shape[1], dtype=torch.float32,
                     device=logits.device).view(1, -1, 1, 1)
    return (p * d).sum(1)


class GCNet(nn.Module):
    def __init__(self, max_disp: int = 192, in_channels: int = 8,
                 base_filters: int = 32):
        super().__init__()
        f = base_filters
        self.max_disp = max_disp
        self.conv3dbn_1 = ConvBN(in_channels, f)
        self.conv3dbn_2 = ConvBN(f, f)
        for i, (a, b) in enumerate([(f, 2 * f), (2 * f, 2 * f),
                                    (2 * f, 2 * f), (2 * f, 4 * f)], 1):
            setattr(self, f"block_3d_{i}", Block(a, b))
        self.deconvbn1 = DeconvBN(4 * f, 2 * f)
        self.deconvbn2 = DeconvBN(2 * f, 2 * f)
        self.deconvbn3 = DeconvBN(2 * f, 2 * f)
        self.deconvbn4 = DeconvBN(2 * f, f)
        self.deconv5 = nn.ConvTranspose3d(f, 1, 3, 2, 1, 1)

    def forward(self, cv):
        x = F.relu(self.conv3dbn_1(cv))
        r20 = x = F.relu(self.conv3dbn_2(x))
        r23 = x = self.block_3d_1(x)
        r26 = x = self.block_3d_2(x)
        r29 = x = self.block_3d_3(x)
        x = self.block_3d_4(x)
        x = F.relu(self.deconvbn1(x) + r29)
        x = F.relu(self.deconvbn2(x) + r26)
        x = F.relu(self.deconvbn3(x) + r23)
        x = F.relu(self.deconvbn4(x) + r20)
        return soft_argmin(self.deconv5(x).squeeze(1))


class Hourglass(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.conv1 = nn.Sequential(ConvBN(c, 2 * c, 2), nn.ReLU())
        self.conv2 = ConvBN(2 * c, 2 * c)
        self.conv3 = nn.Sequential(ConvBN(2 * c, 2 * c, 2), nn.ReLU())
        self.conv4 = nn.Sequential(ConvBN(2 * c, 2 * c), nn.ReLU())
        self.conv5 = DeconvBN(2 * c, 2 * c)
        self.conv6 = DeconvBN(2 * c, c)

    def forward(self, x, presqu: Optional[torch.Tensor],
                postsqu: Optional[torch.Tensor]):
        out = self.conv1(x)
        pre = self.conv2(out)
        pre = F.relu(pre + postsqu if postsqu is not None else pre)
        out = self.conv4(self.conv3(pre))
        post = F.relu(self.conv5(out)
                      + (presqu if presqu is not None else pre))
        return self.conv6(post), pre, post


class Classifier(nn.Sequential):
    def __init__(self, c: int):
        super().__init__(ConvBN(c, c), nn.ReLU(),
                         nn.Conv3d(c, 1, 3, 1, 1, bias=False))


class PSMNet(nn.Module):
    def __init__(self, max_disp: int = 192, in_channels: int = 8,
                 base_filters: int = 32):
        super().__init__()
        f = base_filters
        self.max_disp = max_disp
        self.dres0 = nn.Sequential(ConvBN(in_channels, f), nn.ReLU(),
                                   ConvBN(f, f), nn.ReLU())
        self.dres1 = nn.Sequential(ConvBN(f, f), nn.ReLU(), ConvBN(f, f))
        self.dres2, self.dres3, self.dres4 = (Hourglass(f) for _ in range(3))
        self.classif1, self.classif2, self.classif3 = (Classifier(f)
                                                       for _ in range(3))

    def _regress(self, cost, full):
        up = F.interpolate(cost.float(), size=full, mode="trilinear",
                           align_corners=True)
        return soft_argmin(up.squeeze(1))

    def forward(self, cv):
        _, _, _, H, W = cv.shape
        full = (self.max_disp, 2 * H, 2 * W)
        cost0 = self.dres0(cv)
        cost0 = self.dres1(cost0) + cost0
        out1, pre1, post1 = self.dres2(cost0, None, None)
        out1 = out1 + cost0
        out2, _, post2 = self.dres3(out1, pre1, post1)
        out2 = out2 + cost0
        out3, _, _ = self.dres4(out2, pre1, post2)
        out3 = out3 + cost0
        cost1 = self.classif1(out1)
        cost2 = self.classif2(out2) + cost1
        cost3 = self.classif3(out3) + cost2
        pred3 = self._regress(cost3, full)
        if self.training:
            return self._regress(cost1, full), self._regress(cost2, full), pred3
        return pred3

