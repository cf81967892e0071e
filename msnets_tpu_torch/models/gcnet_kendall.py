"""GC-Net (Kendall et al., "End-to-End Learning of Geometry and Context for
Deep Stereo Regression", ICCV 2017, arXiv:1703.04309, Table 1): a learned
unary tower on RGB, the concat volume, and MS-GCNet's regularizer.

    unary:  L1     5x5 conv 3 -> F, stride 2, BN, ReLU
            L2-17  8 residual blocks of two 3x3 conv F -> F:
                   y = x + relu(bn(conv(relu(bn(conv(x))))))
            L18    3x3 conv F -> F with a bias, no BN or ReLU
    volume: ``ops.volume.concat_volume`` of the two views' maps,
            [N, 2F, max_disp / 2, H / 2, W / 2]
    then ``MSGCNet`` unchanged (the MS-Nets regularizer at ``in_channels``
    2F), deconv5, softmax over max_disp and the soft-argmin.

The input is uint8 RGB [N, H, W, 3], scaled to [0, 1] and normalised by
ImageNet's mean and std per channel (after the server's bucket pad), in
float32, then cast to the compute dtype. Both views go through the tower
in one batched call, so that train BN takes its statistics over the 2N
images. The tower's convs compute in the compute dtype and its BNs keep
float32 statistics (``layers.ConvBN2D``); eval folds them
(``fold_batchnorm``) and the server casts them (``cast_eval_model``).

``features(left, right)`` gives the volume (spans ``features.unary`` and
``features.volume``; the caller's ``features`` span around both);
``forward(volume)`` is MS-GCNet's; ``TowerStage`` is ``features`` as the
server and the trainer take a feature stage. State_dict keys are
``unary.*`` (``conv1.{0,1}``, ``blocks.{i}.convbn_{1,2}.{0,1}``,
``conv_out``) and MS-GCNet's own.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.volume import concat_volume
from ..utils.profiling import span
from .gcnet import MSGCNet
from .layers import ConvBN2D, he_normal_

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
BLOCKS = 8          # residual blocks, L2-L17


class ResBlock2D(nn.Module):
    """y = x + relu(bn(conv3x3(relu(bn(conv3x3(x))))))."""

    def __init__(self, channels: int):
        super().__init__()
        self.convbn_1 = ConvBN2D(channels, channels)
        self.convbn_2 = ConvBN2D(channels, channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + F.relu(self.convbn_2(F.relu(self.convbn_1(x))))


class UnaryTower(nn.Module):
    """GC-Net's unary features, L1-L18: normalised RGB [N, 3, H, W] ->
    [N, F, H/2, W/2] in the input's dtype."""

    def __init__(self, filters: int = 32):
        super().__init__()
        self.conv1 = ConvBN2D(3, filters, 5, 2)
        self.blocks = nn.Sequential(*(ResBlock2D(filters)
                                      for _ in range(BLOCKS)))
        self.conv_out = nn.Conv2d(filters, filters, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.blocks(F.relu(self.conv1(x)))
        conv = self.conv_out
        return F.conv2d(x, conv.weight.to(x.dtype), conv.bias.to(x.dtype),
                        padding=1)


class TowerStage:
    """GC-Net's stage (``ops.features.MatchingStage`` answers the same):
    RGB pairs, the model's own ``features``, crops with no margins. It
    trains on one device (the tower's BN has no statistics across ranks)
    and has no matching-cost channels to probe."""
    pixel = (3,)
    pairs = "RGB [H, W, 3]"
    over_mesh = probes = False

    @staticmethod
    def channels(matching) -> int:
        return 2 * 32       # 2F, F = 32 (arXiv:1703.04309, Table 1)

    def __init__(self, cfg, model: "GCNet"):
        self.model = model

    def serve(self, iml: torch.Tensor, imr: torch.Tensor) -> torch.Tensor:
        return self.model.features(iml[None], imr[None])[0]

    def train(self, iml, imr, board_h: int, bwl: int, bwr: int,
              dtype=None) -> torch.Tensor:
        if (board_h, bwl, bwr) != (0, 0, 0):
            raise ValueError(
                f"GC-Net takes crops with no margins, got "
                f"(board_h, bwl, bwr) = {(board_h, bwl, bwr)}")
        return self.model.features(iml, imr)


class GCNet(MSGCNet):
    """GC-Net: ``UnaryTower`` and the concat volume before MS-GCNet's
    regularizer (module docstring). The tower is ``in_channels / 2`` wide
    (F); the rest as ``MSGCNet`` takes it."""
    STAGE = TowerStage

    def __init__(self, max_disp: int = 192, in_channels: int = 64,
                 num_filters: int = 32,
                 generator: Optional[torch.Generator] = None, **kw):
        if in_channels % 2:
            raise ValueError(f"GC-Net: in_channels {in_channels} is not "
                             "even: the volume holds both views' features")
        super().__init__(max_disp, in_channels, num_filters, generator, **kw)
        self.unary = UnaryTower(in_channels // 2)
        for m in self.unary.modules():
            if isinstance(m, nn.Conv2d):
                he_normal_(m.weight, m.out_channels, generator)
        nn.init.zeros_(self.unary.conv_out.bias)
        self.register_buffer("mean", torch.tensor(IMAGENET_MEAN).view(
            1, 3, 1, 1), persistent=False)
        self.register_buffer("std", torch.tensor(IMAGENET_STD).view(
            1, 3, 1, 1), persistent=False)

    def features(self, left: torch.Tensor, right: torch.Tensor
                 ) -> torch.Tensor:
        """uint8 RGB [N, H, W, 3] views -> the concat volume
        [N, in_channels, max_disp / 2, H / 2, W / 2] in the compute
        dtype."""
        if left.shape != right.shape or left.dim() != 4 or left.shape[-1] != 3:
            raise ValueError(f"GC-Net takes uint8 RGB [N, H, W, 3] views, got "
                             f"{tuple(left.shape)} and {tuple(right.shape)}")
        with span("features.unary"):
            x = torch.cat([left, right]).permute(0, 3, 1, 2).float() / 255.0
            x = (x - self.mean) / self.std
            fl, fr = self.unary(x.to(self.compute_dtype)).chunk(2)
        with span("features.volume"):
            return concat_volume(fl, fr, self.max_disp // 2)
