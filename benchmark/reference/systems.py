"""The reference systems of MS-Nets (``reference/__init__.py`` names what a
system provides): the classical matching-space feature stage of
``features.py``, which has no weights, before MS-GCNet or MS-PSMNet of
``models.py``, with the published Scene Flow losses (smooth-L1 on
0 < target < max_disp, a masked mean; MS-PSMNet's three heads weighted
0.2, 0.6 and 1.0, main_msnet.py:389-405).
"""
from __future__ import annotations

from typing import Tuple

import torch

from . import features as RF
from . import models as RM


def smooth_l1(pred, target, max_disp: int) -> torch.Tensor:
    mask = (target - max_disp) * target < 0
    d = (pred - target).abs()
    elt = torch.where(d < 1.0, 0.5 * d * d, d - 0.5)
    return torch.where(mask, elt, 0.0).sum() / mask.sum().clamp(min=1)


class MatchingSpace:
    """The 8-channel matching-space volume of a grey pair (``features.py``),
    at half resolution; a train crop carries ``board_h`` rows above and
    below and ``max_disp`` columns on the left."""

    def _matching(self, config: dict) -> None:
        self.matching = dict(config["matching"])

    @classmethod
    def train_margins(cls, config: dict) -> Tuple[int, int, int]:
        return (config["matching"]["board_h"], config["model"]["max_disp"], 0)

    def serve_features(self, left, right) -> torch.Tensor:
        return RF.features_test(left, right, self.max_disp, self.matching)

    def train_features(self, iml, imr, board_h: int, bwl: int,
                       bwr: int) -> torch.Tensor:
        return torch.stack([RF.features_train(a, b, self.max_disp,
                                              self.matching, board_h, bwl, bwr)
                            for a, b in zip(iml, imr)])


class MSGCNet(MatchingSpace, RM.GCNet):
    def __init__(self, config: dict):
        m = config["model"]
        super().__init__(m["max_disp"], m["in_channels"], m["base_filters"])
        self._matching(config)

    def loss(self, disp, target) -> torch.Tensor:
        return smooth_l1(disp, target, self.max_disp)

    def disparity(self, disp) -> torch.Tensor:
        return disp


class MSPSMNet(MatchingSpace, RM.PSMNet):
    def __init__(self, config: dict):
        m = config["model"]
        super().__init__(m["max_disp"], m["in_channels"], m["base_filters"])
        self._matching(config)

    def loss(self, heads, target) -> torch.Tensor:
        d0, d1, d2 = (smooth_l1(h, target, self.max_disp) for h in heads)
        return 0.2 * d0 + 0.6 * d1 + d2

    def disparity(self, heads) -> torch.Tensor:
        return heads[-1]
