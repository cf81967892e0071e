"""MS-PSMNet in NCDHW (counterpart of ``msnets_tpu/models/psmnet.py``).

PSMNet-style stacked-hourglass regularizer of the matching-space volume, the
intended reference PSMNet_CostVolumeAggre (8-channel input, upsample sized
from the volume):

    dres0: 2x (conv3d+BN+ReLU)                 in_ch -> F -> F
    dres1: conv3d+BN+ReLU, conv3d+BN, + cost0  (no ReLU before the add)
    3 hourglasses with pre/post skip wiring, each output + cost0
    3 classifiers, conv3d+BN+ReLU then conv3d(F -> 1, no bias), summed
      cumulatively (cost2 += cost1, cost3 += cost2)
    float32 trilinear upsample (align_corners) to (max_disp, H*upscale,
      W*upscale), softmax over D and soft-argmin per head

Train mode returns (pred1, pred2, pred3), eval pred3. Parameters are float32;
convolutions, the hourglasses and the classifiers run in ``compute_dtype``,
BN statistics, the upsample and the softmax in float32, as in the JAX model.
The JAX model's packed layouts exist only for the TPU matrix unit; the port
carries its math.

``remat`` recomputes stages in the backward (``layers.remat``):
``remat_scope="all"`` every BN'd stage (each dres conv, each classifier and
each hourglass conv/deconv stage), ``"hourglass"`` only the hourglass stages.

Submodule names follow the reference checkpoint (``dres0.0.0.weight``,
``dres2.conv1.0.0.weight``, ``dres2.conv5.1.running_var``,
``classif1.0.1.weight``, ``classif1.2.weight``, ...), so
``msnets_tpu.models.torch_convert.convert_state_dict(port.state_dict(),
"MS-PSMNet")`` gives the JAX model the same weights.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import (ConvBN3D, DeconvBN3D, he_normal_, remat,
                     resize_trilinear_align_corners, soft_argmin)

REMAT_SCOPES = ("all", "hourglass")


class Hourglass(nn.Module):
    """2-level 3-D hourglass (reference psmnet_3dcnn.py:47-89); conv1, conv3
    and conv4 are (convbn, ReLU), conv5 and conv6 deconvbn stages."""

    def __init__(self, c: int, remat: bool = False):
        super().__init__()
        self.remat = remat
        self.conv1 = nn.Sequential(ConvBN3D(c, 2 * c, 2), nn.ReLU())
        self.conv2 = ConvBN3D(2 * c, 2 * c)
        self.conv3 = nn.Sequential(ConvBN3D(2 * c, 2 * c, 2), nn.ReLU())
        self.conv4 = nn.Sequential(ConvBN3D(2 * c, 2 * c), nn.ReLU())
        self.conv5 = DeconvBN3D(2 * c, 2 * c)
        self.conv6 = DeconvBN3D(2 * c, c)

    def forward(self, x: torch.Tensor, presqu: Optional[torch.Tensor],
                postsqu: Optional[torch.Tensor]):
        def stage(module, x):
            return remat(module, x, on=self.remat)

        out = stage(self.conv1, x)
        pre = stage(self.conv2, out)
        pre = F.relu(pre + postsqu if postsqu is not None else pre)
        out = stage(self.conv4, stage(self.conv3, pre))
        post = F.relu(stage(self.conv5, out)
                      + (presqu if presqu is not None else pre))
        return stage(self.conv6, post), pre, post


class _Classifier(nn.Sequential):
    """convbn + ReLU, then a bias-free conv3d(F -> 1) in the input's dtype
    (reference psmnet_3dcnn.py:111-121)."""

    def __init__(self, c: int):
        super().__init__(ConvBN3D(c, c), nn.ReLU(),
                         nn.Conv3d(c, 1, 3, padding=1, bias=False))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(self[0](x))
        return F.conv3d(h, self[2].weight.to(h.dtype), None, 1, 1)


class MSPSMNet(nn.Module):
    # children that serving keeps in float32: none (the upsample and the
    # softmax cast to float32 themselves)
    FLOAT32_CHILDREN: Tuple[str, ...] = ()

    def __init__(self, max_disp: int = 192, in_channels: int = 8,
                 base_filters: int = 32, upscale: int = 2,
                 generator: Optional[torch.Generator] = None,
                 compute_dtype: torch.dtype = torch.float32,
                 remat: bool = False, remat_scope: str = "all"):
        super().__init__()
        if remat_scope not in REMAT_SCOPES:
            raise ValueError(f"remat_scope={remat_scope!r}, expected one of "
                             f"{REMAT_SCOPES}")
        Fn = base_filters
        self.max_disp = max_disp
        self.upscale = upscale
        self.compute_dtype = compute_dtype
        self.remat_outer = remat and remat_scope == "all"
        self.dres0 = nn.Sequential(ConvBN3D(in_channels, Fn), nn.ReLU(),
                                   ConvBN3D(Fn, Fn), nn.ReLU())
        self.dres1 = nn.Sequential(ConvBN3D(Fn, Fn), nn.ReLU(),
                                   ConvBN3D(Fn, Fn))
        self.dres2 = Hourglass(Fn, remat)
        self.dres3 = Hourglass(Fn, remat)
        self.dres4 = Hourglass(Fn, remat)
        self.classif1 = _Classifier(Fn)
        self.classif2 = _Classifier(Fn)
        self.classif3 = _Classifier(Fn)
        self.reset_parameters(generator)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """He-normal conv and deconv kernels from ``generator``; BN at
        identity."""
        for m in self.modules():
            if isinstance(m, (nn.Conv3d, nn.ConvTranspose3d)):
                he_normal_(m.weight, m.out_channels, generator)
            elif isinstance(m, nn.BatchNorm3d):
                m.reset_parameters()

    def _regress(self, cost: torch.Tensor, full: Tuple[int, int, int]
                 ) -> torch.Tensor:
        """[N, 1, D_in, H_in, W_in] -> float32 upsample to ``full`` ->
        disparity [N, H, W]."""
        up = resize_trilinear_align_corners(cost.float(), full)
        return soft_argmin(up.squeeze(1), self.max_disp)

    def forward(self, cv: torch.Tensor):
        """cv: [N, C, D_in, H_in, W_in] -> train: (pred1, pred2, pred3),
        eval: pred3, each [N, H_in*upscale, W_in*upscale] float32."""
        def stage(module, x):
            return remat(module, x, on=self.remat_outer)

        x = cv.to(self.compute_dtype)
        _, _, _, H, W = x.shape
        full = (self.max_disp, H * self.upscale, W * self.upscale)
        h = F.relu(stage(self.dres0[0], x))
        cost0 = F.relu(stage(self.dres0[2], h))
        h = F.relu(stage(self.dres1[0], cost0))
        cost0 = stage(self.dres1[2], h) + cost0

        out1, pre1, post1 = self.dres2(cost0, None, None)
        out1 = out1 + cost0
        out2, _, post2 = self.dres3(out1, pre1, post1)
        out2 = out2 + cost0
        out3, _, _ = self.dres4(out2, pre1, post2)
        out3 = out3 + cost0

        cost1 = stage(self.classif1, out1)
        cost2 = stage(self.classif2, out2) + cost1
        cost3 = stage(self.classif3, out3) + cost2
        pred3 = self._regress(cost3, full)
        if self.training:
            return self._regress(cost1, full), self._regress(cost2, full), pred3
        return pred3
