"""MS-GCNet in NCDHW (counterpart of ``msnets_tpu/models/gcnet.py``).

GCNet-style encoder-decoder regularizer of the 8-channel matching-space
volume (reference GCNet_CostVolumeAggre):

    stem:    2x (conv3d+BN+ReLU)          8 -> F -> F
    encoder: 4x Conv3DBlock stride 2      F -> 2F -> 2F -> 2F -> 4F
    decoder: 4x (deconv3d+BN) with additive skips + ReLU
    head:    ConvTranspose3d(F -> 1, stride 2) restoring full D, H, W,
             softmax over D (float32) and soft-argmin

Submodule names follow the reference checkpoint (``conv3dbn_1.0.weight``,
``block_3d_2.convbn_3d_3.1.running_var``, ``deconv5.bias``, ...), so a
reference state_dict loads as it is and
``msnets_tpu.models.torch_convert.convert_state_dict(port.state_dict(),
"MS-GCNet")`` gives the JAX model the same weights.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import Conv3DBlock, ConvBN3D, DeconvBN3D, he_normal_, soft_argmin


class MSGCNet(nn.Module):
    def __init__(self, max_disp: int = 192, in_channels: int = 8,
                 num_filters: int = 32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        Fn = num_filters
        self.max_disp = max_disp
        self.conv3dbn_1 = ConvBN3D(in_channels, Fn)
        self.conv3dbn_2 = ConvBN3D(Fn, Fn)
        self.block_3d_1 = Conv3DBlock(Fn, 2 * Fn)
        self.block_3d_2 = Conv3DBlock(2 * Fn, 2 * Fn)
        self.block_3d_3 = Conv3DBlock(2 * Fn, 2 * Fn)
        self.block_3d_4 = Conv3DBlock(2 * Fn, 4 * Fn)
        self.deconvbn1 = DeconvBN3D(4 * Fn, 2 * Fn)
        self.deconvbn2 = DeconvBN3D(2 * Fn, 2 * Fn)
        self.deconvbn3 = DeconvBN3D(2 * Fn, 2 * Fn)
        self.deconvbn4 = DeconvBN3D(2 * Fn, Fn)
        # reference deconv5 is a bare ConvTranspose3d (bias=True); the bias
        # shifts every logit equally and cancels in the softmax
        self.deconv5 = nn.ConvTranspose3d(Fn, 1, 3, stride=2, padding=1,
                                          output_padding=1)
        self.reset_parameters(generator)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """He-normal conv and deconv kernels from ``generator``; BN at
        identity; deconv5 bias 0."""
        for m in self.modules():
            if isinstance(m, (nn.Conv3d, nn.ConvTranspose3d)):
                he_normal_(m.weight, m.out_channels, generator)
            elif isinstance(m, nn.BatchNorm3d):
                m.reset_parameters()
        nn.init.zeros_(self.deconv5.bias)

    def forward(self, cv: torch.Tensor) -> torch.Tensor:
        """cv: [N, C, D_in, H_in, W_in] -> disparity [N, 2*H_in, 2*W_in]
        (float32). The head runs in deconv5's dtype, float32 in serving."""
        x = F.relu(self.conv3dbn_1(cv))
        res_l20 = x = F.relu(self.conv3dbn_2(x))
        res_l23 = x = self.block_3d_1(x)
        res_l26 = x = self.block_3d_2(x)
        res_l29 = x = self.block_3d_3(x)
        x = self.block_3d_4(x)
        x = F.relu(self.deconvbn1(x) + res_l29)
        x = F.relu(self.deconvbn2(x) + res_l26)
        x = F.relu(self.deconvbn3(x) + res_l23)
        x = F.relu(self.deconvbn4(x) + res_l20)
        logits = self.deconv5(x.to(self.deconv5.weight.dtype)).squeeze(1)
        return soft_argmin(logits, self.max_disp)
