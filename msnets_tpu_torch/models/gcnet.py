"""MS-GCNet in NCDHW (counterpart of ``msnets_tpu/models/gcnet.py``).

GCNet-style encoder-decoder regularizer of the 8-channel matching-space
volume (reference GCNet_CostVolumeAggre):

    stem:    2x (conv3d+BN+ReLU)          8 -> F -> F
    encoder: 4x Conv3DBlock stride 2      F -> 2F -> 2F -> 2F -> 4F
    decoder: 4x (deconv3d+BN) with additive skips + ReLU
    head:    ConvTranspose3d(F -> 1, stride 2) restoring full D, H, W,
             softmax over D (float32) and soft-argmin

Parameters are float32; ``compute_dtype`` is the dtype of the convolutions
(the input volume and each kernel are cast to it), while BN statistics and
the softmax stay float32: the JAX train step's placement. The head runs in
``compute_dtype`` in train mode and in float32 in eval mode (the server's
float32 head). deconv5's bias stays out of the graph, as in the JAX head
(``SubpixelSoftArgminHead`` accepts it and never reads it): it shifts every
logit equally and cancels in the softmax, so leaving it out changes no
output, and its gradient is exactly 0, so Adam leaves it as it is.

With ``remat`` the train forward recomputes every BN'd stage (stem convs,
encoder blocks, decoder deconvs) in the backward, as the JAX model's
``remat`` does (``layers.remat``).

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

from .layers import (Conv3DBlock, ConvBN3D, DeconvBN3D, he_normal_, remat,
                     soft_argmin)


class MSGCNet(nn.Module):
    # children that serving keeps in float32 (the head)
    FLOAT32_CHILDREN = ("deconv5",)

    def __init__(self, max_disp: int = 192, in_channels: int = 8,
                 num_filters: int = 32,
                 generator: Optional[torch.Generator] = None,
                 compute_dtype: torch.dtype = torch.float32,
                 remat: bool = False):
        super().__init__()
        Fn = num_filters
        self.max_disp = max_disp
        self.compute_dtype = compute_dtype
        self.remat = remat
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
        (float32)."""
        def stage(module, x):
            return remat(module, x, on=self.remat)

        x = F.relu(stage(self.conv3dbn_1, cv.to(self.compute_dtype)))
        res_l20 = x = F.relu(stage(self.conv3dbn_2, x))
        res_l23 = x = stage(self.block_3d_1, x)
        res_l26 = x = stage(self.block_3d_2, x)
        res_l29 = x = stage(self.block_3d_3, x)
        x = stage(self.block_3d_4, x)
        x = F.relu(stage(self.deconvbn1, x) + res_l29)
        x = F.relu(stage(self.deconvbn2, x) + res_l26)
        x = F.relu(stage(self.deconvbn3, x) + res_l23)
        x = F.relu(stage(self.deconvbn4, x) + res_l20)
        hd = self.compute_dtype if self.training else torch.float32
        logits = F.conv_transpose3d(x.to(hd), self.deconv5.weight.to(hd),
                                    None, stride=2, padding=1,
                                    output_padding=1).squeeze(1)
        return soft_argmin(logits, self.max_disp)
