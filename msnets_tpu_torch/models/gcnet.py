"""MS-GCNet on [N, C, D, H, W] volumes held NDHWC (counterpart of
``msnets_tpu/models/gcnet.py``).

GCNet-style encoder-decoder regularizer of the 8-channel matching-space
volume (reference GCNet_CostVolumeAggre):

    stem:    2x (conv3d+BN+ReLU)          8 -> F -> F
    encoder: 4x Conv3DBlock stride 2      F -> 2F -> 2F -> 2F -> 4F
    decoder: 4x (deconv3d+BN) with additive skips + ReLU
    head:    ConvTranspose3d(F -> 1, stride 2, or 4 with quarter_input)
             restoring full D, H, W, softmax over D (float32) and
             soft-argmin

``quarter_input`` takes a quarter-resolution volume (the reference's
is_quarter_input_size, gcnet_3dcnn.py:88-90): the head is then
ConvTranspose3d(k3, stride 4, padding 1, output_padding 3), which gives D,
H and W times 4; the decoder's last skip is the stem's output either way.

Parameters are float32; ``compute_dtype`` is the dtype of the convolutions
(the input volume and each kernel are cast to it), while BN statistics and
the softmax stay float32: the JAX train step's placement. The volume is
copied into the NDHWC memory format with that cast (``layers.to_ndhwc``)
and every activation keeps it.

The head (``head``, span ``regularizer.head``) takes one of two paths by
what it can observe. Served, in eval mode with gradients off on a plain
tensor whose channels the kernel's plan takes (``subpixel_soft_argmin.
fits``: whole 16-byte copies, at most 64), it is ``ops.cuda.
subpixel_soft_argmin``: deconv5's float32 kernel on the decoder's NDHWC
output, the softmax and the soft-argmin in one pass that never writes the
full-resolution logit volume (the hand-written kernel on the card, its
plain version on the CPU). Otherwise (training, gradients, a ``Sharded``
volume, another width) it is ``layers.conv_head``: deconv5 as a conv with
its output channels padded by zero kernels (``layers.one_channel_conv``,
as cuDNN transposes a one-channel output), in ``compute_dtype`` in train
mode and float32 in eval mode, then ``soft_argmin``: the logits' gradient
and the split softmax over the disp group need the logits. deconv5's bias
stays out of the graph, as in the JAX head (``SubpixelSoftArgminHead``
accepts it and never reads it): it shifts every logit equally and cancels
in the softmax, so leaving it out changes no output, and its gradient is
exactly 0, so Adam leaves it as it is.

With ``remat`` the train forward recomputes every BN'd stage (stem convs,
encoder blocks, decoder deconvs) in the backward, as the JAX model's
``remat`` does (``layers.remat``).

Given a ``parallel.Sharded`` volume, the forward runs over its mesh with
no code of its own, in eval and in train mode: every conv and deconv,
deconv5 included, dispatches to ``parallel/halo.py`` and splits its output
by the layout rule, train BN takes its statistics over the ranks holding
the volume's blocks, ReLU and the skip adds run blockwise, and
``soft_argmin`` reduces over the disp group; the disparity comes out split
over N (data) and H (spatial). The backward runs each collective's
adjoint.

``quant_eval`` flags ``conv3dbn_2`` and, with ``quant_scope="all"``, each
block's entry conv for int8 eval (``quant.py``: which of them run int8
depends on the volume's shape, as under the JAX model's layouts); they
quantize once BN is folded (``fold_batchnorm``), in ``quant_mode``.

Submodule names follow the reference checkpoint (``conv3dbn_1.0.weight``,
``block_3d_2.convbn_3d_3.1.running_var``, ``deconv5.bias``, ...), so a
reference state_dict loads as it is and
``msnets_tpu.models.torch_convert.convert_state_dict(port.state_dict(),
"MS-GCNet")`` gives the JAX model the same weights.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.cuda.subpixel_soft_argmin import fits, subpixel_soft_argmin
from ..ops.features import MatchingStage
from ..parallel import mesh as pm
from ..utils.profiling import span
from .layers import (Conv3DBlock, ConvBN3D, DeconvBN3D, compute_dtype,
                     conv_head, he_normal_, remat, to_ndhwc)
from .quant import NDHWC, QUANT_SCOPES, QuantSite


class MSGCNet(nn.Module):
    # children that serving keeps in float32 (the head)
    FLOAT32_CHILDREN = ("deconv5",)
    STAGE = MatchingStage     # where its volume comes from

    def __init__(self, max_disp: int = 192, in_channels: int = 8,
                 num_filters: int = 32,
                 generator: Optional[torch.Generator] = None,
                 compute_dtype: torch.dtype = torch.float32,
                 remat: bool = False, quarter_input: bool = False,
                 quant_eval: bool = False, quant_mode: str = "dynamic",
                 quant_scope: str = "all"):
        super().__init__()
        Fn = num_filters
        self.max_disp = max_disp
        self.stride = 4 if quarter_input else 2
        self.compute_dtype = compute_dtype
        self.remat = remat
        sites = self.quant_sites(quant_scope)
        q = {s.path: (s, quant_mode) for s in sites} if quant_eval else {}
        self.conv3dbn_1 = ConvBN3D(in_channels, Fn)
        self.conv3dbn_2 = ConvBN3D(Fn, Fn, 1, *q.get("conv3dbn_2", ()))
        widths = [(Fn, 2 * Fn), (2 * Fn, 2 * Fn), (2 * Fn, 2 * Fn),
                  (2 * Fn, 4 * Fn)]
        for i, (cin, cout) in enumerate(widths, 1):
            setattr(self, f"block_3d_{i}", Conv3DBlock(
                cin, cout, 2, *q.get(f"block_3d_{i}.convbn_3d_1", ())))
        self.deconvbn1 = DeconvBN3D(4 * Fn, 2 * Fn)
        self.deconvbn2 = DeconvBN3D(2 * Fn, 2 * Fn)
        self.deconvbn3 = DeconvBN3D(2 * Fn, 2 * Fn)
        self.deconvbn4 = DeconvBN3D(2 * Fn, Fn)
        # reference deconv5 is a bare ConvTranspose3d (bias=True); the bias
        # shifts every logit equally and cancels in the softmax
        s = self.stride
        self.deconv5 = nn.ConvTranspose3d(Fn, 1, 3, stride=s, padding=1,
                                          output_padding=s - 1)
        self.reset_parameters(generator)

    @classmethod
    def from_config(cls, m, generator=None, remat=False, remat_scope="all"):
        """The model of ModelConfig ``m`` (``remat_scope`` is MS-PSMNet's)."""
        return cls(m.max_disp, m.in_channels, m.base_filters, generator,
                   compute_dtype=compute_dtype(m), remat=remat,
                   quarter_input=m.quarter_input, quant_eval=m.quant_eval,
                   quant_mode=m.quant_mode, quant_scope=m.quant_scope)

    @classmethod
    def quant_sites_of(cls, m) -> Tuple[QuantSite, ...]:
        return cls.quant_sites(m.quant_scope)

    @staticmethod
    def quant_sites(quant_scope: str = "all") -> Tuple[QuantSite, ...]:
        """The convs JAX's model flags ``quant`` (``gcnet.py:64-132``): it
        packs on an even D, H and W; ``conv3dbn_2`` is flagged only when it
        packs; the block entries with ``quant_scope`` "all"."""
        if quant_scope not in QUANT_SCOPES:
            raise ValueError(f"quant_scope={quant_scope!r}, expected one of "
                             f"{QUANT_SCOPES}")
        sites = [QuantSite("conv3dbn_2", "packed", 0, True, True)]
        if quant_scope == "all":
            sites += [QuantSite(f"block_3d_{i}.convbn_3d_1",
                                "entry" if i == 1 else "gate", i - 1, True)
                      for i in range(1, 5)]
        return tuple(sites)

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
        """cv: [N, C, D_in, H_in, W_in] -> disparity [N, s*H_in, s*W_in]
        (float32), s the head's stride (2, or 4 with ``quarter_input``)."""
        def stage(module, x):
            return remat(module, x, on=self.remat)

        x = F.relu(stage(self.conv3dbn_1, to_ndhwc(cv, self.compute_dtype)))
        res_l20 = x = F.relu(stage(self.conv3dbn_2, x))
        res_l23 = x = stage(self.block_3d_1, x)
        res_l26 = x = stage(self.block_3d_2, x)
        res_l29 = x = stage(self.block_3d_3, x)
        x = stage(self.block_3d_4, x)
        x = F.relu(stage(self.deconvbn1, x) + res_l29)
        x = F.relu(stage(self.deconvbn2, x) + res_l26)
        x = F.relu(stage(self.deconvbn3, x) + res_l23)
        x = F.relu(stage(self.deconvbn4, x) + res_l20)
        with span("regularizer.head"):
            return self.head(x)

    def head(self, x) -> torch.Tensor:
        """The disparity of the decoder's output ``x`` by deconv5, the
        softmax over D and the soft-argmin, on the path the module
        docstring gives."""
        s = self.stride
        if (self.training or torch.is_grad_enabled()
                or isinstance(x, pm.Sharded) or not fits(x)):
            hd = self.compute_dtype if self.training else torch.float32
            return conv_head(x, self.deconv5.weight, s, self.max_disp, hd)
        # no copy unless an int8 conv (NCDHW) or a batch-1 CPU conv upstream
        # left the decoder output in another layout
        return subpixel_soft_argmin(x.contiguous(memory_format=NDHWC),
                                    self.deconv5.weight, s, self.max_disp)
