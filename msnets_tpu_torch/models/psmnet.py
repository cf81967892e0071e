"""MS-PSMNet on [N, C, D, H, W] volumes held NDHWC (counterpart of
``msnets_tpu/models/psmnet.py``).

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
The volume is copied into the NDHWC memory format with the cast to
``compute_dtype`` (``layers.to_ndhwc``) and every activation keeps it; the
classifiers' one-channel convs run with their output channels padded by
zero kernels (``layers.one_channel_conv``), as cuDNN transposes a
one-channel output.
The JAX model's packed layouts exist only for the TPU matrix unit; the port
carries its math.

``remat`` recomputes stages in the backward (``layers.remat``):
``remat_scope="all"`` every BN'd stage (each dres conv, each classifier and
each hourglass conv/deconv stage), ``"hourglass"`` only the hourglass stages.

Given a ``parallel.Sharded`` volume, the forward runs over its mesh, in
eval and in train mode: the convs and deconvs (the classifiers' bare conv3d
too) dispatch to ``parallel/halo.py``, train BN takes its statistics over
the ranks holding each volume's blocks, ``_regress`` gathers the
one-channel cost, upsamples this rank's block of the full volume and
reduces the soft-argmin over the disp group; the three disparities share
one layout. The backward runs each collective's adjoint.

``quant_eval`` flags ``dres0[2]``, ``dres1[0]``, ``dres1[2]`` and each
hourglass's ``conv1`` and ``conv3`` for int8 eval (the JAX quant_stats
paths ``dres0_2``, ``dres1_1``, ``dres1_2``, ``dres2.conv1``, ...;
``quant.py`` says which run int8 at a shape); they quantize once BN is
folded (``fold_batchnorm``), in ``quant_mode``.

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

from ..ops.features import MatchingStage
from .layers import (ConvBN3D, DeconvBN3D, compute_dtype, he_normal_,
                     one_channel_conv, remat, resize_trilinear_align_corners,
                     soft_argmin, to_ndhwc)
from .quant import QuantSite

REMAT_SCOPES = ("all", "hourglass")


class Hourglass(nn.Module):
    """2-level 3-D hourglass (reference psmnet_3dcnn.py:47-89); conv1, conv3
    and conv4 are (convbn, ReLU), conv5 and conv6 deconvbn stages."""

    def __init__(self, c: int, remat: bool = False, quant=None):
        super().__init__()
        q = quant or {}
        self.remat = remat
        self.conv1 = nn.Sequential(ConvBN3D(c, 2 * c, 2, *q.get("conv1", ())),
                                   nn.ReLU())
        self.conv2 = ConvBN3D(2 * c, 2 * c)
        self.conv3 = nn.Sequential(
            ConvBN3D(2 * c, 2 * c, 2, *q.get("conv3", ())), nn.ReLU())
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
        return one_channel_conv(h, self[2].weight)


class MSPSMNet(nn.Module):
    # children that serving keeps in float32: none (the upsample and the
    # softmax cast to float32 themselves)
    FLOAT32_CHILDREN: Tuple[str, ...] = ()
    STAGE = MatchingStage     # where its volume comes from

    @classmethod
    def from_config(cls, m, generator=None, remat=False, remat_scope="all"):
        """The model of ModelConfig ``m``, upscaling by 4 on a quarter
        input."""
        return cls(m.max_disp, m.in_channels, m.base_filters,
                   4 if m.quarter_input else 2, generator, compute_dtype(m),
                   remat, remat_scope, m.quant_eval, m.quant_mode,
                   m.packed_eval_outer)

    @classmethod
    def quant_sites_of(cls, m) -> Tuple[QuantSite, ...]:
        return cls.quant_sites(m.packed_eval_outer)

    @staticmethod
    def quant_sites(packed_eval_outer: bool = True) -> Tuple[QuantSite, ...]:
        """The convs JAX's model flags ``quant`` (``psmnet.py:45-68,
        149-241``): it packs on an even H and W with no D condition;
        ``dres0_2``, ``dres1_1`` and ``dres1_2`` are flagged either way.
        ``dres2.conv1`` reads the packed std volume; ``dres3.conv1`` and
        ``dres4.conv1`` read the packed outer graph with
        ``packed_eval_outer`` (JAX's default) and the full layout without
        it, where only the stride-2 gate makes them int8."""
        sites = [QuantSite(p, "packed") for p in ("dres0_2", "dres1_1",
                                                  "dres1_2")]
        for h in ("dres2", "dres3", "dres4"):
            entry = "entry" if h == "dres2" or packed_eval_outer else "gate"
            sites += [QuantSite(f"{h}.conv1", entry),
                      QuantSite(f"{h}.conv3", "gate", 1)]
        return tuple(sites)

    def __init__(self, max_disp: int = 192, in_channels: int = 8,
                 base_filters: int = 32, upscale: int = 2,
                 generator: Optional[torch.Generator] = None,
                 compute_dtype: torch.dtype = torch.float32,
                 remat: bool = False, remat_scope: str = "all",
                 quant_eval: bool = False, quant_mode: str = "dynamic",
                 packed_eval_outer: bool = True):
        super().__init__()
        if remat_scope not in REMAT_SCOPES:
            raise ValueError(f"remat_scope={remat_scope!r}, expected one of "
                             f"{REMAT_SCOPES}")
        Fn = base_filters
        self.max_disp = max_disp
        self.upscale = upscale
        self.compute_dtype = compute_dtype
        self.remat_outer = remat and remat_scope == "all"
        sites = self.quant_sites(packed_eval_outer)
        q = {s.path: (s, quant_mode) for s in sites} if quant_eval else {}
        self.dres0 = nn.Sequential(ConvBN3D(in_channels, Fn), nn.ReLU(),
                                   ConvBN3D(Fn, Fn, 1, *q.get("dres0_2", ())),
                                   nn.ReLU())
        self.dres1 = nn.Sequential(ConvBN3D(Fn, Fn, 1, *q.get("dres1_1", ())),
                                   nn.ReLU(),
                                   ConvBN3D(Fn, Fn, 1, *q.get("dres1_2", ())))
        for h in ("dres2", "dres3", "dres4"):
            setattr(self, h, Hourglass(Fn, remat, {
                name: q[f"{h}.{name}"] for name in ("conv1", "conv3")
                if f"{h}.{name}" in q}))
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

        x = to_ndhwc(cv, self.compute_dtype)
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
