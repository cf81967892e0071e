"""Regularizer models of the port (counterpart of ``msnets_tpu/models``).

A model's class owns what it takes in and gives back, so the server and the
trainer never ask which model they run: ``from_config``, ``quant_sites_of``
and ``STAGE(cfg, model)``, its feature stage; ``engine.loss.train_loss``
reads its heads. A new model is its file and a ``_MODELS`` entry.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Union

import torch

from ..config import ModelConfig
from ..runtime import DeviceLike, resolve_device
from .gcnet import MSGCNet
from .gcnet_kendall import GCNet
from .layers import (compute_dtype, fold_batchnorm,
                     resize_trilinear_align_corners, soft_argmin)
from .psmnet import MSPSMNet
from .quant import QUANT_MODES, coverage

__all__ = ["GCNet", "MSGCNet", "MSPSMNet", "build_model", "compute_dtype",
           "fold_batchnorm", "model_class", "quant_convs",
           "resize_trilinear_align_corners", "soft_argmin"]


_MODELS = {"MS-GCNet": MSGCNet, "MS-PSMNet": MSPSMNet, "GC-Net": GCNet}


def model_class(name: str):
    """The class of the model ``name`` (``ModelConfig.name``)."""
    if name not in _MODELS:
        raise ValueError(f"No suitable model found: {name}")
    return _MODELS[name]


def build_model(model_cfg: ModelConfig, device: DeviceLike = None,
                generator: Optional[torch.Generator] = None,
                remat: bool = False, remat_scope: str = "all"
                ) -> Union[MSGCNet, MSPSMNet, GCNet]:
    """The model of ``model_cfg`` (its class's ``from_config``) in eval mode
    on ``device`` (the GPU when ``None``): float32 parameters, convolutions
    in ``model_cfg``'s compute dtype, weights drawn from ``generator`` (a
    CPU generator; the default one when ``None``), ``remat`` and
    ``remat_scope`` as ``TrainConfig`` has them. With
    ``model_cfg.quant_eval`` the convs ``quant_convs`` lists run int8 in
    ``model_cfg.quant_mode`` once the model is folded (``fold_batchnorm``),
    as the server and the evaluator run it; train mode is never quantized
    (``quant.quant_stats``, ``load_quant_stats`` and ``set_quant_mode``
    read and set a folded model's calibration)."""
    dev = resolve_device(device)
    cls = model_class(model_cfg.name)
    if model_cfg.quant_mode not in QUANT_MODES:
        raise ValueError(f"quant_mode={model_cfg.quant_mode!r}, expected "
                         f"one of {QUANT_MODES}")
    return cls.from_config(model_cfg, generator, remat,
                           remat_scope).to(dev).eval()


def quant_convs(model_name: str, model_cfg: ModelConfig,
                volume_shape: Sequence[int]) -> Dict[str, bool]:
    """For each conv the JAX model flags ``quant`` at a volume of
    ``volume_shape`` (``[N, C, D, H, W]``, or its last three dims), whether
    it runs int8 in eval: ``{quant_stats path: bool}`` (``quant.coverage``
    of the model's ``quant_sites_of(model_cfg)``)."""
    return coverage(model_class(model_name).quant_sites_of(model_cfg),
                    volume_shape)
