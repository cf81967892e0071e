"""Regularizer models of the port (counterpart of ``msnets_tpu/models``)."""
from __future__ import annotations

from typing import Optional, Union

import torch

from ..config import ModelConfig
from ..runtime import DeviceLike, resolve_device
from .gcnet import MSGCNet
from .layers import fold_batchnorm, resize_trilinear_align_corners, soft_argmin
from .psmnet import MSPSMNet

__all__ = ["MSGCNet", "MSPSMNet", "build_model", "compute_dtype",
           "fold_batchnorm", "resize_trilinear_align_corners", "soft_argmin"]


_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def compute_dtype(model_cfg: ModelConfig) -> torch.dtype:
    if model_cfg.compute_dtype not in _DTYPES:
        raise ValueError(f"compute_dtype={model_cfg.compute_dtype!r}")
    return _DTYPES[model_cfg.compute_dtype]


def build_model(model_cfg: ModelConfig, device: DeviceLike = None,
                generator: Optional[torch.Generator] = None,
                remat: bool = False, remat_scope: str = "all"
                ) -> Union[MSGCNet, MSPSMNet]:
    """The model of ``model_cfg`` in eval mode on ``device`` (the GPU when
    ``None``): float32 parameters, convolutions in ``model_cfg``'s compute
    dtype, weights drawn from ``generator`` (a CPU generator; the default
    one when ``None``). ``remat`` and ``remat_scope`` as ``TrainConfig``
    has them (``remat_scope`` applies to MS-PSMNet)."""
    dev = resolve_device(device)
    if model_cfg.name not in ("MS-GCNet", "MS-PSMNet"):
        raise ValueError(f"No suitable model found: {model_cfg.name}")
    if model_cfg.quarter_input:
        raise NotImplementedError("quarter_input (x4 head) is not ported yet")
    if model_cfg.quant_eval:
        raise NotImplementedError("quant_eval (int8) is not ported")
    if model_cfg.name == "MS-PSMNet":
        model = MSPSMNet(model_cfg.max_disp, model_cfg.in_channels,
                         model_cfg.base_filters, 2, generator,
                         compute_dtype(model_cfg), remat, remat_scope)
    else:
        model = MSGCNet(model_cfg.max_disp, model_cfg.in_channels,
                        model_cfg.base_filters, generator,
                        compute_dtype(model_cfg), remat)
    return model.to(dev).eval()
