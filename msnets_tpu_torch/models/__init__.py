"""Regularizer models of the port (counterpart of ``msnets_tpu/models``)."""
from __future__ import annotations

from typing import Optional

import torch

from ..config import ModelConfig
from ..runtime import DeviceLike, resolve_device
from .gcnet import MSGCNet
from .layers import fold_batchnorm, soft_argmin

__all__ = ["MSGCNet", "build_model", "fold_batchnorm", "soft_argmin"]


def build_model(model_cfg: ModelConfig, device: DeviceLike = None,
                generator: Optional[torch.Generator] = None) -> MSGCNet:
    """The float32 model of ``model_cfg`` in eval mode on ``device`` (the
    GPU when ``None``), with weights drawn from ``generator`` (a CPU
    generator; the default one when ``None``)."""
    dev = resolve_device(device)
    if model_cfg.name == "MS-PSMNet":
        raise NotImplementedError(
            "MS-PSMNet is not ported yet (ROADMAP queue 1, item 11)")
    if model_cfg.name != "MS-GCNet":
        raise ValueError(f"No suitable model found: {model_cfg.name}")
    if model_cfg.quarter_input:
        raise NotImplementedError("quarter_input (x4 head) is not ported yet")
    if model_cfg.quant_eval:
        raise NotImplementedError("quant_eval (int8) is not ported")
    model = MSGCNet(model_cfg.max_disp, model_cfg.in_channels,
                    model_cfg.base_filters, generator)
    return model.to(dev).eval()
