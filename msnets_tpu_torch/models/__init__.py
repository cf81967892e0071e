"""Regularizer models of the port (counterpart of ``msnets_tpu/models``)."""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Union

import torch

from ..config import ModelConfig
from ..runtime import DeviceLike, resolve_device
from .gcnet import MSGCNet
from .layers import fold_batchnorm, resize_trilinear_align_corners, soft_argmin
from .psmnet import MSPSMNet
from .quant import QUANT_MODES, coverage

__all__ = ["MSGCNet", "MSPSMNet", "build_model", "compute_dtype",
           "fold_batchnorm", "quant_convs", "resize_trilinear_align_corners",
           "soft_argmin"]


_MODELS = {"MS-GCNet": MSGCNet, "MS-PSMNet": MSPSMNet}
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
    has them (``remat_scope`` applies to MS-PSMNet). With
    ``model_cfg.quarter_input`` the models take a quarter-resolution volume
    and upsample it 4 times: MS-GCNet's head has stride 4, MS-PSMNet
    upscales by 4.

    With ``model_cfg.quant_eval`` the flagged convs (``quant_convs``
    gives their quant_stats paths and which run int8 at a volume's shape)
    run int8 in ``model_cfg.quant_mode`` once the model is folded
    (``fold_batchnorm``), as the server and the evaluator run it; train
    mode is never quantized. ``quant.quant_stats``, ``load_quant_stats``
    and ``set_quant_mode`` read and set a folded model's calibration."""
    dev = resolve_device(device)
    _model_class(model_cfg.name)
    if model_cfg.quant_mode not in QUANT_MODES:
        raise ValueError(f"quant_mode={model_cfg.quant_mode!r}, expected "
                         f"one of {QUANT_MODES}")
    q = (model_cfg.quant_eval, model_cfg.quant_mode)
    if model_cfg.name == "MS-PSMNet":
        model = MSPSMNet(model_cfg.max_disp, model_cfg.in_channels,
                         model_cfg.base_filters,
                         4 if model_cfg.quarter_input else 2, generator,
                         compute_dtype(model_cfg), remat, remat_scope, *q,
                         model_cfg.packed_eval_outer)
    else:
        model = MSGCNet(model_cfg.max_disp, model_cfg.in_channels,
                        model_cfg.base_filters, generator,
                        compute_dtype(model_cfg), remat,
                        model_cfg.quarter_input, *q, model_cfg.quant_scope)
    return model.to(dev).eval()


def _model_class(name: str):
    if name not in _MODELS:
        raise ValueError(f"No suitable model found: {name}")
    return _MODELS[name]


def quant_convs(model_name: str, model_cfg: ModelConfig,
                volume_shape: Sequence[int]) -> Dict[str, bool]:
    """For each conv the JAX model flags ``quant`` at a volume of
    ``volume_shape`` (``[N, C, D, H, W]``, or its last three dims), whether
    it runs int8 in eval: ``{quant_stats path: bool}`` (``quant.coverage``
    of the model's ``quant_sites``; ``model_cfg.quant_scope`` applies to
    MS-GCNet, ``model_cfg.packed_eval_outer`` to MS-PSMNet)."""
    if _model_class(model_name) is MSPSMNet:
        sites = MSPSMNet.quant_sites(model_cfg.packed_eval_outer)
    else:
        sites = MSGCNet.quant_sites(model_cfg.quant_scope)
    return coverage(sites, volume_shape)
