"""msnets_tpu_torch: the PyTorch/CUDA port of msnets_tpu.

Entry points run on the GPU unless the caller passes ``device="cpu"``.
"""
from .config import (INVALID, Config, DataConfig, EvalConfig, MatchingConfig,
                     ModelConfig, TrainConfig)
from .engine import Evaluator, Trainer
from .models import MSGCNet, MSPSMNet, build_model
from .serve import StereoServer

__all__ = ["INVALID", "Config", "DataConfig", "EvalConfig", "MatchingConfig",
           "ModelConfig", "TrainConfig", "Evaluator", "MSGCNet", "MSPSMNet",
           "Trainer", "build_model", "StereoServer"]
