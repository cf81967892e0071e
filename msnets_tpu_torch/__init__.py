"""msnets_tpu_torch: the PyTorch/CUDA port of msnets_tpu.

Entry points run on the GPU unless the caller passes ``device="cpu"``.
"""
from .config import (INVALID, Config, DataConfig, MatchingConfig, ModelConfig,
                     TrainConfig)
from .engine import Trainer
from .models import MSGCNet, build_model
from .serve import StereoServer

__all__ = ["INVALID", "Config", "DataConfig", "MatchingConfig", "ModelConfig",
           "TrainConfig", "MSGCNet", "Trainer", "build_model", "StereoServer"]
