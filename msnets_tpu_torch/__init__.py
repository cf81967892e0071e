"""msnets_tpu_torch: the PyTorch/CUDA port of msnets_tpu.

Entry points run on the GPU unless the caller passes ``device="cpu"``.
"""
from .config import INVALID, Config, MatchingConfig, ModelConfig
from .models import MSGCNet, build_model
from .serve import StereoServer

__all__ = ["INVALID", "Config", "MatchingConfig", "ModelConfig", "MSGCNet",
           "build_model", "StereoServer"]
