"""Configuration of the PyTorch/CUDA port.

The port keeps its own copy of the JAX package's configuration
(``msnets_tpu/config.py``), trimmed to the fields its serving path reads.
Field names and defaults are the same, so a reader can move between the two
packages; the classes are frozen dataclasses as there.
"""
from __future__ import annotations

import dataclasses

# float32(RAND_MAX): the sentinel the reference C++ kernels use to mark
# cost-volume entries that were never computed. 2147483647 rounds to
# 2147483648.0 in float32.
INVALID = 2147483648.0


@dataclasses.dataclass(frozen=True)
class MatchingConfig:
    """Matching-space feature-stage hyper-parameters (reference
    ``get_default_args_dict`` defaults)."""
    censw: int = 11          # census window
    nccw: int = 3            # NCC window
    sadw: int = 5            # ZSAD window
    sobelw: int = 5          # SAD-of-Sobel window
    cens_sigma: float = 128.0
    ncc_sigma: float = 0.02
    sad_sigma: float = 20000.0   # also used for the sobel AML channel
    num_channels: int = 8    # 8 (left-only) or 16 (left+right)
    ds_scale: int = 2        # features computed at 1/ds_scale resolution
    features_mode: str = "ms"    # "ms" (matching space) or "raw" (2-channel
                                 # raw-intensity volume, the ablation)

    @property
    def left_only(self) -> bool:
        return self.num_channels == 8

    @property
    def feature_channels(self) -> int:
        """Channels the feature stage emits (the model's in_channels)."""
        return 2 if self.features_mode == "raw" else self.num_channels


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """3-D cost-volume regularizer configuration."""
    name: str = "MS-GCNet"       # "MS-GCNet" | "MS-PSMNet"
    max_disp: int = 192
    in_channels: int = 8
    base_filters: int = 32       # GCNet "F"
    quarter_input: bool = False  # 1/4-resolution input volume (x4 head)
    encoder_ds: int = 32         # eval inputs are padded to a multiple of this
    compute_dtype: str = "bfloat16"   # "bfloat16" or "float32"
    quant_eval: bool = False     # int8 eval (not ported)


@dataclasses.dataclass(frozen=True)
class Config:
    matching: MatchingConfig = dataclasses.field(default_factory=MatchingConfig)
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
