"""Configuration of the PyTorch/CUDA port.

The port keeps its own copy of the JAX package's configuration
(``msnets_tpu/config.py``): the matching, model, train and data settings and
the run mode. Field names and defaults are the same, so a reader can move
between the two packages; the classes are frozen dataclasses as there. The
JAX package's TPU-only model fields (packed lowerings, int8 modes) and its
mesh settings are not carried; ``Config.from_json`` skips them.
"""
from __future__ import annotations

import dataclasses
import json

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
    # kept for parity with the reference's arguments; the sobel AML channel
    # uses sad_sigma, as the reference does
    sobel_sigma: float = 20000.0
    num_channels: int = 8    # 8 (left-only) or 16 (left+right)
    board_h: int = 12        # vertical margin cropped off train samples
    ds_scale: int = 2        # features computed at 1/ds_scale resolution
    sf_frames_type: str = "frames_finalpass"
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
class TrainConfig:
    """Trainer settings (reference main_msnet.py arguments and do_main_msnet.sh)."""
    crop_height: int = 256
    crop_width: int = 512
    batch_size: int = 2
    lr: float = 1e-3
    lr_decay_epoch: int = 200     # lr * lr_decay_factor after this epoch
    lr_decay_factor: float = 0.1
    epochs: int = 10
    start_epoch: int = 0
    seed: int = 1234
    num_workers: int = 4
    log_summary_step: int = 40
    kitti_ckpt_every: int = 25    # KITTI saves every N epochs, Scene Flow every one
    loss2_thresh: float = 3.0     # GCNet KITTI loss: 0.4*smoothL1 + 0.6*MyLoss2
    loss2_alpha: float = 2.0
    checkpoint_dir: str = "./checkpoints"
    train_logdir: str = "./logs"
    resume: str = ""
    # recompute each BN'd stage in the backward (torch.utils.checkpoint)
    # instead of keeping its activations; MS-PSMNet's remat_scope: "all"
    # (dres, classifiers and hourglass stages) or "hourglass" (only those)
    remat: bool = False
    remat_scope: str = "all"
    # sequential micro-batches per step (batch_size % grad_accum == 0):
    # gradients summed and divided by grad_accum, BN stats threaded through
    grad_accum: int = 1
    num_hosts: int = 1            # input sharding: host_id takes
    host_id: int = 0              # perm[host_id::num_hosts] of each epoch
    async_ckpt: bool = True       # epoch saves written by a background thread
    ckpt_every_steps: int = 0     # mid-epoch step checkpoints every N steps


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Dataset selection and paths (reference dataset flags and lists)."""
    data_path: str = ""
    training_list: str = "lists/sceneflow_train.list"
    test_list: str = "lists/sceneflow_test_small.list"
    kitti2012: bool = False
    kitti2015: bool = False
    eth3d: bool = False
    middlebury: bool = False

    @property
    def dataset(self) -> str:
        if self.kitti2012:
            return "kitti2012"
        if self.kitti2015:
            return "kitti2015"
        if self.eth3d:
            return "eth3d"
        if self.middlebury:
            return "middlebury"
        return "sceneflow"

    @property
    def bad_threshold(self) -> float:
        """Per-dataset bad-tau threshold (main_msnet.py:598-605)."""
        if self.kitti2012 or self.kitti2015:
            return 3.0
        return 1.0


@dataclasses.dataclass(frozen=True)
class EvalConfig:
    """Evaluator outputs (reference main_msnet.py:533-648)."""
    result_dir: str = "./results"
    threshold: float = 3.0       # eval-badx's threshold; test takes the dataset's
    save_pfm: bool = True
    save_color: bool = True


def _known(cls, d: dict) -> dict:
    """The entries of ``d`` that are fields of ``cls``."""
    names = {f.name for f in dataclasses.fields(cls)}
    return {k: v for k, v in d.items() if k in names}


@dataclasses.dataclass(frozen=True)
class Config:
    matching: MatchingConfig = dataclasses.field(default_factory=MatchingConfig)
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    eval: EvalConfig = dataclasses.field(default_factory=EvalConfig)
    mode: str = "train"   # train | loop-train | test | val-30 | cross-val | eval-badx

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @staticmethod
    def from_json(s: str) -> "Config":
        """A ``Config`` from ``to_json``'s text, or from the JAX package's:
        fields the port does not carry are skipped."""
        d = json.loads(s)
        return Config(
            matching=MatchingConfig(**_known(MatchingConfig, d.get("matching", {}))),
            model=ModelConfig(**_known(ModelConfig, d.get("model", {}))),
            train=TrainConfig(**_known(TrainConfig, d.get("train", {}))),
            data=DataConfig(**_known(DataConfig, d.get("data", {}))),
            eval=EvalConfig(**_known(EvalConfig, d.get("eval", {}))),
            mode=d.get("mode", "train"),
        )
