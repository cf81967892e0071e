"""Engine of the port: losses, the trainer, checkpoints and the evaluator."""
from . import loss  # noqa: F401
from .checkpoint import (AsyncCheckpointer, ckpt_path, load_checkpoint,  # noqa: F401
                         load_weights_any, save_checkpoint, step_ckpt_path)
from .trainer import Trainer, epoch_lr, make_optimizer  # noqa: F401
from .evaluator import Evaluator, dataset_threshold, eval_bad_x  # noqa: F401
