"""Training observability: console lines and TensorBoard summaries (the
port's copy of ``msnets_tpu/utils/summary.py``).

Parity with the reference (main_msnet.py:246-320, 426-435):
  * console: ``===> Epoch[e](i/N): Step s, Loss, EPE, Acu3, s/step, memory``
  * TensorBoard: scalars train_loss / train_err; image grids of the input
    pair, the predicted and GT disparities (jet or KT15 false colour), the
    KT15 log error map, and the per-matcher argmin disparities of the raw
    cost channels (census/ncc/sobel/sad) as a feature-quality probe.

``tensorboardX`` is imported by ``TrainSummaryWriter`` only; a run without
it logs a warning and goes on without summaries (``cli.run_train``).
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from .colormap import jet_color, kt15_error_log_color, kt15_false_color

MATCHERS = ("censusL", "nccL", "sobL", "sadL")


def console_line(epoch: int, iteration: int, steps: int, global_step: int,
                 metrics: Dict[str, float], sec_per_step: float,
                 mem_mb: Optional[float] = None) -> str:
    msg = ("===> Epoch[{}]({}/{}): Step {}, Loss: {:.3f}, EPE: {:.2f}, "
           "Acu3.0: {:.2f}; {:.2f} s/step").format(
        epoch, iteration, steps, global_step,
        metrics["loss"], metrics["epe"], metrics["accu3"], sec_per_step)
    if mem_mb is not None:
        msg += f", memory: {mem_mb:.2f} MB"
    return msg


def process_mem_mb() -> Optional[float]:
    """The process's resident memory in MiB, or None without psutil."""
    try:
        import os
        import psutil
    except ImportError:
        return None
    return psutil.Process(os.getpid()).memory_info()[0] / 2.0 ** 20


class TrainSummaryWriter:
    """TensorBoard writer with the reference's image-grid layout."""

    def __init__(self, logdir: str):
        from tensorboardX import SummaryWriter
        self.w = SummaryWriter(logdir)

    def scalars(self, step: int, loss: float, err: float):
        self.w.add_scalar("train_loss", loss, step)
        self.w.add_scalar("train_err", err, step)

    def images(self, step: int, left_rgb: np.ndarray, right_rgb: np.ndarray,
               disp: np.ndarray, disp_gt: np.ndarray,
               matcher_argmin: Optional[Dict[str, np.ndarray]] = None,
               kt15_color: bool = False):
        """left/right_rgb [N,3,H,W] in [0,1]; disp/disp_gt [N,H,W]."""
        self.w.add_images("train_imgl", left_rgb, step, dataformats="NCHW")
        if right_rgb is not None:
            self.w.add_images("train_imgr", right_rgb, step, dataformats="NCHW")

        def colorize(batch_d):
            if kt15_color:
                frames = [kt15_false_color(d, 256.0) for d in batch_d]
            else:
                mx = max(batch_d.max(), 1e-6)
                frames = [jet_color(d / mx * 255.0) for d in batch_d]
            return np.stack(frames).astype(np.uint8)

        self.w.add_images("train_disp", colorize(disp), step, dataformats="NHWC")
        self.w.add_images("train_dispGT", colorize(disp_gt), step,
                          dataformats="NHWC")
        err = np.stack([kt15_error_log_color(d, g)
                        for d, g in zip(disp, disp_gt)]).astype(np.uint8)
        self.w.add_images("train_dispErr", err, step, dataformats="NHWC")
        if matcher_argmin:
            for name, dm in matcher_argmin.items():
                self.w.add_images(f"train_{name}_disp", colorize(dm), step,
                                  dataformats="NHWC")

    def close(self):
        self.w.close()


def matcher_argmin_from_probe(probe_n4hw: np.ndarray) -> Dict[str, np.ndarray]:
    """{matcher name: argmin disparity [N, H, W]} from the port's probe
    [N, 4, H, W] (``Trainer.matcher_probe_fn``; the JAX package's probe is
    [N, H, W, 4])."""
    return {n: probe_n4hw[:, i] for i, n in enumerate(MATCHERS)}
