"""Evaluator: the test / val-30 / cross-val / eval-badx task modes
(counterpart of ``msnets_tpu/engine/evaluator.py``).

Parity with the reference test loop (reference main_msnet.py:533-648) and
offline re-scoring (main_msnet.py:655-706):
  * per-dataset bad-tau threshold: ETH3D 1.0, Middlebury 1.0, KITTI 3.0,
    Scene Flow 1.0 (main_msnet.py:598-605);
  * frames padded top and right to a multiple of ``encoder_ds``
    (``TestPipeline``), un-padded as disp[crop_h - h : crop_h, 0 : w]
    (main_msnet.py:585-589);
  * results: resultDir/<name>.pfm for the named datasets, every 50th frame
    for Scene Flow (main_msnet.py:593), and colour PNGs under dispColor/ and
    errDispColor/ through the KITTI colorizers (main_msnet.py:621-642);
  * averages over the frames that have ground truth, with a warning that
    names the frames without.

Each frame runs through ``StereoServer.forward`` (features then model, in
``cfg.model.compute_dtype``, BN folded), the same graph ``predict`` runs.
"""
from __future__ import annotations

import os
from os.path import join as pjoin
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from ..config import Config
from ..data import pfm as pfmio
from ..data import resolvers
from ..data.pipeline import TestPipeline
from ..runtime import DeviceLike
from ..serve import StereoServer
from ..utils.colormap import kt15_error_log_color, kt15_false_color
from . import loss as L


def dataset_threshold(data_cfg) -> float:
    if data_cfg.eth3d or data_cfg.middlebury:
        return 1.0
    if data_cfg.kitti2012 or data_cfg.kitti2015:
        return 3.0
    return 1.0


def _epe_rate(disp_gt: np.ndarray, disp: np.ndarray, max_disp: int,
              threshold: float):
    e, r = L.epe_rate(torch.from_numpy(disp_gt), torch.from_numpy(disp),
                      max_disp, threshold)
    return float(e), float(r)


class Evaluator:
    """Scores the frames of ``cfg.data.test_list`` with the weights of
    ``state_dict`` on ``device`` (the GPU when ``None``)."""

    def __init__(self, cfg: Config, state_dict: Mapping[str, torch.Tensor],
                 device: DeviceLike = None):
        if cfg.model.quant_eval:
            raise NotImplementedError(
                "quant_eval (int8) is not ported (ROADMAP queue 1, item 14)")
        self.cfg = cfg
        self.server = StereoServer(cfg, state_dict, device=device)

    def _forward(self, iml: np.ndarray, imr: np.ndarray) -> np.ndarray:
        """A padded uint8 pair -> disparity [1, crop_h, crop_w]."""
        dev = self.server.device
        disp = self.server.forward(torch.from_numpy(iml).to(dev),
                                   torch.from_numpy(imr).to(dev))
        return disp.cpu().numpy()

    def run(self, log=print) -> Dict[str, float]:
        cfg = self.cfg
        os.makedirs(cfg.eval.result_dir, exist_ok=True)
        pipe = TestPipeline(cfg.data, cfg.matching, cfg.model.encoder_ds)
        threshold = dataset_threshold(cfg.data)
        named_ds = any([cfg.data.kitti2012, cfg.data.kitti2015,
                        cfg.data.eth3d, cfg.data.middlebury])
        avg_err = avg_rate = 0.0
        n_gt = 0
        missing_gt = []
        for it, s in enumerate(pipe):
            disp = self._forward(s.iml, s.imr)          # [1, crop_h, crop_w]
            disp = disp[0, s.crop_height - s.height:s.crop_height, :s.width]
            disp = np.ascontiguousarray(disp, dtype=np.float32)

            save_name = pjoin(cfg.eval.result_dir,
                              resolvers.result_name(cfg.data.dataset, s.entry, it))
            if cfg.eval.save_pfm and (named_ds or it % 50 == 0):
                os.makedirs(os.path.dirname(save_name) or ".", exist_ok=True)
                pfmio.write_pfm(save_name, disp)

            disp_gt = None
            if s.disp_path and os.path.isfile(s.disp_path):
                disp_gt = pfmio.read_pfm(s.disp_path)
                disp_gt[disp_gt == np.inf] = 0.0
            else:
                missing_gt.append(s.entry)
            if disp_gt is not None:
                e, r = _epe_rate(disp_gt, disp, cfg.model.max_disp, threshold)
                avg_err += e
                avg_rate += r
                n_gt += 1
                if it % 5 == 0:
                    log(f"===> Frame {it}: {s.entry} ==> EPE: {e:.4f}, "
                        f"Bad-{threshold:.1f}: {r:.4f}")

            if cfg.eval.save_color and named_ds:
                self._save_colors(save_name, disp, disp_gt)

        out = {}
        if missing_gt:
            # averages are over the frames actually scored: dividing by
            # len(pipe) would deflate EPE and bad rate on a list with missing
            # GT (reference lists always have GT, main_msnet.py:643-647)
            log(f"WARNING: {len(missing_gt)} of {len(pipe)} frames have no GT "
                f"and were excluded from the averages: "
                f"{', '.join(missing_gt[:10])}"
                + (" ..." if len(missing_gt) > 10 else ""))
        if n_gt:
            out = {"avg_epe": avg_err / n_gt, "avg_bad": avg_rate / n_gt,
                   "threshold": threshold, "frames": n_gt}
            log(f"===> Total {n_gt} Frames ==> AVG EPE: {out['avg_epe']:.4f}, "
                f"AVG Bad-{threshold:.1f}: {out['avg_bad']:.4f}")
        return out

    def _save_colors(self, save_name: str, disp: np.ndarray,
                     disp_gt: Optional[np.ndarray]):
        import cv2
        base = os.path.basename(save_name)[:-4] + ".png"
        d = pjoin(self.cfg.eval.result_dir, "dispColor")
        os.makedirs(d, exist_ok=True)
        cv2.imwrite(pjoin(d, base),
                    kt15_false_color(disp).astype(np.uint8)[:, :, ::-1])
        if disp_gt is not None:
            d = pjoin(self.cfg.eval.result_dir, "errDispColor")
            os.makedirs(d, exist_ok=True)
            cv2.imwrite(pjoin(d, base),
                        kt15_error_log_color(disp, disp_gt).astype(np.uint8)[:, :, ::-1])


def eval_bad_x(cfg: Config, log=print) -> Dict[str, float]:
    """Offline re-scoring of saved PFMs against GT (main_msnet.py:655-706):
    each frame's PFM is looked up in ``result_dir``, then in
    ``result_dir/disp-pfm``; scored at ``cfg.eval.threshold``. KITTI only
    in the reference; here any dataset whose GT paths resolve."""
    entries = resolvers.load_list(cfg.data.test_list)
    threshold = cfg.eval.threshold
    avg_err = avg_rate = 0.0
    for entry in entries:
        paths = resolvers.resolve(cfg.data.dataset, cfg.data.data_path, entry)
        disp_gt = pfmio.read_pfm(paths[2])
        disp_gt[disp_gt == np.inf] = 0.0
        name = resolvers.result_name(cfg.data.dataset, entry, 0)
        save = pjoin(cfg.eval.result_dir, name)
        if not os.path.isfile(save):
            save = pjoin(cfg.eval.result_dir, "disp-pfm", name)
        disp = pfmio.read_pfm(save)
        e, r = _epe_rate(disp_gt, disp, cfg.model.max_disp, threshold)
        avg_err += e
        avg_rate += r
    n = len(entries)
    out = {"avg_epe": avg_err / n, "avg_bad": avg_rate / n, "frames": n}
    log(f"===> Total {n} Frames ==> AVG EPE: {out['avg_epe']:.4f}, "
        f"AVG Bad-{threshold:.1f}: {out['avg_bad']:.4f}")
    return out
