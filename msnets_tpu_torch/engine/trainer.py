"""Trainer: the MS-GCNet and MS-PSMNet train step with the feature stage on
the device (counterpart of ``msnets_tpu/engine/trainer.py``).

One step takes uint8 image crops, computes the matching-space features
(``ms_features_train``, one sample at a time, so one ``census_aml`` launch a
sample for 8 channels or one ``census`` launch for 16), runs the model in
train mode, the loss, the gradients, Adam and the BatchNorm updates.

Where the JAX package carries a ``TrainState`` through a jitted function,
the port's ``Trainer`` owns its state and updates it in place: the model
(float32 parameters and BN statistics), the optimizer and the step count.

Parity elements (reference main_msnet.py):
  * Adam(lr, betas=(0.9, 0.999), eps=1e-8), eps added to sqrt(v_hat) as
    optax and torch both place it; the lr is set on the parameter group at
    every step, as the JAX step injects it;
  * lr for epoch <= 200, then lr * 0.1 (``epoch_lr``);
  * loss per dataset and model (MS-GCNet: smooth-L1, on KITTI 0.4
    smooth-L1 + 0.6 MyLoss2; MS-PSMNet: its three heads weighted 0.2, 0.6
    and 1.0, the last MyLoss2 on KITTI), metrics on the last head;
  * ``remat``: the model recomputes its BN'd stages in the backward
    (``remat_scope`` for MS-PSMNet), each BN's running statistics updated
    once a step;
  * per-step metrics loss, EPE and accu3 on the train mask;
  * ``grad_accum``: sequential micro-batches, gradients summed and divided
    by ``grad_accum``, BN running statistics threaded through in order,
    metrics averaged;
  * checkpoints every epoch (Scene Flow) or every 25 (KITTI), the final one
    always, and mid-epoch step checkpoints every ``ckpt_every_steps``.
"""
from __future__ import annotations

import functools
import pickle
import time
from typing import Callable, Dict, Optional, Tuple

import torch

from ..config import Config
from ..models import build_model, compute_dtype
from ..ops.features import ms_features_train
from ..ops.matchers import _div_const
from ..runtime import DeviceLike, resolve_device
from . import checkpoint as ckpt
from . import loss as L


def make_optimizer(params, lr: float) -> torch.optim.Adam:
    """Adam(lr, betas=(0.9, 0.999), eps=1e-8) (main_msnet.py:192)."""
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)


def epoch_lr(base_lr: float, epoch: int, decay_epoch: int = 200,
             factor: float = 0.1) -> float:
    """main_msnet.py:223-231 (epoch is 1-based)."""
    return base_lr if epoch <= decay_epoch else base_lr * factor


def _as_device(x, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    return torch.as_tensor(x).to(device=device, dtype=dtype)


class Trainer:
    """Owns the model, the optimizer, the step count and the checkpoints.

    ``device=None`` means the GPU and raises without one; weights are drawn
    from a CPU generator seeded with ``seed``."""

    def __init__(self, cfg: Config, device: DeviceLike = None, seed: int = 0):
        t = cfg.train
        if t.grad_accum < 1 or t.batch_size % t.grad_accum:
            raise ValueError(f"batch_size {t.batch_size} is no multiple of "
                             f"grad_accum {t.grad_accum}")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = compute_dtype(cfg.model)
        self.model = build_model(cfg.model, self.device,
                                 torch.Generator().manual_seed(seed),
                                 t.remat, t.remat_scope).train()
        self.optimizer = make_optimizer(self.model.parameters(), t.lr)
        self.step = 0
        self.is_kitti = cfg.data.kitti2012 or cfg.data.kitti2015
        self.is_psmnet = cfg.model.name == "MS-PSMNet"
        self._async_ckpt: Optional[ckpt.AsyncCheckpointer] = None

    # -- state ------------------------------------------------------------
    def feats_shape_for(self, batch_size: int) -> Tuple[int, ...]:
        """[N, C, D, H, W] of a train batch's feature volume."""
        t, m = self.cfg.train, self.cfg.matching
        s = m.ds_scale
        return (batch_size, m.feature_channels, self.cfg.model.max_disp // s,
                t.crop_height // s, t.crop_width // s)

    def state(self) -> Dict:
        """The live training state as ``save_checkpoint`` takes it."""
        return {"state_dict": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict(), "step": self.step}

    # -- the step ---------------------------------------------------------
    def features(self, iml: torch.Tensor, imr: torch.Tensor, board_h: int,
                 bwl: int, bwr: int,
                 dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """uint8 [N, h, w] crops (margins included) on the device -> the
        feature volume [N, C, D, H, W] in ``dtype`` (the compute dtype by
        default); one ``ms_features_train`` per sample."""
        m = self.cfg.matching
        with torch.no_grad():
            return torch.stack([ms_features_train(
                a, b, self.cfg.model.max_disp, m, board_h, bwl, bwr,
                m.left_only, dtype or self.dtype) for a, b in zip(iml, imr)])

    def _micro(self, iml, imr, target, geometry):
        """features -> model -> loss -> gradients (added into .grad) for one
        micro-batch; returns (disparity, metrics)."""
        t, max_disp = self.cfg.train, self.cfg.model.max_disp
        feats = self.features(iml, imr, *geometry)
        mask = L.train_valid_mask(target, max_disp)
        if self.is_psmnet:
            d0, d1, disp = self.model(feats)
            loss = L.psmnet_loss(d0, d1, disp, target, mask, self.is_kitti,
                                 t.loss2_thresh, t.loss2_alpha)
        else:
            disp = self.model(feats)
            loss = L.gcnet_loss(disp, target, mask, self.is_kitti,
                                t.loss2_thresh, t.loss2_alpha)
        loss.backward()
        with torch.no_grad():
            disp = disp.detach()
            metrics = {"loss": loss.detach(), "epe": L.epe(disp, target, mask),
                       "accu3": L.valid_accu3(target, disp, mask)}
        return disp, metrics

    def _step(self, geometry: Tuple[int, int, int], iml, imr, target, lr):
        """uint8 [N, h, w] crops and float32 [N, crop_h, crop_w] targets
        (numpy or tensors), the learning rate -> (metrics, disparity);
        metrics are 0-dim tensors on the device."""
        accum = self.cfg.train.grad_accum
        iml = _as_device(iml, self.device, torch.uint8)
        imr = _as_device(imr, self.device, torch.uint8)
        target = _as_device(target, self.device, torch.float32)
        n = iml.shape[0]
        if n % accum:
            raise ValueError(f"batch {n} is no multiple of grad_accum {accum}")
        m = n // accum
        self.model.train()
        self.optimizer.zero_grad(set_to_none=True)
        outs = [self._micro(iml[k * m:(k + 1) * m], imr[k * m:(k + 1) * m],
                            target[k * m:(k + 1) * m], geometry)
                for k in range(accum)]
        disp = torch.cat([d for d, _ in outs])
        metrics = outs[0][1]
        if accum > 1:
            for p in self.model.parameters():
                if p.grad is not None:
                    p.grad = _div_const(p.grad, accum)
            metrics = {k: torch.stack([ms[k] for _, ms in outs]).mean()
                       for k in metrics}
        for group in self.optimizer.param_groups:
            group["lr"] = float(lr)
        self.optimizer.step()
        self.step += 1
        return metrics, disp

    def step_fn(self, board_h: int, bwl: int, bwr: int) -> Callable:
        """The train step for crops with margins (board_h, bwl, bwr):
        ``(iml, imr, target, lr) -> (metrics, disparity)``."""
        return functools.partial(self._step, (board_h, bwl, bwr))

    def matcher_probe_fn(self, board_h: int, bwl: int, bwr: int) -> Callable:
        """(iml, imr) -> argmin over disparity of the four matching-cost
        channels, float32 [N, 4, H, W]: the reference's feature-quality
        images (main_msnet.py:443-458). Recomputes the feature stage in
        bfloat16, so call it on summary steps only."""
        def probe(iml, imr):
            f = self.features(_as_device(iml, self.device, torch.uint8),
                              _as_device(imr, self.device, torch.uint8),
                              board_h, bwl, bwr, torch.bfloat16)
            return f[:, :4].argmin(dim=2).float()
        return probe

    # -- epoch loop -------------------------------------------------------
    def train_epoch(self, pipeline, epoch: int, log_fn=None,
                    start_iteration: int = 0) -> Dict[str, float]:
        """One epoch from batch ``start_iteration`` (a mid-epoch resume
        replays exactly the batches an uninterrupted epoch would have seen
        from there); returns the epoch's mean metrics and its batch count."""
        t = self.cfg.train
        lr = epoch_lr(t.lr, epoch, t.lr_decay_epoch, t.lr_decay_factor)
        every = t.ckpt_every_steps
        tot = {"loss": 0.0, "epe": 0.0, "accu3": 0.0}
        n = 0
        for i, batch in enumerate(pipeline.epoch(epoch, start_iteration),
                                  start=start_iteration):
            t0 = time.perf_counter()
            fn = self.step_fn(batch["board_h"], batch["board_w_left"],
                              batch["board_w_right"])
            metrics, disp = fn(batch["iml"], batch["imr"], batch["disp"], lr)
            m = {k: float(v) for k, v in metrics.items()}
            dt = time.perf_counter() - t0
            for k in tot:
                tot[k] += m[k]
            n += 1
            if log_fn is not None:
                log_fn(epoch=epoch, iteration=i, metrics=m, sec_per_step=dt,
                       trainer=self, disp=disp, batch=batch)
            if every and (i + 1) % every == 0:
                self.save_step(epoch, i + 1)
        avg = {k: v / max(n, 1) for k, v in tot.items()}
        avg["batches"] = n
        return avg

    # -- checkpointing ----------------------------------------------------
    def _checkpointer(self) -> ckpt.AsyncCheckpointer:
        if self._async_ckpt is None:
            self._async_ckpt = ckpt.AsyncCheckpointer()
        return self._async_ckpt

    def maybe_save(self, epoch: int, avg: Dict[str, float],
                   final: bool = False) -> Optional[str]:
        """The epoch checkpoint when the cadence asks for one (every epoch,
        every ``kitti_ckpt_every`` on KITTI) or ``final``; its path, or
        None."""
        t = self.cfg.train
        cadence_ok = (epoch % t.kitti_ckpt_every == 0) if self.is_kitti else True
        if not (cadence_ok or final):
            return None
        # "batches": how many batches the averages cover (after a mid-epoch
        # resume only the replayed tail)
        meta = {"loss": avg.get("loss"), "epe_err": avg.get("epe"),
                "accu3": avg.get("accu3"), "batches": avg.get("batches")}
        save = (self._checkpointer().save if t.async_ckpt
                else ckpt.save_checkpoint)
        return save(t.checkpoint_dir, self.cfg.model.name, epoch,
                    self.state(), meta=meta)

    def save_step(self, epoch: int, iteration: int) -> str:
        """Mid-epoch checkpoint, always written in the background; its
        sidecar records where to resume."""
        t = self.cfg.train
        return self._checkpointer().save(
            t.checkpoint_dir, self.cfg.model.name, epoch, self.state(),
            meta={"epoch": epoch, "iteration": iteration},
            path=ckpt.step_ckpt_path(t.checkpoint_dir, self.cfg.model.name,
                                     self.step))

    def finish_checkpoints(self) -> None:
        """Wait for every queued checkpoint write (before exiting, or before
        another process resumes from the files)."""
        if self._async_ckpt is not None:
            self._async_ckpt.wait()

    def resume(self, path: str) -> Dict:
        """Restore from one of the port's checkpoints (model, optimizer and
        step, exactly) or load the weights of a reference ``.tar``
        non-strictly (entries whose key and shape match; the optimizer and
        step stay as they are). Returns the checkpoint's sidecar meta."""
        try:
            state, meta = ckpt.load_checkpoint(path)
        except pickle.UnpicklingError:        # not a file the port wrote
            state, meta = None, {}
        if ckpt.is_port_checkpoint(state):
            self.model.load_state_dict(state["state_dict"])
            self.optimizer.load_state_dict(state["optimizer"])
            self.step = int(state["step"])
            return meta
        loaded = ckpt.load_weights_any(path)
        own = self.model.state_dict()
        keep = {k: v for k, v in loaded.items()
                if k in own and tuple(v.shape) == tuple(own[k].shape)}
        self.model.load_state_dict(keep, strict=False)
        return meta
