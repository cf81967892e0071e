"""Trainer: the MS-GCNet and MS-PSMNet train step with the feature stage on
the device (counterpart of ``msnets_tpu/engine/trainer.py``).

One step takes uint8 image crops, computes the matching-space features
(``ms_features_train``, one sample at a time, so one ``census_aml`` launch a
sample for 8 channels or one ``census`` launch for 16), runs the model in
train mode, the loss, the gradients, Adam and the BatchNorm updates. In a
profiler's trace (``utils.profiling.span``) a step is ``trainer.step``
around ``trainer.h2d``, ``features``, ``regularizer.forward``,
``trainer.loss``, ``regularizer.backward``, ``trainer.metrics``,
``trainer.allreduce`` (over a group) and ``trainer.optimizer``.

A model with a learned feature stage (GC-Net, ``models.learned_features``)
takes uint8 RGB crops [N, h, w, 3] with no margins (0, 0, 0) and computes
its volume with gradient inside the micro-batch (``GCNet.features``: spans
``features.unary``, ``features.volume``); the tower trains with the
regularizer, and its backward, the volume's (span
``features.volume_backward``) aside, runs inside ``regularizer.backward``.
It trains on one device: over a group or a mesh the tower's BN would need
its statistics across ranks, which the port does not have, so the
``Trainer`` refuses it there.

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

Over a ``(data, spatial, disp)`` mesh (``mesh``, from
``parallel.make_mesh``; the JAX Trainer's ``mesh``) the step is the JAX step
on the global batch, written as collectives on volumes split by JAX's
layout rule (``parallel/mesh.py``, its share rule). A process ``group``
alone is the mesh of the data axis only (``parallel.data_mesh``):
  * ``batch_size`` is the global batch; the ranks of one data index take
    the same ``batch_size // data`` samples a step, and micro-batch k is
    rows [k*m, (k+1)*m) of every data index's share (m = batch_size //
    (data * grad_accum)): the global micro-batch k is data index 0's micro
    k, index 1's, and so on;
  * every rank computes the feature volume of its data share (the
    ``census_aml`` or ``census`` launches of those samples) and keeps its
    block (``shard_volume``, a slice); the model runs on the block, its
    convs exchanging halos; the target and the mask are sliced to the
    disparity's layout;
  * train BN takes its statistics over the global micro-batch, and the
    masked means and the soft-argmin reduce over the ranks that hold each
    volume's blocks (``models/layers.py``, ``engine/loss.py``); the
    backward runs every collective's adjoint;
  * after the micro-batches one all-reduce over the whole world sums every
    gradient, flattened into one buffer, then the division by
    ``grad_accum``; no 1/W factor (the gradient of the global loss;
    ``DistributedDataParallel`` would average). Parameters, Adam state and
    BN statistics stay equal on every rank;
  * the metrics are the global batch's (the ranks' terms summed); the
    returned disparity is this rank's data share, whole in H;
  * the parameters and buffers are broadcast from rank 0 at construction;
  * only rank 0 writes checkpoints; ``finish_checkpoints`` ends with a
    barrier.
"""
from __future__ import annotations

import functools
import pickle
import time
from typing import Callable, Dict, Optional, Tuple

import torch

from ..config import Config
from ..models import build_model, compute_dtype, learned_features
from ..ops.features import ms_features_train
from ..ops.matchers import _div_const
from ..parallel import mesh as pm
from ..runtime import DeviceLike, resolve_device
from ..utils.profiling import span
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


METRICS = ("loss", "epe", "accu3")


class Trainer:
    """Owns the model, the optimizer, the step count and the checkpoints.

    ``device=None`` means the GPU and raises without one; weights are drawn
    from a CPU generator seeded with ``seed``. With a ``mesh`` the trainer
    is one rank of the step over that mesh, with a process ``group`` one
    rank of the step over the group's data-only mesh (module docstring);
    every rank constructs its trainer and takes its steps in the same
    order."""

    def __init__(self, cfg: Config, device: DeviceLike = None, seed: int = 0,
                 group=None, mesh: Optional[pm.Mesh] = None):
        t = cfg.train
        if group is not None and mesh is not None:
            raise ValueError("give a Trainer a group or a mesh, not both")
        if mesh is None:
            mesh = pm.data_mesh(group)
        data = mesh.size("data") if mesh is not None else 1
        if t.grad_accum < 1 or t.batch_size % (data * t.grad_accum):
            raise ValueError(
                f"--batchSize {t.batch_size} is no multiple of {data} ranks "
                f"(the --mesh data size) x --grad_accum {t.grad_accum}")
        if cfg.model.quarter_input:
            raise NotImplementedError(
                "quarter_input: the x4 head wants a quarter-resolution "
                "volume, but the train feature stage makes half-resolution "
                "ones (ds_scale 1 or 2 only), so its output would be twice "
                "the target's size. The JAX Trainer fails the same way "
                "(MS-GCNet's depth assertion at init, MS-PSMNet's loss "
                "shapes at the first step)")
        self.learned = learned_features(cfg.model)
        if self.learned and mesh is not None:
            raise NotImplementedError(
                f"{cfg.model.name} trains on one device: its learned tower's "
                "BatchNorm has no statistics across ranks, so a group or a "
                "mesh is refused")
        self.cfg = cfg
        self.mesh, self.data = mesh, data
        self.group = mesh.group if mesh is not None else None
        self.rank = pm.group_rank(self.group)
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
        pm.broadcast_module(self.model, self.group)

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
        default); one ``ms_features_train`` per sample. A learned stage
        takes uint8 RGB [N, h, w, 3] crops with no margins and gives its
        volume in the compute dtype, with the graph to its weights (when
        gradients are enabled)."""
        if self.learned:
            if (board_h, bwl, bwr) != (0, 0, 0):
                raise ValueError(
                    f"{self.cfg.model.name} takes crops with no margins, got "
                    f"(board_h, bwl, bwr) = {(board_h, bwl, bwr)}")
            with span("features"):
                return self.model.features(iml, imr)
        m = self.cfg.matching
        with torch.no_grad(), span("features"):
            return torch.stack([ms_features_train(
                a, b, self.cfg.model.max_disp, m, board_h, bwl, bwr,
                m.left_only, dtype or self.dtype) for a, b in zip(iml, imr)])

    def _micro(self, iml, imr, target, geometry):
        """features -> model -> loss -> gradients (added into .grad) for one
        micro-batch; returns (disparity, metrics)."""
        t, max_disp = self.cfg.train, self.cfg.model.max_disp
        feats = self.features(iml, imr, *geometry)
        if self.mesh is not None:
            feats = pm.shard_volume(feats, self.mesh)
        with span("regularizer.forward"):
            out = self.model(feats)
        disp = out[-1] if self.is_psmnet else out
        if self.mesh is not None:
            target = pm.shard_volume(target, self.mesh, disp.spec)
        with span("trainer.loss"):
            mask = L.train_valid_mask(target, max_disp)
            if self.is_psmnet:
                loss = L.psmnet_loss(*out, target, mask, self.is_kitti,
                                     t.loss2_thresh, t.loss2_alpha)
            else:
                loss = L.gcnet_loss(disp, target, mask, self.is_kitti,
                                    t.loss2_thresh, t.loss2_alpha)
        with span("regularizer.backward"):
            loss.backward()
        with torch.no_grad(), span("trainer.metrics"):
            disp = disp.detach()
            metrics = {"loss": loss.detach(), "epe": L.epe(disp, target, mask),
                       "accu3": L.valid_accu3(target, disp, mask)}
            if self.mesh is not None:
                disp = pm.gather_volume(disp)
        return disp, metrics

    def _all_reduce_grads(self) -> None:
        """Sum every gradient over the group in one all-reduce of one flat
        buffer (parameters without a gradient stay out, on every rank)."""
        grads = [p.grad for p in self.model.parameters() if p.grad is not None]
        flat = pm.all_reduce_sum(torch.cat([g.reshape(-1) for g in grads]),
                                 self.group)
        for g, r in zip(grads, flat.split([g.numel() for g in grads])):
            g.copy_(r.view_as(g))

    def _step(self, geometry: Tuple[int, int, int], iml, imr, target, lr):
        """uint8 [N, h, w] crops and float32 [N, crop_h, crop_w] targets
        (numpy or tensors; N is this rank's share of the batch), the
        learning rate -> (metrics, disparity); metrics are 0-dim tensors on
        the device, those of the global batch."""
        with span("trainer.step"):
            accum = self.cfg.train.grad_accum
            with span("trainer.h2d"):
                iml = _as_device(iml, self.device, torch.uint8)
                imr = _as_device(imr, self.device, torch.uint8)
                target = _as_device(target, self.device, torch.float32)
            n = iml.shape[0]
            if n % accum:
                raise ValueError(
                    f"batch {n} is no multiple of grad_accum {accum}")
            m = n // accum
            self.model.train()
            with span("trainer.optimizer"):
                self.optimizer.zero_grad(set_to_none=True)
            outs = [self._micro(iml[k * m:(k + 1) * m],
                                imr[k * m:(k + 1) * m],
                                target[k * m:(k + 1) * m], geometry)
                    for k in range(accum)]
            with span("trainer.metrics"):
                # [accum, metric]: each rank's terms, summed into the
                # global ones
                per_micro = pm.all_reduce_sum(
                    torch.stack([torch.stack([ms[k] for k in METRICS])
                                 for _, ms in outs]), self.group)
                means = per_micro[0] if accum == 1 else per_micro.mean(0)
                metrics = dict(zip(METRICS, means.unbind()))
            if self.group is not None:
                with span("trainer.allreduce"):
                    self._all_reduce_grads()
            disp = torch.cat([d for d, _ in outs])
            with span("trainer.optimizer"):
                if accum > 1:
                    for p in self.model.parameters():
                        if p.grad is not None:
                            p.grad = _div_const(p.grad, accum)
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
        bfloat16, so call it on summary steps only. A learned stage has no
        matching-cost channels, so it is refused."""
        if self.learned:
            raise ValueError(f"{self.cfg.model.name} has a learned feature "
                             "stage: there are no matching-cost channels "
                             "to probe")

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
        if self.rank != 0:          # every rank holds the same state
            return ckpt.ckpt_path(t.checkpoint_dir, self.cfg.model.name, epoch)
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
        path = ckpt.step_ckpt_path(t.checkpoint_dir, self.cfg.model.name,
                                   self.step)
        if self.rank != 0:
            return path
        return self._checkpointer().save(
            t.checkpoint_dir, self.cfg.model.name, epoch, self.state(),
            meta={"epoch": epoch, "iteration": iteration}, path=path)

    def finish_checkpoints(self, barrier: bool = True) -> None:
        """Wait for every queued checkpoint write (before exiting, or before
        another process resumes from the files); then, with ``barrier``, for
        every rank, so that none resumes from a file still being written
        (pass False on an error path, where the other ranks may be gone)."""
        if self._async_ckpt is not None:
            self._async_ckpt.wait()
        if barrier:
            pm.barrier(self.group)

    def resume(self, path: str) -> Dict:
        """Restore from one of the port's checkpoints (model, optimizer and
        step, exactly), from a JAX ``.msgpack`` (``_resume_jax``), or load
        the weights of a reference ``.tar`` non-strictly (entries whose key
        and shape match; the optimizer and step stay as they are). Every
        rank loads the same file. Returns the checkpoint's sidecar meta."""
        if ckpt.is_jax_checkpoint(path):
            return self._resume_jax(path)
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

    def _resume_jax(self, path: str) -> Dict:
        """Weights, BN statistics, Adam's moments and the step of a JAX
        Trainer's ``.msgpack``; the meta (epoch, iteration) from its
        sidecar. When its optimizer state does not map onto torch's Adam
        the moments start anew, as for a reference ``.tar``."""
        state, meta = ckpt.load_jax_checkpoint(path, self.cfg.model.name)
        self.model.load_state_dict(state["state_dict"])
        if state["adam"] is not None:
            index = {name: i for i, (name, _) in
                     enumerate(self.model.named_parameters())}
            sd = self.optimizer.state_dict()
            sd["state"] = {index[k]: v for k, v in state["adam"].items()}
            self.optimizer.load_state_dict(sd)
        self.step = state["step"]
        return meta
