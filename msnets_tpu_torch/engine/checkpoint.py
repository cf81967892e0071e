"""Checkpoints with the reference's epoch-addressable names (counterpart of
``msnets_tpu/engine/checkpoint.py``).

Files are ``checkpoint_dir/<model>/model_epoch_%05d.tar`` (every epoch save),
``model_step_%08d.tar`` (mid-epoch step saves) and a ``model_best.tar`` copy,
in the reference's schema ``{epoch, state_dict, optimizer, loss, epe_err,
accu3}`` (reference main_msnet.py:210-221) plus the port's ``step`` and a
``format`` tag. ``state_dict`` has the reference checkpoint's keys, so a
reference ``.tar`` and the port's own load alike (``load_weights_any``).
Beside each file a sidecar ``.json`` holds ``{"epoch", **meta}`` (for a step
save, the ``iteration`` to resume at).

Both files are written atomically (tmp + ``os.replace``), the sidecar first:
a crash in between leaves a sidecar without a checkpoint (nothing resumes a
missing file), never a resumable checkpoint whose meta is missing.
"""
from __future__ import annotations

import io
import json
import os
import queue
import shutil
import threading
from os.path import join as pjoin
from typing import Any, Dict, List, Optional, Tuple

import torch

FORMAT = "msnets_tpu_torch/1"
META_KEYS = ("loss", "epe_err", "accu3")


def ckpt_path(checkpoint_dir: str, model_name: str, epoch: int) -> str:
    return pjoin(checkpoint_dir, model_name, f"model_epoch_{epoch:05d}.tar")


def step_ckpt_path(checkpoint_dir: str, model_name: str, step: int) -> str:
    """Mid-epoch checkpoint name; its sidecar carries {epoch, iteration}."""
    return pjoin(checkpoint_dir, model_name, f"model_step_{step:08d}.tar")


def _atomic_write(path: str, data: bytes) -> None:
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _map_tensors(fn, obj):
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if isinstance(obj, dict):
        return type(obj)((k, _map_tensors(fn, v)) for k, v in obj.items())
    if isinstance(obj, (list, tuple)):
        return type(obj)(_map_tensors(fn, v) for v in obj)
    return obj


def save_checkpoint(checkpoint_dir: str, model_name: str, epoch: int,
                    state: Dict[str, Any], meta: Optional[Dict] = None,
                    is_best: bool = False, path: Optional[str] = None) -> str:
    """Write ``state`` ({"state_dict", "optimizer", "step"}, tensors on any
    device) and its sidecar meta; returns the checkpoint's path."""
    d = pjoin(checkpoint_dir, model_name)
    os.makedirs(d, exist_ok=True)
    path = path or ckpt_path(checkpoint_dir, model_name, epoch)
    meta = dict(meta or {})
    state = _map_tensors(lambda t: t.detach().cpu(), state)
    payload = {"epoch": epoch, "state_dict": state["state_dict"],
               "optimizer": state["optimizer"],
               **{k: meta.get(k) for k in META_KEYS},
               "step": int(state["step"]), "format": FORMAT}
    _atomic_write(path + ".json", json.dumps({"epoch": epoch, **meta}).encode())
    buf = io.BytesIO()
    torch.save(payload, buf)
    _atomic_write(path, buf.getvalue())
    if is_best:
        shutil.copyfile(path, pjoin(d, "model_best.tar"))
    return path


class AsyncCheckpointer:
    """Checkpoint writer on a background thread, so the train loop does not
    wait for the device-to-host copy and the disk.

    ``save()`` snapshots the state before it returns: each tensor is cloned
    on its device (for CUDA tensors on the current stream, after every step
    already queued there) and an event is recorded after the clones. The
    snapshot is load-bearing: ``optimizer.step()`` and BatchNorm update the
    live tensors in place, so without a private copy the writer would read
    parameters that the next step has already changed. The writer waits on
    the event, copies to the host and writes. Writes run in submission
    order on one thread; ``wait()`` drains and re-raises the first writer
    error; ``save()`` blocks once ``max_pending`` writes are queued."""

    def __init__(self, max_pending: int = 2):
        self._q: "queue.Queue" = queue.Queue(maxsize=max_pending)
        self._errors: List[BaseException] = []
        self._written: List[str] = []
        self._lock = threading.Lock()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        while True:
            job = self._q.get()
            if job is None:
                self._q.task_done()
                return
            try:
                event = job.pop("event")
                if event is not None:
                    event.synchronize()
                path = save_checkpoint(**job)
                with self._lock:
                    self._written.append(path)
            except Exception as e:         # surfaced on wait()/save()
                with self._lock:
                    self._errors.append(e)
            finally:
                self._q.task_done()

    @staticmethod
    def _snapshot(state: Dict[str, Any]):
        devices = set()

        def clone(t: torch.Tensor) -> torch.Tensor:
            devices.add(t.device)
            return t.detach().clone()

        snap = _map_tensors(clone, state)
        event = None
        for d in devices:
            if d.type == "cuda":        # a trainer's state is on one device
                event = torch.cuda.current_stream(d).record_event()
        return snap, event

    def save(self, checkpoint_dir: str, model_name: str, epoch: int,
             state: Dict[str, Any], meta: Optional[Dict] = None,
             is_best: bool = False, path: Optional[str] = None) -> str:
        """Snapshot ``state`` and queue its write; returns the path the file
        will have."""
        self._raise_pending()
        path = path or ckpt_path(checkpoint_dir, model_name, epoch)
        snap, event = self._snapshot(state)
        self._q.put(dict(checkpoint_dir=checkpoint_dir, model_name=model_name,
                         epoch=epoch, state=snap, meta=meta, is_best=is_best,
                         path=path, event=event))
        return path

    def wait(self) -> List[str]:
        """Block until every queued write is on disk; raise writer errors."""
        self._q.join()
        self._raise_pending()
        with self._lock:
            return list(self._written)

    def close(self) -> None:
        try:
            self.wait()
        finally:
            self._q.put(None)
            self._thread.join()

    def _raise_pending(self):
        with self._lock:
            if self._errors:
                raise self._errors.pop(0)


def load_checkpoint(path: str) -> Tuple[Dict[str, Any], Dict]:
    """(checkpoint, sidecar meta) of a file ``save_checkpoint`` wrote,
    tensors on the CPU. Uses torch's safe loader (tensors and plain Python
    values only)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    meta = {}
    if os.path.exists(path + ".json"):
        with open(path + ".json") as f:
            meta = json.load(f)
    return ckpt, meta


def is_port_checkpoint(ckpt: Any) -> bool:
    return isinstance(ckpt, dict) and ckpt.get("format") == FORMAT


def load_weights_any(path: str) -> Dict[str, torch.Tensor]:
    """The model state_dict of a ``.tar``: the port's own, or a reference
    checkpoint (``{"state_dict": ...}`` or a bare state_dict, a
    ``module.`` prefix of ``nn.DataParallel`` removed).

    A reference file may hold any picklable value, so it is unpickled in
    full, as the JAX package's ``load_torch_tar`` does: load only files from
    a source you trust."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = ckpt.get("state_dict", ckpt)
    return {k[len("module."):] if k.startswith("module.") else k: v
            for k, v in sd.items() if isinstance(v, torch.Tensor)}
