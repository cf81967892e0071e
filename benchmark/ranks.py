"""A cell on several cards: one rank process a card, started and watched
by the process that runs the cell (``run.py``, ``calibrate.py``).

``launch`` starts one process a command, rank i with ``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK`` (i: its card), ``MASTER_ADDR``,
``MASTER_PORT`` (a free port on localhost) and few CPU threads
(``OMP_NUM_THREADS``, the ranks share the host) in its environment, each in a
session of its own, collects what each writes, and waits: until every
rank has ended with code 0; until one ends with another code; or until the
deadline, ``setup_limit_s`` from the start until every rank has logged
``READY`` (``harness.run_cell`` does, once its set-up is done), and from
then ``seconds + after_s``. In the last two cases it kills every rank with
what each started, and the launch fails. A rank also dies with its
launcher (``PR_SET_PDEATHSIG``), so none outlives a launcher that is
killed.

``join`` is a rank's side: the port's ``parallel.mesh.init_distributed``
(NCCL on cards, gloo on the CPU) with a timeout on every collective, and
the mesh that the cell's mix names.
"""
from __future__ import annotations

import ctypes
import dataclasses
import os
import signal
import socket
import subprocess
import threading
import time
from typing import List, Optional, Sequence

READY = "bench.ready"
SETUP_LIMIT_S = 1100.0  # a checkout's first run builds the kernels (1200 s)
AFTER_S = 240.0         # past the window: a profiled sub-window, the check
GROUP_TIMEOUT_S = 600.0
POLL_S = 0.2
RANK_THREADS = 4        # CPU threads a rank, unless OMP_NUM_THREADS says


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _die_with_parent() -> None:
    """In the child before it runs: SIGKILL when the launcher dies."""
    try:
        ctypes.CDLL("libc.so.6", use_errno=True).prctl(1, signal.SIGKILL)
    except (OSError, AttributeError):
        pass


class _Rank:
    def __init__(self, cmd: Sequence[str], env: dict):
        self.proc = subprocess.Popen(
            list(cmd), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            stdin=subprocess.DEVNULL, text=True, env=env,
            start_new_session=True, preexec_fn=_die_with_parent)
        self.out: List[str] = []
        self.err: List[str] = []
        self.ready = threading.Event()
        self.threads = [
            threading.Thread(target=self._read, daemon=True,
                             args=(self.proc.stdout, self.out, False)),
            threading.Thread(target=self._read, daemon=True,
                             args=(self.proc.stderr, self.err, True))]

    def _read(self, stream, lines: List[str], watch: bool) -> None:
        for line in stream:
            lines.append(line)
            if watch and line.startswith(READY):
                self.ready.set()

    def kill(self) -> None:
        try:
            os.killpg(self.proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass


@dataclasses.dataclass
class Launch:
    failure: Optional[str]      # None when every rank ended with code 0
    out: List[List[str]]        # each rank's standard output, by line
    err: List[List[str]]        # each rank's standard error, by line


def launch(commands: Sequence[Sequence[str]], seconds: float,
           setup_limit_s: float = SETUP_LIMIT_S,
           after_s: float = AFTER_S) -> Launch:
    """Run ``commands[i]`` as rank i of ``len(commands)`` and wait for all
    of them (module docstring)."""
    world, port = len(commands), free_port()
    threads = os.environ.get("OMP_NUM_THREADS", str(RANK_THREADS))
    ranks = [_Rank(cmd, dict(os.environ, RANK=str(i), WORLD_SIZE=str(world),
                             LOCAL_RANK=str(i), MASTER_ADDR="127.0.0.1",
                             MASTER_PORT=str(port), OMP_NUM_THREADS=threads))
             for i, cmd in enumerate(commands)]
    for r in ranks:             # the children exist before any thread does
        for t in r.threads:
            t.start()
    t0, ready_at, failure = time.monotonic(), None, None
    try:
        while failure is None:
            codes = [r.proc.poll() for r in ranks]
            bad = [(i, c) for i, c in enumerate(codes) if c not in (None, 0)]
            if bad:
                failure = f"rank {bad[0][0]} exited with code {bad[0][1]}"
                break
            if all(c == 0 for c in codes):
                break
            now = time.monotonic()
            if ready_at is None and all(r.ready.is_set() for r in ranks):
                ready_at = now
            deadline = (t0 + setup_limit_s if ready_at is None
                        else ready_at + seconds + after_s)
            if now > deadline:
                failure = (f"the deadline passed {now - t0:.1f} s after the "
                           "start, " + ("before every rank's set-up ended"
                                        if ready_at is None else
                                        f"{now - ready_at:.1f} s after it"))
                break
            time.sleep(POLL_S)
    finally:
        if failure is not None or any(r.proc.poll() is None for r in ranks):
            for r in ranks:
                r.kill()
        for r in ranks:
            r.proc.wait()
            for t in r.threads:
                t.join()
    return Launch(failure, [r.out for r in ranks], [r.err for r in ranks])


def join(cell, device):
    """This rank joins the cell's group; returns its ``Mesh`` (the mix's
    ``mesh``, [data, spatial, disp])."""
    from msnets_tpu_torch.parallel import mesh as pm
    pm.init_distributed(device=device, timeout_s=GROUP_TIMEOUT_S)
    return pm.make_mesh(tuple(cell.mix["mesh"]))
