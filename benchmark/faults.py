"""Faults planted under a run's timed path, to show that the check
refuses them (``benchmark/tests`` and ``calibrate.py``; the benchmark's
own runs plant none):

  * ``unchanged``: the train step leaves the parameters as they were;
  * ``half_batch``: the train step takes the first half of its batch (of
    each rank's share, on several cards), the loss the mean over the rest;
  * ``no_exchange`` (on several cards): the step's gradient all-reduce is
    left out, each rank steps on its own share's gradient;
  * ``one_rank_left_out`` (on several cards): the last data index's
    samples are left out of the loss (their targets lost, so its mask is
    empty), the mean taken over the other ranks' samples;
  * ``altered_answer``: every served disparity is altered where the
    server produces it (0.5 px added).
"""
from __future__ import annotations


def plant(name: str, sut) -> None:
    mesh = getattr(sut, "mesh", None)
    if name in ("no_exchange", "one_rank_left_out") and mesh is None:
        raise ValueError(f"fault {name!r} needs a cell on several cards")
    if name == "unchanged":
        sut.trainer.optimizer.step = lambda *a, **k: None
    elif name == "half_batch":
        step = sut.trainer._step

        def half(geometry, iml, imr, target, lr):
            n = len(iml) // 2
            return step(geometry, iml[:n], imr[:n], target[:n], lr)

        sut.trainer._step = half
        b = sut.traffic.batches[0]
        sut.fn = lambda *a: half((b["board_h"], b["board_w_left"],
                                  b["board_w_right"]), *a)
    elif name == "no_exchange":
        sut.trainer._all_reduce_grads = lambda: None
    elif name == "one_rank_left_out":
        if mesh.index("data") == mesh.size("data") - 1:
            fn = sut.fn
            sut.fn = lambda iml, imr, target, lr: fn(iml, imr, target * 0,
                                                     lr)
    elif name == "altered_answer":
        server = sut.server
        forward = server.forward

        def altered(iml, imr):
            return forward(iml, imr) + 0.5

        server.forward = altered
    else:
        raise ValueError(f"no fault {name!r}")
