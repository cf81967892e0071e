"""Faults planted under a run's timed path, to show that the check
refuses them (``benchmark/tests`` and ``calibrate.py``; the benchmark's
own runs plant none):

  * ``unchanged``: the train step leaves the parameters as they were;
  * ``half_batch``: the train step takes the first half of its batch, the
    loss the mean over the rest;
  * ``altered_answer``: every served disparity is altered where the
    server produces it (0.5 px added).
"""
from __future__ import annotations


def plant(name: str, sut) -> None:
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
    elif name == "altered_answer":
        server = sut.server
        forward = server.forward

        def altered(iml, imr):
            return forward(iml, imr) + 0.5

        server.forward = altered
    else:
        raise ValueError(f"no fault {name!r}")
