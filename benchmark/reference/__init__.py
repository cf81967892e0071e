"""Plain float32 PyTorch reference of the measured paths.

A configuration's ``"reference"`` key names its *reference system*,
``<module>.<class>`` of this folder (``systems.MSGCNet``). A system is one
``nn.Module`` whose state_dict is the configuration's published schema (the
port's, so that one state_dict loads into both), with the parameters of any
feature stage that has weights among its own, and provides:

  * ``__init__(config)``: the configuration's whole JSON mapping;
  * ``serve_features(left, right)``: a pair zero-padded to its bucket,
    uint8 ``[H, W]`` (or ``[H, W, C]``) tensors -> the volume the
    regularizer takes, ``[C, D, H', W']``;
  * ``train_features(iml, imr, board_h, bwl, bwr)``: a batch of crops with
    their margins, uint8 ``[N, h, w(, C)]`` -> ``[N, C, D, H', W']``;
  * ``forward(volume)``: the disparity ``[N, H, W]`` in eval mode, the
    outputs that ``loss`` takes in train mode;
  * ``loss(outputs, target)`` and ``disparity(outputs)`` (the final
    disparity of train-mode outputs);
  * ``train_margins(config)`` (a class method): the margins
    ``(board_h, board_w_left, board_w_right)`` around a train crop.

The reference imports nothing of ``msnets_tpu_torch`` or of the JAX package
and takes nothing the port derived: it is handed the raw pairs, the raw
targets and the seed's unfolded weights, and works out padding, features,
BN and the rest again. ``control`` holds the lower-precision variant used
only to show that the comparison fails it.
"""
from __future__ import annotations

import importlib

import torch


def system_class(config: dict) -> type:
    """The class that ``config["reference"]`` names."""
    module, name = config["reference"].rsplit(".", 1)
    return getattr(importlib.import_module(f"{__name__}.{module}"), name)


def build(config: dict, device="cpu") -> torch.nn.Module:
    """The configuration's reference system on ``device``, in eval mode,
    float32, with uninitialised weights (load a state_dict)."""
    with torch.device(device):
        system = system_class(config)(config)
    return system.eval()
