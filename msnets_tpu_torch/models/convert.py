"""JAX parameters -> the port's state_dict (the inverse of
``msnets_tpu/models/torch_convert.py``).

``state_dict_from_jax`` takes the JAX package's ``{"params",
"batch_stats"}`` trees (numpy arrays or anything ``np.asarray`` takes) and
returns the state_dict of the port's model, under the reference checkpoint's
key schema. The port keeps its own copies of the MS-GCNet and MS-PSMNet key
maps.

Weight layouts:
  * Conv3d: flax [kd, kh, kw, in, out] -> torch [out, in, kd, kh, kw];
  * ConvTranspose3d: the JAX Deconv3D stores the spatially flipped kernel
    as [kd, kh, kw, in, out] -> transpose to [in, out, kd, kh, kw], then
    un-flip the three spatial axes;
  * BatchNorm: scale/bias (params), mean/var (batch_stats) ->
    weight/bias/running_mean/running_var, num_batches_tracked = 0.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Mapping, Tuple

import numpy as np
import torch

_Entry = Tuple[str, str, Tuple[str, ...], str]   # key, collection, path, kind


def _conv_from_flax(w: np.ndarray) -> np.ndarray:
    return np.transpose(w, (4, 3, 0, 1, 2))


def _deconv_from_flax(w: np.ndarray) -> np.ndarray:
    return np.transpose(w, (3, 4, 0, 1, 2))[:, :, ::-1, ::-1, ::-1]


_TRANSFORMS = {"conv": _conv_from_flax, "deconv": _deconv_from_flax,
               "plain": lambda w: w}


def _bn_entries(prefix: str, path: Tuple[str, ...]) -> List[_Entry]:
    return [(f"{prefix}.weight", "params", path + ("scale",), "plain"),
            (f"{prefix}.bias", "params", path + ("bias",), "plain"),
            (f"{prefix}.running_mean", "batch_stats", path + ("mean",), "plain"),
            (f"{prefix}.running_var", "batch_stats", path + ("var",), "plain")]


def _convbn_entries(prefix: str, path: Tuple[str, ...]) -> List[_Entry]:
    return ([(f"{prefix}.0.weight", "params", path + ("conv", "kernel"), "conv")]
            + _bn_entries(f"{prefix}.1", path + ("bn",)))


def gcnet_key_map() -> List[_Entry]:
    """(torch key, flax collection, flax path, weight kind) for MS-GCNet."""
    e = _convbn_entries("conv3dbn_1", ("conv3dbn_1",))
    e += _convbn_entries("conv3dbn_2", ("conv3dbn_2",))
    for k in range(1, 5):
        for j in range(1, 4):
            e += _convbn_entries(f"block_3d_{k}.convbn_3d_{j}",
                                 (f"block_3d_{k}", f"convbn_3d_{j}"))
    for k in range(1, 5):
        e.append((f"deconvbn{k}.0.weight", "params",
                  (f"deconvbn{k}", "deconv", "kernel"), "deconv"))
        e += _bn_entries(f"deconvbn{k}.1", (f"deconvbn{k}", "bn"))
    e.append(("deconv5.weight", "params", ("deconv5", "kernel"), "deconv"))
    e.append(("deconv5.bias", "params", ("deconv5", "bias"), "plain"))
    return e


def _hourglass_entries(prefix: str, name: str) -> List[_Entry]:
    """conv1, conv3, conv4 = (convbn, ReLU); conv2 = convbn; conv5, conv6 =
    (ConvTranspose3d, BatchNorm3d)."""
    e = _convbn_entries(f"{prefix}.conv1.0", (name, "conv1"))
    e += _convbn_entries(f"{prefix}.conv2", (name, "conv2"))
    e += _convbn_entries(f"{prefix}.conv3.0", (name, "conv3"))
    e += _convbn_entries(f"{prefix}.conv4.0", (name, "conv4"))
    for c in (5, 6):
        e.append((f"{prefix}.conv{c}.0.weight", "params",
                  (name, f"conv{c}", "deconv", "kernel"), "deconv"))
        e += _bn_entries(f"{prefix}.conv{c}.1", (name, f"conv{c}", "bn"))
    return e


def psmnet_key_map() -> List[_Entry]:
    """(torch key, flax collection, flax path, weight kind) for MS-PSMNet."""
    e = _convbn_entries("dres0.0", ("dres0_1",))
    e += _convbn_entries("dres0.2", ("dres0_2",))
    e += _convbn_entries("dres1.0", ("dres1_1",))
    e += _convbn_entries("dres1.2", ("dres1_2",))
    for i in (2, 3, 4):
        e += _hourglass_entries(f"dres{i}", f"dres{i}")
    for i in (1, 2, 3):
        e += _convbn_entries(f"classif{i}.0", (f"classif{i}", "convbn"))
        e.append((f"classif{i}.2.weight", "params",
                  (f"classif{i}", "conv", "kernel"), "conv"))
    return e


_KEY_MAPS = {"MS-GCNet": gcnet_key_map, "MS-PSMNet": psmnet_key_map}


def state_dict_from_jax(variables: Mapping, model_name: str = "MS-GCNet"
                        ) -> Dict[str, torch.Tensor]:
    """The port's state_dict for the JAX variables of ``model_name``."""
    if model_name not in _KEY_MAPS:
        raise ValueError(f"No suitable model found: {model_name}")
    sd = OrderedDict()
    for key, coll, path, kind in _KEY_MAPS[model_name]():
        node = variables[coll]
        for p in path:
            node = node[p]
        arr = _TRANSFORMS[kind](np.asarray(node, dtype=np.float32))
        sd[key] = torch.from_numpy(np.ascontiguousarray(arr))
        if key.endswith(".running_var"):
            sd[key[:-len("running_var")] + "num_batches_tracked"] = \
                torch.tensor(0, dtype=torch.int64)
    return sd
