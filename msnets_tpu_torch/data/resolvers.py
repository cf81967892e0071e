"""Dataset manifest loading and per-dataset path resolution: the port's
copy of ``msnets_tpu/data/resolvers.py``.

Parity with the reference resolvers (reference: src/dataloader/dataset.py:
30-114): each maps a manifest entry to (left_img, right_img, left_disp_pfm
[, left_seg]).
"""
from __future__ import annotations

import os
from os.path import join as pjoin
from typing import List, Tuple


def load_list(path: str) -> List[str]:
    with open(path) as f:
        return [l.rstrip() for l in f if l.strip()]


def resolve_sceneflow(data_path: str, entry: str,
                      cleanpass: bool = False) -> Tuple[str, str, str]:
    """Scene Flow: entry like 'FlyingThings3D/frames_finalpass/.../left/0006.png'
    (dataset.py:30-52)."""
    a = entry
    if cleanpass:
        a = a.replace("frames_finalpass", "frames_cleanpass", 1)
    limg = pjoin(data_path, a)
    rimg = pjoin(data_path, a[:-13] + "right/" + a[len(a) - 8:])
    pos = a.find("/")
    tlen = len("frames_finalpass")
    ldisp = pjoin(data_path, a[:pos] + "/disparity" + a[pos + 1 + tlen:-4] + ".pfm")
    return limg, rimg, ldisp


def resolve_kitti2012(data_path: str, entry: str) -> Tuple[str, str, str]:
    return (pjoin(data_path, "image_0/" + entry),
            pjoin(data_path, "image_1/" + entry),
            pjoin(data_path, "disp_occ_pfm/" + entry[:-4] + ".pfm"))


def resolve_kitti2015(data_path: str, entry: str) -> Tuple[str, str, str]:
    return (pjoin(data_path, "image_0/" + entry),
            pjoin(data_path, "image_1/" + entry),
            pjoin(data_path, "disp_occ_0_pfm/" + entry[:-4] + ".pfm"))


def resolve_eth3d(data_path: str, entry: str) -> Tuple[str, str, str]:
    return (pjoin(data_path, entry + "/im0.png"),
            pjoin(data_path, entry + "/im1.png"),
            pjoin(data_path, entry + "/disp0GT.pfm"))


resolve_middlebury = resolve_eth3d  # identical layout (dataset.py:81-90)


def resolve(dataset: str, data_path: str, entry: str, cleanpass: bool = False):
    """Dispatch by dataset name ('sceneflow'|'kitti2012'|'kitti2015'|'eth3d'|
    'middlebury')."""
    if dataset == "kitti2012":
        return resolve_kitti2012(data_path, entry)
    if dataset == "kitti2015":
        return resolve_kitti2015(data_path, entry)
    if dataset == "eth3d":
        return resolve_eth3d(data_path, entry)
    if dataset == "middlebury":
        return resolve_middlebury(data_path, entry)
    if dataset == "sceneflow":
        return resolve_sceneflow(data_path, entry, cleanpass)
    # an unknown name applied Scene Flow path surgery to foreign entries
    # and surfaced as a baffling FileNotFoundError in a worker thread
    raise ValueError(f"unknown dataset {dataset!r}; expected sceneflow|"
                     "kitti2012|kitti2015|eth3d|middlebury")


def result_name(dataset: str, entry: str, iteration: int) -> str:
    """Output PFM basename per dataset (main_msnet.py:562-569)."""
    if dataset in ("kitti2012", "kitti2015"):
        return entry[:-4] + ".pfm"
    if dataset in ("eth3d", "middlebury"):
        return entry + ".pfm"
    return f"{iteration}.pfm"
