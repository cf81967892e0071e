"""Device selection and numeric settings shared by the port's entry points."""
from __future__ import annotations

import contextlib
from typing import Iterator, Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means the GPU. Asking for CUDA where there is none raises:
    the port never falls back to the CPU on its own; pass ``"cpu"``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the CPU")
    return dev


@contextlib.contextmanager
def fp32_reference() -> Iterator[None]:
    """Full float32 convolutions and matmuls for reference runs.

    cuDNN runs float32 convolutions in TF32 by default
    (``torch.backends.cudnn.allow_tf32`` is True), which keeps about three
    decimal digits. Inside this block both TF32 switches are off; the
    previous settings come back on exit."""
    prev = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = prev
