"""2-D conv / correlation building blocks in NCHW (counterpart of
``msnets_tpu/models/basic_blocks.py``; reference src/models/basic_convs.py).

No model of either package uses them; they are part of the framework's
surface. Correlation outputs are disparity-first [N, D, H, W].

  * correlation1d_map: corr[n, d, i, j] = sum_c L[n, c, i, j] *
    R[n, c, i, j - d], zero where j < d (basic_convs.py:20-66).
  * corr1d: channel i correlates at column shift i * stride, columns
    j < i * stride keep their zero fill; with kernel_size > 1 a mean filter
    (zero 'same' padding) over H, W (basic_convs.py:70-101).
  * ConvBlock2D: conv (+BN)(+ReLU) with flax's 'SAME' padding, which at
    stride 2 pads an even size (0, 1) where torch's padding=1 pads (1, 1)
    (basic_convs.py:106-205).
  * UpconvBlock2D: ConvTranspose2d doubling H and W, kernel 3 (padding 1,
    output_padding 1) or 4 (padding 1), (+BN)(+ReLU), a bias without BN
    (basic_convs.py:125-277).

BatchNorm follows the JAX package in train mode (``layers.BatchNorm2d``:
biased running variance, momentum 0.1). ``models/convert.py`` maps the JAX
blocks' variables onto these (``conv_block2d_key_map``,
``upconv_block2d_key_map``).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import BatchNorm2d, he_normal_


def correlation1d_map(x: torch.Tensor, y: torch.Tensor,
                      maxdisp: int) -> torch.Tensor:
    """Left/right feature maps [N, C, H, W] -> corr [N, maxdisp, H, W] with
    corr[:, d, :, j] = sum_c x[:, c, :, j] * y[:, c, :, j - d], zero where
    the shift runs off the left edge."""
    W = x.shape[-1]
    yp = F.pad(y, (maxdisp - 1, 0))
    return torch.stack([(x * yp[..., maxdisp - 1 - d:maxdisp - 1 - d + W])
                        .sum(1) for d in range(maxdisp)], 1)


def corr1d(fL: torch.Tensor, fR: torch.Tensor, D: int, stride: int = 1,
           kernel_size: int = 1,
           simfun: Optional[Callable] = None) -> torch.Tensor:
    """Corr1d_V2: an [N, C, H, W] pair -> [N, D, H, W]. ``simfun(a, b)``
    reduces two [N, C, H, W'] maps to [N, H, W'] (the channel sum of the
    product by default)."""
    N, _, H, W = fL.shape
    if simfun is None:
        simfun = lambda a, b: (a * b).sum(1)
    rows = []
    for i in range(D):
        s = i * stride
        if i >= W:
            rows.append(fL.new_zeros(N, H, W))
            continue
        m = simfun(fL[..., s:], fR[..., :W - s])
        rows.append(F.pad(m, (s, 0)))
    corr = torch.stack(rows, 1)
    if kernel_size > 1:
        if kernel_size % 2 != 1:
            raise ValueError(f"corr1d: odd kernel_size only, got {kernel_size}")
        corr = F.avg_pool2d(corr, kernel_size, 1, kernel_size // 2,
                            count_include_pad=True)
    return corr


def _same_pad(n: int, k: int, s: int):
    """flax 'SAME' padding of one dim: (low, high)."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


class ConvBlock2D(nn.Module):
    """conv2d (+BN)(+ReLU): conv3x3 / conv1x1 / downsample_conv[_bn]."""

    def __init__(self, in_channels: int, features: int, kernel: int = 3,
                 stride: int = 1, use_bn: bool = True, use_relu: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.kernel, self.stride, self.use_relu = kernel, stride, use_relu
        self.conv = nn.Conv2d(in_channels, features, kernel, stride,
                              bias=not use_bn)
        self.bn = BatchNorm2d(features, eps=1e-5, momentum=0.1) \
            if use_bn else None
        he_normal_(self.conv.weight, features, generator)
        if self.conv.bias is not None:
            nn.init.zeros_(self.conv.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        (a, b), (c, d) = (_same_pad(n, self.kernel, self.stride)
                          for n in x.shape[2:])
        x = self.conv(F.pad(x, (c, d, a, b)))
        if self.bn is not None:
            x = self.bn(x)
        return F.relu(x) if self.use_relu else x


class UpconvBlock2D(nn.Module):
    """transposed conv2d (+BN)(+ReLU) doubling H and W: upconv3x3 /
    upconv4x4 / deconv2d[_bn]."""

    def __init__(self, in_channels: int, features: int, kernel: int = 4,
                 use_bn: bool = True, use_relu: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if kernel not in (3, 4):
            raise ValueError(f"UpconvBlock2D: kernel 3 or 4, got {kernel}")
        self.use_relu = use_relu
        self.deconv = nn.ConvTranspose2d(in_channels, features, kernel, 2, 1,
                                         output_padding=1 if kernel == 3 else 0,
                                         bias=not use_bn)
        self.bn = BatchNorm2d(features, eps=1e-5, momentum=0.1) \
            if use_bn else None
        he_normal_(self.deconv.weight, features, generator)
        if self.deconv.bias is not None:
            nn.init.zeros_(self.deconv.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.deconv(x)
        if self.bn is not None:
            x = self.bn(x)
        return F.relu(x) if self.use_relu else x
