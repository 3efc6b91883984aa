"""ResNet / ResNeXt feature extractors (NCHW torch modules).

The counterparts of the JAX package's ``models/resnet.py``, with its
numerics: one PReLU per block with a single scalar slope, shared by every
activation of the block; batch norm in the module's mode (batch statistics
under ``.train()``, running ones under ``.eval()``); flax's ``SAME``
padding, which for the 1x1 stride-2 shortcut convs pads nothing; a stem
max pool that pads with -inf (on a row shard, only at the image's real
top and bottom: ``parallel/spatial.py``).  Submodules carry the flax names
(``conv1``, ``bn1``, ``relu``, ``ds_conv``, ``ds_norm``, ``layer{i}_{j}``).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import BatchNorm, Conv


class PReLU(nn.Module):
    """Single-parameter PReLU: ``x if x >= 0 else alpha * x``."""

    def __init__(self, init_slope: float = 0.25):
        super().__init__()
        self.weight = nn.Parameter(torch.full((1,), init_slope))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.prelu(x, self.weight.to(x.dtype))


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, in_ch: int, out_channel: int, stride: int = 1,
                 downsample: bool = False, dtype=torch.float32):
        super().__init__()
        self.relu = PReLU()
        self.downsample = downsample
        if downsample:
            self.ds_conv = Conv(in_ch, out_channel, 1, stride, bias=False,
                                compute_dtype=dtype)
            self.ds_norm = BatchNorm(out_channel)
        self.conv1 = Conv(in_ch, out_channel, 3, stride, 1, bias=False,
                          compute_dtype=dtype)
        self.bn1 = BatchNorm(out_channel)
        self.conv2 = Conv(out_channel, out_channel, 3, 1, 1, bias=False,
                          compute_dtype=dtype)
        self.bn2 = BatchNorm(out_channel)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        identity = self.ds_norm(self.ds_conv(x)) if self.downsample else x
        y = self.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        return self.relu(y + identity)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, in_ch: int, out_channel: int, stride: int = 1,
                 downsample: bool = False, groups: int = 1,
                 width_per_group: int = 64, dtype=torch.float32):
        super().__init__()
        width = int(out_channel * (width_per_group / 64.0)) * groups
        out = out_channel * self.expansion
        self.relu = PReLU()
        self.downsample = downsample
        if downsample:
            self.ds_conv = Conv(in_ch, out, 1, stride, bias=False,
                                compute_dtype=dtype)
            self.ds_norm = BatchNorm(out)
        self.conv1 = Conv(in_ch, width, 1, bias=False, compute_dtype=dtype)
        self.bn1 = BatchNorm(width)
        self.conv2 = Conv(width, width, 3, stride, 1, groups=groups, bias=False,
                          compute_dtype=dtype)
        self.bn2 = BatchNorm(width)
        self.conv3 = Conv(width, out, 1, bias=False, compute_dtype=dtype)
        self.bn3 = BatchNorm(out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        identity = self.ds_norm(self.ds_conv(x)) if self.downsample else x
        y = self.relu(self.bn1(self.conv1(x)))
        y = self.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        return self.relu(y + identity)


class ResNetFeatureExtraction(nn.Module):
    """ResNet trunk: conv1 -> max pool -> layer1..layer3 (stride 16), plus
    layer4 with ``pyramid=True``, which returns the taps ``(C2, C3, C4,
    C5)`` at strides 4/8/16/32.  Input and outputs are NCHW."""

    def __init__(self, block: str = "bottleneck",
                 blocks_num: Sequence[int] = (3, 4, 6), groups: int = 1,
                 width_per_group: int = 64, dtype=torch.float32,
                 pyramid: bool = False):
        super().__init__()
        self.pyramid = pyramid
        self.conv1 = Conv(3, 64, 7, 2, 3, bias=False, compute_dtype=dtype)
        self.bn1 = BatchNorm(64)
        self.relu = PReLU()
        exp = 1 if block == "basic" else 4
        channels = (64, 128, 256, 512)[:len(blocks_num)]
        in_ch = 64
        self.stages = []
        for li, (ch, n) in enumerate(zip(channels, blocks_num)):
            names = []
            for bi in range(n):
                s = (1 if li == 0 else 2) if bi == 0 else 1
                if block == "basic":
                    m = BasicBlock(in_ch, ch, s, bi == 0 and (s != 1 or li > 0),
                                   dtype)
                else:
                    m = Bottleneck(in_ch, ch, s, bi == 0, groups,
                                   width_per_group, dtype)
                names.append(f"layer{li + 1}_{bi}")
                self.add_module(names[-1], m)
                in_ch = ch * exp
            self.stages.append(names)
        self.out_channels = (tuple(c * exp for c in channels) if pyramid
                             else 256 * exp)
        # built in eval mode, as the flax module defaults to ``train=False``
        self.eval()

    def forward(self, x: torch.Tensor, generator: torch.Generator = None):
        """``generator`` is the backbones' common train-mode argument; this
        one draws nothing."""
        x = self.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, 2, 1)
        taps = []
        for names in self.stages:
            for name in names:
                x = getattr(self, name)(x)
            taps.append(x)
        return tuple(taps) if self.pyramid else x
