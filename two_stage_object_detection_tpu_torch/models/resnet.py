"""ResNet / ResNeXt feature extractors (NCHW torch modules).

The counterparts of the JAX package's ``models/resnet.py``, with its
numerics: one PReLU per block with a single scalar slope, shared by every
activation of the block; batch norm in the module's mode (batch statistics
under ``.train()``, running ones under ``.eval()``); flax's ``SAME``
padding, which for the 1x1 stride-2 shortcut convs pads nothing; a stem
max pool that pads with -inf (on a row shard, only at the image's real
top and bottom: ``parallel/spatial.py``).  Submodules carry the flax names
(``conv1``, ``bn1``, ``relu``, ``ds_conv``, ``ds_norm``, ``layer{i}_{j}``).

Predict on the card takes the folded route (``layers.fold_route``): each
conv with its batch norm folded in, then one epilogue of bias and PReLU,
the block's last also adding the shortcut, whose conv's bias it takes in.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from two_stage_object_detection_tpu_torch.models.layers import (
    BatchNorm, Conv, cached_fold, epilogue, fold_norm, fold_route,
    fold_sources)
from two_stage_object_detection_tpu_torch.parallel import spatial
from two_stage_object_detection_tpu_torch.utils.profiling import counters


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

    def _folded(self, x: torch.Tensor) -> torch.Tensor:
        """:meth:`forward` on the folded route: two epilogues."""
        return _folded_block(self, x, (self.conv1, self.bn1),
                             (self.conv2, self.bn2))


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

    def _folded(self, x: torch.Tensor) -> torch.Tensor:
        """:meth:`forward` on the folded route: three epilogues."""
        return _folded_block(self, x, (self.conv1, self.bn1),
                             (self.conv2, self.bn2), (self.conv3, self.bn3))


def _fold_pairs(pairs, shortcut=None):
    """Folded ``[(w', b')]`` of the (conv, norm) ``pairs`` (weights in the
    compute dtype, biases float32) and the ``shortcut`` pair's weight or
    None: the shortcut's bias joins the last pair's, so that one epilogue
    adds both."""
    folded = [fold_norm(c, n) for c, n in pairs]
    w_ds = None
    if shortcut is not None:
        w_ds, b_ds = fold_norm(*shortcut)
        w_ds = w_ds.to(shortcut[0].compute_dtype)
        folded[-1] = (folded[-1][0], folded[-1][1] + b_ds)
    return [(w.to(c.compute_dtype), b) for (w, b), (c, _) in
            zip(folded, pairs)], w_ds


def _folded_block(block, x, *pairs):
    """A residual block on the folded route: each conv with its norm folded
    in, then one epilogue of its bias and the block's PReLU; the last also
    adds the shortcut (the input, or the folded shortcut conv's unbiased
    output), in the same pass.  The shortcut conv makes no pass of its
    own."""
    shortcut = (block.ds_conv, block.ds_norm) if block.downsample else None
    mods = [m for pair in pairs for m in pair] + list(shortcut or ())
    folded, w_ds = cached_fold(block, fold_sources(*mods),
                               lambda: _fold_pairs(pairs, shortcut))
    counters["fold.folded"] += len(mods) // 2
    conv_last = pairs[-1][0]
    identity = (block.ds_conv.forward(x, w_ds) if block.downsample
                else x.to(conv_last.compute_dtype))
    slope = block.relu.weight
    y = x
    for (conv, _), (w, b) in zip(pairs[:-1], folded[:-1]):
        y = epilogue(conv.forward(y, w), b, act="prelu", slope=slope)
    w, b = folded[-1]
    return epilogue(conv_last.forward(y, w), b, identity, "prelu", slope)


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
        one draws nothing.  On the folded route (``layers.fold_route``) the
        stem and every block run folded."""
        fold = fold_route(self, x)
        x = self._stem_folded(x) if fold else self.relu(self.bn1(self.conv1(x)))
        x = spatial.max_pool(x, 3, 2, 1)
        taps = []
        for names in self.stages:
            for name in names:
                block = getattr(self, name)
                x = block._folded(x) if fold else block(x)
            taps.append(x)
        return tuple(taps) if self.pyramid else x

    def _stem_folded(self, x: torch.Tensor) -> torch.Tensor:
        """conv1 -> bn1 -> PReLU as the folded conv and one epilogue."""
        pair = (self.conv1, self.bn1)
        w, b = cached_fold(self, fold_sources(*pair),
                           lambda: _fold_pairs([pair])[0][0])
        counters["fold.folded"] += 1
        return epilogue(self.conv1.forward(x, w), b, act="prelu",
                        slope=self.relu.weight)
