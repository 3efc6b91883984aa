"""Feature Pyramid Network neck and the FPN RPN / RoI heads (NCHW torch).

The counterparts of the JAX package's ``nets/fpn.py``.  Feature maps run
NCHW inside (channels-last in memory on the GPU, so an NHWC view of a level
is free); public outputs keep the JAX layouts:

* the RPN head returns ``rpn_locs [B, N, 4]`` / ``rpn_scores [B, N, 2]``
  flattened in NHWC order ``(y*W + x)*A + a``, the anchor table's order;
* the RoI head pools ``[B, R, P, P, C]`` and flattens it in (p, q, c)
  order for ``fc1``, so the flax weights map unchanged.

The RoI head pools through windows: the predict route (kernel 2) and the
hybrid train route (that forward, with the dense RoIAlign's gradient as
its backward).  With ``fpn_roi_window=0`` it takes the dense route instead,
as the JAX package does: every roi pooled from each of P2..P5 with the
matrix-product RoIAlign (``ops/roi_pool.py:roi_align_mm``) at that level's
scale, blended by the one-hot level (eq.-1 assignment, no span-aware bump),
for predict and train alike, differentiated by autograd.

Both heads pool through :class:`PyramidPool`: the box head at ``roi_size``
(7) on the proposals, Mask R-CNN's :class:`FPNMaskHead` at its own size
(14) on the kept detections (serving) or the positive sampled rois
(training), kernel 2 compiled for each.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from two_stage_object_detection_tpu_torch.models.layers import (
    Conv, ConvTranspose, Dense)
from two_stage_object_detection_tpu_torch.ops.geometry import (
    device_constant, div_exact)
from two_stage_object_detection_tpu_torch.ops.roi_pool import (
    roi_align_mm, scale_pairs)
from two_stage_object_detection_tpu_torch.ops.windowed_align import (
    multilevel_roi_align_hybrid_batched, windowed_roi_align_batched)
from two_stage_object_detection_tpu_torch.parallel import spatial


def _upsample2x_to(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """Nearest 2x upsample of ``[B, C, h', w']`` cropped to ``like``'s
    map; on a row shard, ``like``'s rows of it, by global rows."""
    shard = spatial.current()
    if shard is not None:
        return shard.upsample2x_to(x, like)
    h, w = like.shape[2:4]
    return F.interpolate(x, scale_factor=2, mode="nearest")[:, :, :h, :w]


def _subsample2x(x: torch.Tensor) -> torch.Tensor:
    """``x[:, :, ::2, ::2]``; on a row shard, the whole map's even rows."""
    shard = spatial.current()
    return x[:, :, ::2, ::2] if shard is None else shard.subsample2x(x)


class FPNNeck(nn.Module):
    """Lateral 1x1 + top-down pathway + 3x3 smoothing.

    ``(C2, C3, C4, C5) -> (P2, P3, P4, P5, P6)``, all ``channels`` wide;
    P6 is ``P5[:, :, ::2, ::2]`` (a 1x1 stride-2 max pool).  On a row
    shard (``parallel/spatial.py``) the upsample and P6 take global rows.
    """

    def __init__(self, in_channels: Sequence[int], channels: int = 256,
                 dtype=torch.float32):
        super().__init__()
        for i, c in enumerate(in_channels):
            self.add_module(f"lateral{i}", Conv(c, channels, 1,
                                                compute_dtype=dtype))
            self.add_module(f"smooth{i}", Conv(channels, channels, 3, 1, 1,
                                               compute_dtype=dtype))
        self.n = len(in_channels)

    def forward(self, taps: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
        laterals = [getattr(self, f"lateral{i}")(c) for i, c in enumerate(taps)]
        outs = [laterals[-1]]
        for lat in laterals[-2::-1]:
            outs.insert(0, lat + _upsample2x_to(outs[0], lat))
        ps = [getattr(self, f"smooth{i}")(o) for i, o in enumerate(outs)]
        return (*ps, _subsample2x(ps[-1]))


class FPNRPNHead(nn.Module):
    """Shared 3x3 conv + ReLU + 1x1 loc/score heads over every level."""

    def __init__(self, n_anchors: int = 3, channels: int = 256,
                 dtype=torch.float32):
        super().__init__()
        self.n_anchors = n_anchors
        self.conv = Conv(channels, channels, 3, 1, 1, compute_dtype=dtype)
        self.loc = Conv(channels, n_anchors * 4, 1, compute_dtype=dtype)
        self.score = Conv(channels, n_anchors * 2, 1, compute_dtype=dtype)

    def forward(self, pyramid: Sequence[torch.Tensor]):
        locs, scores = [], []
        for p in pyramid:
            b = p.shape[0]
            t = F.relu(self.conv(p))
            # NCHW -> NHWC before flattening: (y*W + x)*A + a
            locs.append(self.loc(t).permute(0, 2, 3, 1).reshape(b, -1, 4))
            scores.append(self.score(t).permute(0, 2, 3, 1).reshape(b, -1, 2))
        return (torch.cat(locs, dim=1).float(), torch.cat(scores, dim=1).float())


def fpn_level_assign(rois: torch.Tensor, min_level: int, max_level: int,
                     canonical_level: int = 4,
                     canonical_size: float = 224.0) -> torch.Tensor:
    """Per-roi pooling level ``floor(k0 + log2(sqrt(w*h) / s0))``, clipped.

    ``rois [..., R, 4]`` -> ``[..., R]`` int32, computed in the JAX order so
    rois at the size boundaries land on the same level.
    """
    w = torch.clamp(rois[..., 2] - rois[..., 0], min=1e-6)
    h = torch.clamp(rois[..., 3] - rois[..., 1], min=1e-6)
    k = torch.floor(canonical_level
                    + torch.log2(div_exact(torch.sqrt(w * h), canonical_size)))
    return torch.clamp(k, min_level, max_level).to(torch.int32)


def span_aware_levels(rois: torch.Tensor, levels: torch.Tensor, scales,
                      fit_cells: float) -> torch.Tensor:
    """Bump rois whose long side overflows the pooling window to the first
    coarser level where it fits (``span <= fit_cells`` cells).

    ``rois [..., R, 4]``; ``levels [..., R]`` already offset to index
    ``scales`` (per-level ``(sy, sx)`` pairs or scalars).  A roi that fits
    nowhere keeps the coarsest level.  Returns ``[..., R]`` int32.
    """
    sc = device_constant([v for pair in scale_pairs(scales, len(scales))
                          for v in pair], torch.float32,
                         rois.device).reshape(-1, 2)
    n_levels = sc.shape[0]
    w = rois[..., 2] - rois[..., 0]
    h = rois[..., 3] - rois[..., 1]
    span = torch.maximum(h[..., None] * sc[:, 0], w[..., None] * sc[:, 1])
    lvl_idx = torch.arange(n_levels, device=rois.device)
    ok = (span <= fit_cells) & (lvl_idx >= levels[..., None])
    first_fit = torch.where(ok, lvl_idx, n_levels).amin(dim=-1)
    return torch.where(first_fit < n_levels, first_fit,
                       n_levels - 1).to(torch.int32)


class PyramidPool(nn.Module):
    """What the box and mask heads share: each roi's pooling level (eq. 1 of
    the FPN paper, :func:`fpn_level_assign`, then the span-aware bump) and
    the windowed RoIAlign at ``roi_size`` (kernel 2 on CUDA tensors), or the
    dense route with ``window=0``.  Both heads reach kernel 2 through the
    names ``windowed_roi_align_batched`` and
    ``multilevel_roi_align_hybrid_batched`` of this module, looked up at
    call time."""

    def __init__(self, roi_size: int, min_level: int, n_pool_levels: int,
                 canonical_level: int, canonical_size: float, window: int,
                 use_kernel: bool, span_aware: bool):
        super().__init__()
        self.roi_size, self.min_level = roi_size, min_level
        self.n_pool_levels = n_pool_levels
        self.canonical_level, self.canonical_size = canonical_level, canonical_size
        self.window, self.use_kernel, self.span_aware = window, use_kernel, span_aware

    def pool(self, pyramid: Sequence[torch.Tensor], rois: torch.Tensor,
             img_size, use_window: bool = True) -> torch.Tensor:
        """Level assignment + windowed RoIAlign -> ``[B, R, P, P, C]``;
        ``use_window=False`` is the train route, differentiable in the
        pyramid."""
        img_h, img_w = img_size
        max_level = self.min_level + self.n_pool_levels - 1
        levels = fpn_level_assign(rois, self.min_level, max_level,
                                  self.canonical_level, self.canonical_size)
        if not self.window:
            return self._pool_dense(pyramid, rois, levels, img_size)
        scales = tuple((pyramid[li].shape[2] / img_h, pyramid[li].shape[3] / img_w)
                       for li in range(self.n_pool_levels))
        if self.span_aware:
            levels = self.min_level + span_aware_levels(
                rois, levels - self.min_level, scales, float(self.window - 2))
        nhwc = [p.permute(0, 2, 3, 1).contiguous()
                for p in pyramid[:self.n_pool_levels]]
        align = (windowed_roi_align_batched if use_window
                 else multilevel_roi_align_hybrid_batched)
        return align(nhwc, rois.contiguous(),
                     (levels - self.min_level).to(torch.int32), scales,
                     self.roi_size, 2, self.window, False,
                     use_kernel=self.use_kernel)

    def _pool_dense(self, pyramid, rois, levels, img_size) -> torch.Tensor:
        """Every roi from every pooling level, blended by its one-hot level,
        in the pyramid's dtype (the sum in level order, as in JAX)."""
        img_h, img_w = img_size
        onehot = F.one_hot((levels - self.min_level).to(torch.int64),
                           self.n_pool_levels).to(torch.float32)  # [B, R, L]
        rois = rois.to(torch.float32)
        pooled = None
        for li in range(self.n_pool_levels):
            fh, fw = pyramid[li].shape[2:4]
            scale = device_constant([fw / img_w, fh / img_h] * 2,
                                    torch.float32, rois.device)
            p = roi_align_mm(pyramid[li].permute(0, 2, 3, 1).contiguous(),
                             rois * scale, self.roi_size, 1.0)
            w = onehot[:, :, li][..., None, None, None].to(p.dtype)
            pooled = p * w if pooled is None else pooled + p * w
        return pooled


class FPNRoIHead(PyramidPool):
    """Windowed multi-level RoIAlign (kernel 2) + fc1 -> fc2 -> cls_loc/score.
    ``use_window=False`` takes the hybrid train route; ``window=0`` the dense
    route, whatever ``use_window``.

    ``(pyramid (P_min..), rois [B, R, 4] image coords, img_size) ->
    (roi_cls_locs [B, R, n_class*4], roi_scores [B, R, n_class])``, f32.
    """

    def __init__(self, n_class: int, channels: int = 256, roi_size: int = 7,
                 min_level: int = 2, n_pool_levels: int = 4,
                 canonical_level: int = 4, canonical_size: float = 224.0,
                 fc_dim: int = 1024, window: int = 32, use_kernel: bool = True,
                 span_aware: bool = True, dtype=torch.float32):
        super().__init__(roi_size, min_level, n_pool_levels, canonical_level,
                         canonical_size, window, use_kernel, span_aware)
        self.fc1 = Dense(roi_size * roi_size * channels, fc_dim, dtype)
        self.fc2 = Dense(fc_dim, fc_dim, dtype)
        self.cls_loc = Dense(fc_dim, n_class * 4, dtype)
        self.score = Dense(fc_dim, n_class, dtype)

    def forward(self, pyramid: Sequence[torch.Tensor], rois: torch.Tensor,
                img_size, use_window: bool = True):
        pooled = self.pool(pyramid, rois, img_size, use_window)
        flat = pooled.reshape(*pooled.shape[:2], -1)
        x = F.relu(self.fc1(flat))
        x = F.relu(self.fc2(x))
        return self.cls_loc(x).float(), self.score(x).float()


class FPNMaskHead(PyramidPool):
    """Mask R-CNN's mask branch (He et al., arXiv:1703.06870, Fig. 4 right):
    each roi pooled by :class:`PyramidPool` at ``roi_size`` (14), then
    ``n_convs`` 3x3 convolutions ``dim`` wide with ReLU, a 2x2 stride-2
    transposed convolution ``dim`` wide with ReLU, and a 1x1 convolution to
    one ``2 * roi_size`` square mask logit a foreground class
    (``n_fg_class``, no background channel, as detectron2 has it).

    ``(pyramid, rois [B, D, 4] image coords, labels [B, D] 1-based classes,
    img_size) -> [B, D, M, M]`` f32: the logits of each roi's own class
    (class 1 where a label is 0, a slot the caller masks).  The B*D rois run
    as one batch of NCHW maps, channels-last in memory on the card, so the
    pooled ``[B, D, P, P, C]`` is one view away from the first convolution.
    """

    def __init__(self, n_fg_class: int, channels: int = 256, roi_size: int = 14,
                 dim: int = 256, n_convs: int = 4, min_level: int = 2,
                 n_pool_levels: int = 4, canonical_level: int = 4,
                 canonical_size: float = 224.0, window: int = 32,
                 use_kernel: bool = True, span_aware: bool = True,
                 dtype=torch.float32):
        super().__init__(roi_size, min_level, n_pool_levels, canonical_level,
                         canonical_size, window, use_kernel, span_aware)
        self.n_convs = n_convs
        for i in range(n_convs):
            self.add_module(f"conv{i}", Conv(channels if i == 0 else dim, dim,
                                             3, 1, 1, compute_dtype=dtype))
        self.deconv = ConvTranspose(dim if n_convs else channels, dim, 2,
                                    compute_dtype=dtype)
        self.predictor = Conv(dim, n_fg_class, 1, compute_dtype=dtype)

    def forward(self, pyramid: Sequence[torch.Tensor], rois: torch.Tensor,
                labels: torch.Tensor, img_size, use_window: bool = True):
        b, d = rois.shape[:2]
        pooled = self.pool(pyramid, rois, img_size, use_window)
        p, c = pooled.shape[2], pooled.shape[4]
        # NHWC rows -> NCHW logical, channels-last in memory
        x = pooled.reshape(b * d, p, p, c).permute(0, 3, 1, 2)
        for i in range(self.n_convs):
            x = F.relu(getattr(self, f"conv{i}")(x))
        logits = self.predictor(F.relu(self.deconv(x)))       # [B*D, K, M, M]
        cls = (labels.reshape(-1).to(torch.int64) - 1).clamp(min=0)
        rows = torch.arange(b * d, device=cls.device)
        m = logits.shape[-1]
        return logits[rows, cls].float().reshape(b, d, m, m)
