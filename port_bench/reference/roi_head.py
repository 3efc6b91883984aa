"""Single-scale RoI head: RoI pooling, a global mean, two dense heads.

The counterpart of the JAX package's ``nets/roi_head.py:RoIHead``, in its
three pooling modes: ``pool`` (RoIPool max, torchvision semantics),
``align`` (the matrix-product RoIAlign, ``ops/roi_pool.py:roi_align_mm``)
and ``mean`` (the masked mean over the RoIPool bins, ``roi_pool_mean``).
Rois arrive per image in image coordinates and are scaled to the map with
``[fw/img_w, fh/img_h, fw/img_w, fh/img_h]`` (f32, one multiply).

``align`` and ``mean`` pool in the map's dtype with plain matrix products,
as the JAX package does outside any Pallas kernel, and differentiate by
autograd; the rest of this docstring is about ``pool``.

The forward values come from kernel 5
(:func:`~..ops.roi_pool_max.roi_pool_max`) on a CUDA tensor with the
kernels on, whatever the route, and are f32.  The JAX package pools in the
map's dtype unless ``pallas_roi`` selects its kernel, which pools in f32;
max is exact in any float format, so every route gives the same values.
The plain masked max of the JAX package would broadcast to ``[R, P, H, W,
C]`` (99 GB at b=16 on a 38x38x512 map), which eager PyTorch cannot fuse
away.

The backward follows the JAX package's routing: ``pallas_roi=True`` scatters
the cotangent to kernel 5's saved argmax; otherwise ``roi_bwd`` picks the
rule, ``"pallas"`` (kernel 6: the first row-major maximum, recomputed),
``"structured"`` or ``"xla"`` (ties share evenly at each max stage), see
:mod:`~..ops.roi_pool_bwd`.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from .layers import Dense
from .geometry import device_constant
from .roi_pool import (
    roi_align_mm, roi_pool_mean)
from .roi_pool_bwd import BWD_MODES, roi_pool_recompute


POOL_MODES = ("pool", "align", "mean")


class RoIHead(nn.Module):
    """``(feats [B, C, H, W], rois [B, R, 4] image coords, img_size) ->
    (roi_cls_locs [B, R, n_class*4], roi_scores [B, R, n_class])``, f32."""

    def __init__(self, n_class: int, channels: int = 512, roi_size: int = 7,
                 pool_mode: str = "pool", dtype=torch.float32,
                 roi_bwd: str = "xla"):
        super().__init__()
        if pool_mode not in POOL_MODES:
            raise ValueError(f"roi_pool_mode must be one of {POOL_MODES}, "
                             f"got {pool_mode!r}")
        if roi_bwd not in BWD_MODES:
            raise ValueError(f"roi_bwd must be one of {BWD_MODES}, "
                             f"got {roi_bwd!r}")
        self.pool_mode = pool_mode
        self.roi_size, self.dtype, self.roi_bwd = roi_size, dtype, roi_bwd
        self.cls_loc = Dense(channels, n_class * 4, dtype)
        self.score = Dense(channels, n_class, dtype)

    def pool(self, feats: torch.Tensor, rois: torch.Tensor,
             img_size) -> torch.Tensor:
        """RoI pooling on the map -> ``[B, R, P, P, C]``: f32 for ``pool``,
        the map's dtype for ``align`` and ``mean``."""
        fh, fw = feats.shape[2:4]
        img_h, img_w = img_size
        scale = device_constant([fw / img_w, fh / img_h, fw / img_w, fh / img_h],
                                torch.float32, rois.device)
        rois_feat = (rois.to(torch.float32) * scale).contiguous()
        # NCHW with channels-last memory: the NHWC view is free
        nhwc = feats.permute(0, 2, 3, 1).contiguous()
        if self.pool_mode == "align":
            return roi_align_mm(nhwc, rois_feat, self.roi_size, 1.0)
        if self.pool_mode == "mean":
            return roi_pool_mean(nhwc, rois_feat, self.roi_size, 1.0)
        return roi_pool_recompute(nhwc, rois_feat, self.roi_size, 1.0,
                                  self.roi_bwd)

    def forward(self, feats: torch.Tensor, rois: torch.Tensor, img_size):
        pooled = self.pool(feats, rois, img_size)
        flat = pooled.mean(dim=(2, 3)).to(self.dtype)            # [B, R, C]
        return self.cls_loc(flat).float(), self.score(flat).float()
