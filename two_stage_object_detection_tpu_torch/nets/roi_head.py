"""Single-scale RoI head: RoIPool max, a global mean, two dense heads.

The counterpart of the JAX package's ``nets/roi_head.py:RoIHead`` in its
``pool`` mode (torchvision RoIPool semantics).  Rois arrive per image in
image coordinates and are scaled to the map with
``[fw/img_w, fh/img_h, fw/img_w, fh/img_h]`` (f32, one multiply).

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

The ``align`` and ``mean`` modes are not ported yet (ROADMAP.md).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from two_stage_object_detection_tpu_torch.models.layers import Dense
from two_stage_object_detection_tpu_torch.ops.roi_pool_bwd import (
    BWD_MODES, roi_pool_recompute)
from two_stage_object_detection_tpu_torch.ops.roi_pool_max import roi_pool_max


class RoIHead(nn.Module):
    """``(feats [B, C, H, W], rois [B, R, 4] image coords, img_size) ->
    (roi_cls_locs [B, R, n_class*4], roi_scores [B, R, n_class])``, f32."""

    def __init__(self, n_class: int, channels: int = 512, roi_size: int = 7,
                 pool_mode: str = "pool", use_kernel: bool = True,
                 dtype=torch.float32, pallas_roi: bool = False,
                 roi_bwd: str = "xla"):
        super().__init__()
        if pool_mode != "pool":
            raise NotImplementedError(
                f"roi_pool_mode={pool_mode!r} is not ported yet (ROADMAP.md, "
                "'Modules to port'); the port pools with 'pool'")
        if roi_bwd not in BWD_MODES:
            raise ValueError(f"roi_bwd must be one of {BWD_MODES}, "
                             f"got {roi_bwd!r}")
        self.roi_size, self.use_kernel, self.dtype = roi_size, use_kernel, dtype
        self.pallas_roi, self.roi_bwd = pallas_roi, roi_bwd
        self.cls_loc = Dense(channels, n_class * 4, dtype)
        self.score = Dense(channels, n_class, dtype)

    def pool(self, feats: torch.Tensor, rois: torch.Tensor,
             img_size) -> torch.Tensor:
        """RoIPool max on the map -> ``[B, R, P, P, C]`` f32."""
        fh, fw = feats.shape[2:4]
        img_h, img_w = img_size
        scale = torch.tensor([fw / img_w, fh / img_h, fw / img_w, fh / img_h],
                             dtype=torch.float32, device=rois.device)
        rois_feat = (rois.to(torch.float32) * scale).contiguous()
        # NCHW with channels-last memory: the NHWC view is free
        nhwc = feats.permute(0, 2, 3, 1).contiguous()
        if self.pallas_roi:
            return roi_pool_max(nhwc, rois_feat, self.roi_size, 1.0,
                                use_kernel=self.use_kernel,
                                with_argmax=False)[0]
        return roi_pool_recompute(nhwc, rois_feat, self.roi_size, 1.0,
                                  self.roi_bwd, self.use_kernel)

    def forward(self, feats: torch.Tensor, rois: torch.Tensor, img_size):
        pooled = self.pool(feats, rois, img_size)
        flat = pooled.mean(dim=(2, 3)).to(self.dtype)            # [B, R, C]
        return self.cls_loc(flat).float(), self.score(flat).float()
