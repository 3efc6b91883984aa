"""Single-scale RPN head and static-shape proposal generation (batched).

The counterparts of the JAX package's ``nets/rpn.py``: ``RPNHead`` (two
1x1 convs, no shared 3x3 conv) and ``create_proposals`` (``vmap``-ed there
over images; a batch axis here).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from .layers import Conv
from .geometry import (
    clip_boxes, loc2bbox)
from .nms import (
    NEG_INF, nms_padded, topk_stable)


class RPNHead(nn.Module):
    """1x1 ``loc`` / ``score`` convs over the NCHW feature map.

    Returns ``rpn_locs [B, H*W*A, 4]`` and ``rpn_scores [B, H*W*A, 2]``,
    f32, flattened in NHWC order ``(y*W + x)*A + a``: the order of
    :func:`~..ops.anchors.make_anchors` (row-major grid, anchors innermost).
    """

    def __init__(self, n_anchors: int = 9, channels: int = 512,
                 dtype=torch.float32):
        super().__init__()
        self.loc = Conv(channels, n_anchors * 4, 1, compute_dtype=dtype)
        self.score = Conv(channels, n_anchors * 2, 1, compute_dtype=dtype)

    def forward(self, feats: torch.Tensor):
        b = feats.shape[0]
        # NCHW -> NHWC before flattening, so anchors stay innermost
        locs = self.loc(feats).permute(0, 2, 3, 1).reshape(b, -1, 4)
        scores = self.score(feats).permute(0, 2, 3, 1).reshape(b, -1, 2)
        return locs.float(), scores.float()


def create_proposals(rpn_locs: torch.Tensor, rpn_fg_scores: torch.Tensor,
                     anchors: torch.Tensor, img_size, *, nms_iou: float,
                     n_pre_nms: int, n_post_nms: int, min_size: float,
                     scale: float = 1.0):
    """Decode, clip, min-size mask, top-``n_pre_nms``, greedy NMS.

    Args:
      rpn_locs: ``[B, N, 4]`` deltas.  rpn_fg_scores: ``[B, N]``.
      anchors: ``[N, 4]``.  img_size: ``(H, W)``.
      min_size: minimum box side (times ``scale``); smaller boxes are
        masked by score, not filtered (static shapes).

    Returns ``(rois [B, n_post, 4], scores [B, n_post], valid [B, n_post])``.
    """
    roi = clip_boxes(loc2bbox(anchors, rpn_locs), img_size)
    ms = min_size * scale
    wh = roi[..., 2:4] - roi[..., 0:2]
    big_enough = (wh[..., 0] >= ms) & (wh[..., 1] >= ms)
    scores = torch.where(big_enough, rpn_fg_scores, NEG_INF)
    top_scores, top_idx = topk_stable(scores, min(n_pre_nms, roi.shape[-2]))
    top_boxes = torch.gather(roi, -2, top_idx[..., None].expand(
        *top_idx.shape, 4))
    valid = top_scores > NEG_INF / 2
    return nms_padded(top_boxes, top_scores, nms_iou, n_post_nms, valid=valid)
