"""Static-shape RPN proposal generation (plain PyTorch, batched).

The counterpart of the JAX package's ``nets/rpn.py:create_proposals``
(``vmap``-ed there over images; a batch axis here).  ``RPNHead`` belongs to
the single-scale path, which is not ported yet.
"""

from __future__ import annotations

import torch

from two_stage_object_detection_tpu_torch.ops.geometry import (
    clip_boxes, loc2bbox)
from two_stage_object_detection_tpu_torch.ops.nms import (
    NEG_INF, nms_padded, topk_stable)


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
