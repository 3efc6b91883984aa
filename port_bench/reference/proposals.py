"""Batched RPN proposal generation, plain PyTorch.

Frozen from the port's ``ops/proposals.py``: its plain versions of kernels
1 and 3 (``greedy_nms_rows_reference``, ``fused_proposals_rows_reference``)
and the route choice of ``proposals_batched``, with the kernel launches
taken out.  The same outputs, bit for bit, as the port's plain route.
"""

from __future__ import annotations

import torch

from .geometry import clip_boxes, loc2bbox
from .nms import NEG_INF, topk_stable


def greedy_nms_rows_reference(boxes: torch.Tensor, scores: torch.Tensor, *,
                              n_post: int, iou_threshold: float):
    """Plain PyTorch version of kernel 1 (the JAX ``_greedy_nms_rows`` loop).

    ``n_post`` select-and-suppress steps over ``boxes [B, K, 4]`` /
    ``scores [B, K]``: each step takes the best still-alive score (first
    index on ties), emits it (valid where ``score > NEG_INF/2``), and kills
    every box with ``iou > thr`` and itself.  Returns ``(boxes [B, n_post,
    4], scores [B, n_post], valid [B, n_post])``, invalid slots zeroed.
    """
    b, _, _ = boxes.shape
    x1, y1, x2, y2 = boxes.unbind(-1)
    area = (x2 - x1) * (y2 - y1)
    thr = torch.tensor(iou_threshold, dtype=torch.float32, device=boxes.device)
    rows = torch.arange(b, device=boxes.device)
    s_alive = scores.clone()
    out_boxes = torch.zeros((b, n_post, 4), dtype=boxes.dtype, device=boxes.device)
    out_scores = torch.zeros((b, n_post), dtype=scores.dtype, device=boxes.device)
    out_valid = torch.zeros((b, n_post), dtype=torch.bool, device=boxes.device)
    for k in range(n_post):
        i = torch.argmax(s_alive, dim=1)
        sc = s_alive[rows, i]
        valid = sc > NEG_INF / 2
        sel = boxes[rows, i]                                   # [B, 4]
        ix1 = torch.maximum(x1, sel[:, 0:1])
        iy1 = torch.maximum(y1, sel[:, 1:2])
        ix2 = torch.minimum(x2, sel[:, 2:3])
        iy2 = torch.minimum(y2, sel[:, 3:4])
        inter = (torch.clamp(ix2 - ix1, min=0.0)
                 * torch.clamp(iy2 - iy1, min=0.0))
        iou = inter / (area + area[rows, i][:, None] - inter + 1e-8)
        suppress = iou > thr
        suppress[rows, i] = True
        s_alive = torch.where(suppress, NEG_INF, s_alive)
        vf = valid.to(boxes.dtype)
        out_boxes[:, k] = sel * vf[:, None]
        out_scores[:, k] = sc * vf
        out_valid[:, k] = valid
    return out_boxes, out_scores, out_valid


def _decode_masked(rpn_locs, rpn_fg_scores, anchors, img_size, min_size):
    """Decode + clip, and scores with rows under ``min_size`` set to NEG."""
    roi = clip_boxes(loc2bbox(anchors, rpn_locs.float()), img_size)
    wh = roi[..., 2:4] - roi[..., 0:2]
    ok = (wh[..., 0] >= min_size) & (wh[..., 1] >= min_size)
    return roi, torch.where(ok, rpn_fg_scores.float(), NEG_INF)


def fused_proposals_rows_reference(rpn_locs: torch.Tensor,
                                   rpn_fg_scores: torch.Tensor,
                                   anchors: torch.Tensor, img_size, *,
                                   nms_iou: float, n_post_nms: int,
                                   min_size: float):
    """Plain PyTorch version of kernels 3 and 4 (the JAX ``_batched_kernel``).

    Decodes every row as the kernel does (``cx = dx*aw + acx``,
    ``w = exp(dw)*aw``, clip to ``[0, W]`` / ``[0, H]``, scores of rows with
    a side under ``min_size`` set to NEG), then runs ``n_post_nms``
    argmax/suppress steps over all ``N`` rows: the steps of
    :func:`greedy_nms_rows_reference`, without a sort.

    ``rpn_locs [B, N, 4]``, ``rpn_fg_scores [B, N]``, ``anchors [N, 4]`` ->
    ``(rois [B, n_post, 4], scores [B, n_post], valid [B, n_post])``.
    """
    roi, masked = _decode_masked(rpn_locs, rpn_fg_scores, anchors, img_size,
                                 min_size)
    return greedy_nms_rows_reference(roi, masked, n_post=n_post_nms,
                                     iou_threshold=nms_iou)


def proposals_batched(rpn_locs: torch.Tensor, rpn_fg_scores: torch.Tensor,
                      anchors: torch.Tensor, img_size, *, nms_iou: float,
                      n_post_nms: int, min_size: float, n_pre_nms=None):
    """Proposals for a batch, on the route the JAX package takes.

    Args:
      rpn_locs: ``[B, N, 4]``.  rpn_fg_scores: ``[B, N]``.
      anchors: ``[N, 4]``.  img_size: ``(H, W)``.
      n_pre_nms: exact pre-NMS cut, engaged when ``6 * n_pre_nms <= N``;
        otherwise the whole table is walked.

    Returns ``(rois [B, n_post, 4], scores [B, n_post], valid [B, n_post])``.
    """
    n = rpn_locs.shape[1]
    if n_pre_nms is None or 6 * n_pre_nms > n:
        return fused_proposals_rows_reference(
            rpn_locs, rpn_fg_scores, anchors, img_size, nms_iou=nms_iou,
            n_post_nms=n_post_nms, min_size=min_size)
    roi, masked = _decode_masked(rpn_locs, rpn_fg_scores, anchors, img_size,
                                 min_size)
    top_scores, top_idx = topk_stable(masked, n_pre_nms)
    top_boxes = torch.gather(roi, 1, top_idx[..., None].expand(-1, -1, 4))
    return greedy_nms_rows_reference(top_boxes.contiguous(),
                                     top_scores.contiguous(), n_post=n_post_nms,
                                     iou_threshold=nms_iou)
