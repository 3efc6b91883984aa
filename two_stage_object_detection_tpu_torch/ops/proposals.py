"""Batched RPN proposal generation with the hand-written greedy-NMS kernel.

The counterpart of the JAX package's ``ops/pallas_proposals.py``:
decode, clip and min-size masking run over the whole anchor table in plain
PyTorch, an exact top-``n_pre_nms`` cut (a stable sort: ties go to the lower
index, as ``lax.top_k`` sends them) keeps the ``K`` best, and the greedy
NMS over the ``[B, K]`` survivors runs in ``csrc/nms.cu``
(:func:`greedy_nms`).  The cut applies where it shrinks the table at least
6x, as in the JAX package (``6 * n_pre_nms <= N``); otherwise the same
kernel runs over all ``N`` boxes sorted by score, which is what the JAX
package's fused whole-table kernel computes.
"""

from __future__ import annotations

import ctypes

import torch

from two_stage_object_detection_tpu_torch.ops import _cuda
from two_stage_object_detection_tpu_torch.ops.geometry import (
    clip_boxes, loc2bbox)
from two_stage_object_detection_tpu_torch.ops.nms import NEG_INF, topk_stable

# the scan kernel keeps one 8-byte mask word per row in shared memory
MAX_KERNEL_ROWS = 28000


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


def greedy_nms(boxes: torch.Tensor, scores: torch.Tensor, *, n_post: int,
               iou_threshold: float, use_kernel: bool = True):
    """Kernel 1: greedy NMS over score-sorted ``boxes [B, K, 4]`` f32.

    The rows must be sorted by score, descending, ties by lower index (what
    :func:`~..ops.nms.topk_stable` gives).  On a CUDA tensor with
    ``use_kernel`` this launches ``csrc/nms.cu`` (or raises); on the CPU, or
    with ``use_kernel=False``, it runs :func:`greedy_nms_rows_reference`.
    Same outputs either way, bit for bit.
    """
    if not (use_kernel and boxes.is_cuda):
        return greedy_nms_rows_reference(boxes, scores, n_post=n_post,
                                         iou_threshold=iou_threshold)
    b, k, _ = boxes.shape
    _cuda.require(boxes, "boxes", torch.float32, (b, k, 4))
    _cuda.require(scores, "scores", torch.float32, (b, k))
    if not 0 < k <= MAX_KERNEL_ROWS:
        raise ValueError(f"greedy_nms kernel takes 1..{MAX_KERNEL_ROWS} rows "
                         f"per image, got {k}")
    dev = boxes.device
    n_words = (k + 63) // 64
    mask = torch.empty((b, k, n_words), dtype=torch.int64, device=dev)
    out_boxes = torch.empty((b, n_post, 4), dtype=torch.float32, device=dev)
    out_scores = torch.empty((b, n_post), dtype=torch.float32, device=dev)
    out_valid = torch.empty((b, n_post), dtype=torch.bool, device=dev)
    fn = _nms_fn()
    with torch.cuda.device(dev):
        status = fn(boxes.data_ptr(), scores.data_ptr(), mask.data_ptr(),
                    b, k, n_post, iou_threshold, out_boxes.data_ptr(),
                    out_scores.data_ptr(), out_valid.data_ptr(),
                    _cuda.stream_handle(boxes))
    _cuda.check(status, "nms_launch")
    greedy_nms.launches += 1
    return out_boxes, out_scores, out_valid


greedy_nms.launches = 0


def _nms_fn():
    fn = _cuda.library("nms").nms_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [
        ctypes.c_float] + [ctypes.c_void_p] * 4
    fn.restype = ctypes.c_int
    return fn


def proposals_batched(rpn_locs: torch.Tensor, rpn_fg_scores: torch.Tensor,
                      anchors: torch.Tensor, img_size, *, nms_iou: float,
                      n_post_nms: int, min_size: float, n_pre_nms=None,
                      use_kernel: bool = True):
    """Whole-batch decode + clip + min-size mask + top-K + greedy NMS.

    Args:
      rpn_locs: ``[B, N, 4]``.  rpn_fg_scores: ``[B, N]``.
      anchors: ``[N, 4]``.  img_size: ``(H, W)``.
      n_pre_nms: exact pre-NMS cut, engaged when ``6 * n_pre_nms <= N``.

    Returns ``(rois [B, n_post, 4], scores [B, n_post], valid [B, n_post])``.
    """
    n = rpn_locs.shape[1]
    roi = clip_boxes(loc2bbox(anchors, rpn_locs.float()), img_size)
    wh = roi[..., 2:4] - roi[..., 0:2]
    ok = (wh[..., 0] >= min_size) & (wh[..., 1] >= min_size)
    masked = torch.where(ok, rpn_fg_scores.float(), NEG_INF)
    k = n_pre_nms if n_pre_nms is not None and 6 * n_pre_nms <= n else n
    top_scores, top_idx = topk_stable(masked, k)
    top_boxes = torch.gather(roi, 1, top_idx[..., None].expand(-1, -1, 4))
    return greedy_nms(top_boxes.contiguous(), top_scores.contiguous(),
                      n_post=n_post_nms, iou_threshold=nms_iou,
                      use_kernel=use_kernel)
