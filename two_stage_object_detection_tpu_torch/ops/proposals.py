"""Batched RPN proposal generation with the hand-written kernels.

The counterpart of the JAX package's ``ops/pallas_proposals.py``, with its
two routes (:func:`proposals_batched` picks one as
``fused_proposals_batched`` does):

* **truncated** (``6 * n_pre_nms <= N``, the FPN predict and train shapes:
  3000 -> 300 and 12000 -> 600 of 90,090 anchors):
  decode, clip and min-size masking run over the whole anchor table in
  plain PyTorch, an exact top-``n_pre_nms`` cut (a stable sort: ties go to
  the lower index, as ``lax.top_k`` sends them) keeps the ``K`` best, and
  the greedy NMS over the ``[B, K]`` survivors runs in kernel 1
  (``csrc/nms.cu``, :func:`greedy_nms`);
* **whole table** (otherwise, the single-scale path and small FPN inputs):
  decode, clip, min-size mask and greedy NMS over all ``N`` anchors run in
  one launch of kernel 3 (``csrc/proposals.cu``,
  :func:`fused_proposals_batched`), no sort: each step takes the best
  alive score, lowest index on ties.  Its per-image form, kernel 4
  (:func:`fused_proposals`), is the same kernel launched with ``B = 1``;
  like the JAX package's ``_fused_kernel`` it is on neither the predict nor
  the train path.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from two_stage_object_detection_tpu_torch.ops import _cuda
from two_stage_object_detection_tpu_torch.ops.geometry import (
    clip_boxes, loc2bbox)
from two_stage_object_detection_tpu_torch.ops.nms import NEG_INF, topk_stable

# kernel 1 spreads an image over a cluster of up to NMS_MAX_CLUSTER blocks,
# each holding its share of the rows in tiles of NMS_TILE (16 bytes of box
# and one alive bit a row, in shared memory): 28,000 rows are 56 KB a block
NMS_TILE = 64
NMS_MAX_CLUSTER = 8
MAX_KERNEL_ROWS = 28000
# kernel 3 keeps every row's box (16 bytes) in one block's shared memory up
# to MAX_FUSED_SMEM_ROWS rows, and in a global scratch buffer above that, up
# to MAX_FUSED_ROWS (kSmemMaxRows and kMaxRows of csrc/proposals.cu)
MAX_FUSED_SMEM_ROWS = 14336
MAX_FUSED_ROWS = 32768


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


def nms_cluster_size(k: int) -> int:
    """Blocks of kernel 1's cluster for ``k`` rows per image: one per tile
    of ``NMS_TILE`` rows, at most ``NMS_MAX_CLUSTER``.  Raises outside
    ``1..MAX_KERNEL_ROWS``."""
    if not 0 < k <= MAX_KERNEL_ROWS:
        raise ValueError(f"greedy_nms kernel takes 1..{MAX_KERNEL_ROWS} rows "
                         f"per image, got {k}")
    return min(NMS_MAX_CLUSTER, -(-k // NMS_TILE))


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
    dev = boxes.device
    cluster = _nms_cluster(dev.index, b, k)
    out_boxes = torch.empty((b, n_post, 4), dtype=torch.float32, device=dev)
    out_scores = torch.empty((b, n_post), dtype=torch.float32, device=dev)
    out_valid = torch.empty((b, n_post), dtype=torch.bool, device=dev)
    fn = _nms_fn()
    with torch.cuda.device(dev):
        status = fn(boxes.data_ptr(), scores.data_ptr(), b, k, n_post,
                    iou_threshold, cluster, out_boxes.data_ptr(),
                    out_scores.data_ptr(), out_valid.data_ptr(),
                    _cuda.stream_handle(boxes))
    _cuda.check(status, "nms_launch")
    greedy_nms.launches += 1
    return out_boxes, out_scores, out_valid


greedy_nms.launches = 0


@functools.lru_cache(maxsize=None)
def _nms_cluster(device_index: int, b: int, k: int) -> int:
    """Blocks per image that let all ``b`` images run at once on this card,
    at most :func:`nms_cluster_size` (``csrc/nms.cu:nms_pick_cluster``)."""
    fn = _cuda.library("nms").nms_pick_cluster
    fn.argtypes = [ctypes.c_int] * 3
    fn.restype = ctypes.c_int
    with torch.cuda.device(device_index):
        return fn(b, k, nms_cluster_size(k))


def _nms_fn():
    fn = _cuda.library("nms").nms_launch
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + [
        ctypes.c_float, ctypes.c_int] + [ctypes.c_void_p] * 4
    fn.restype = ctypes.c_int
    return fn


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


def fused_proposals_batched(rpn_locs: torch.Tensor,
                            rpn_fg_scores: torch.Tensor, anchors: torch.Tensor,
                            img_size, *, nms_iou: float, n_post_nms: int,
                            min_size: float, use_kernel: bool = True):
    """Kernel 3: whole-table decode + clip + min-size mask + greedy NMS.

    Shapes as :func:`fused_proposals_rows_reference`.  On a CUDA tensor
    with ``use_kernel`` this launches ``csrc/proposals.cu`` (or raises, for
    instance above ``MAX_FUSED_ROWS`` anchors); on the CPU, or with
    ``use_kernel=False``, it runs the plain version.  Same outputs either
    way, bit for bit.
    """
    if not (use_kernel and rpn_locs.is_cuda):
        return fused_proposals_rows_reference(
            rpn_locs, rpn_fg_scores, anchors, img_size, nms_iou=nms_iou,
            n_post_nms=n_post_nms, min_size=min_size)
    out = _fused_launch(rpn_locs, rpn_fg_scores, anchors, img_size, nms_iou,
                        n_post_nms, min_size)
    fused_proposals_batched.launches += 1
    return out


fused_proposals_batched.launches = 0


def fused_proposals(rpn_locs: torch.Tensor, rpn_fg_scores: torch.Tensor,
                    anchors: torch.Tensor, img_size, *, nms_iou: float,
                    n_post_nms: int, min_size: float, use_kernel: bool = True):
    """Kernel 4: :func:`fused_proposals_batched` for one image, the same
    kernel launched with ``B = 1``.

    ``rpn_locs [N, 4]``, ``rpn_fg_scores [N]``, ``anchors [N, 4]`` ->
    ``(rois [n_post, 4], scores [n_post], valid [n_post])``.
    """
    locs, fg = rpn_locs[None], rpn_fg_scores[None]
    if not (use_kernel and rpn_locs.is_cuda):
        out = fused_proposals_rows_reference(
            locs, fg, anchors, img_size, nms_iou=nms_iou,
            n_post_nms=n_post_nms, min_size=min_size)
    else:
        out = _fused_launch(locs, fg, anchors, img_size, nms_iou, n_post_nms,
                            min_size)
        fused_proposals.launches += 1
    return tuple(t[0] for t in out)


fused_proposals.launches = 0


def _fused_launch(rpn_locs, rpn_fg_scores, anchors, img_size, nms_iou,
                  n_post, min_size):
    b, n, _ = rpn_locs.shape
    if not 0 < n <= MAX_FUSED_ROWS:
        raise ValueError(
            f"the fused proposal kernel takes 1..{MAX_FUSED_ROWS} anchors per "
            f"image (one block holds every score in registers), got {n}")
    locs = rpn_locs.float().contiguous()
    scores = rpn_fg_scores.float().contiguous()
    anchors = anchors.float().contiguous()
    _cuda.require(locs, "rpn_locs", torch.float32, (b, n, 4))
    _cuda.require(scores, "rpn_fg_scores", torch.float32, (b, n))
    _cuda.require(anchors, "anchors", torch.float32, (n, 4))
    dev = locs.device
    out_boxes = torch.empty((b, n_post, 4), dtype=torch.float32, device=dev)
    out_scores = torch.empty((b, n_post), dtype=torch.float32, device=dev)
    out_valid = torch.empty((b, n_post), dtype=torch.bool, device=dev)
    scratch = (torch.empty((b, n, 4), dtype=torch.float32, device=dev)
               if n > MAX_FUSED_SMEM_ROWS else None)
    fn = _fused_fn()
    img_h, img_w = img_size
    with torch.cuda.device(dev):
        status = fn(locs.data_ptr(), scores.data_ptr(), anchors.data_ptr(), b,
                    n, n_post, nms_iou, min_size, float(img_h), float(img_w),
                    out_boxes.data_ptr(), out_scores.data_ptr(),
                    out_valid.data_ptr(),
                    None if scratch is None else scratch.data_ptr(),
                    _cuda.stream_handle(locs))
    _cuda.check(status, "proposals_launch")
    return out_boxes, out_scores, out_valid


def _fused_fn():
    fn = _cuda.library("proposals").proposals_launch
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
                   + [ctypes.c_float] * 4 + [ctypes.c_void_p] * 5)
    fn.restype = ctypes.c_int
    return fn


def proposals_batched(rpn_locs: torch.Tensor, rpn_fg_scores: torch.Tensor,
                      anchors: torch.Tensor, img_size, *, nms_iou: float,
                      n_post_nms: int, min_size: float, n_pre_nms=None,
                      use_kernel: bool = True):
    """Proposals for a batch, on the route the JAX package takes.

    Args:
      rpn_locs: ``[B, N, 4]``.  rpn_fg_scores: ``[B, N]``.
      anchors: ``[N, 4]``.  img_size: ``(H, W)``.
      n_pre_nms: exact pre-NMS cut, engaged when ``6 * n_pre_nms <= N``
        (kernel 1); otherwise the whole table goes through kernel 3.

    Returns ``(rois [B, n_post, 4], scores [B, n_post], valid [B, n_post])``.
    """
    n = rpn_locs.shape[1]
    kw = dict(nms_iou=nms_iou, n_post_nms=n_post_nms, min_size=min_size,
              use_kernel=use_kernel)
    if n_pre_nms is None or 6 * n_pre_nms > n:
        return fused_proposals_batched(rpn_locs, rpn_fg_scores, anchors,
                                       img_size, **kw)
    roi, masked = _decode_masked(rpn_locs, rpn_fg_scores, anchors, img_size,
                                 min_size)
    top_scores, top_idx = topk_stable(masked, n_pre_nms)
    top_boxes = torch.gather(roi, 1, top_idx[..., None].expand(-1, -1, 4))
    return greedy_nms(top_boxes.contiguous(), top_scores.contiguous(),
                      n_post=n_post_nms, iou_threshold=nms_iou,
                      use_kernel=use_kernel)
