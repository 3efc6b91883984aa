"""Static-shape greedy non-maximum suppression on torch tensors.

The counterpart of the JAX package's ``ops/nms.py`` select-and-suppress
``nms`` / ``nms_padded``, batched.  :func:`nms` sorts and hands the
selection to kernel 1 (:func:`~..ops.proposals.greedy_nms`: the
hand-written kernel on a CUDA float32 tensor, its plain version
elsewhere), whose steps keep the JAX semantics exactly:

* candidates are visited in stable descending score order (ties go to the
  lower index, as ``lax.top_k`` and a stable ``argsort`` send them);
* suppression is strict ``iou > thr``;
* IoU is ``inter / (area + barea - inter + 1e-8)`` in that order;
* outputs are padded to a fixed length with a validity mask, padding zeroed.

:func:`nms_keep_mask_sorted` is the JAX package's tiled sweep: the whole
keep mask of score-sorted boxes, for a caller that needs every survivor
rather than a top-k; no model path calls it.
"""

from __future__ import annotations

import torch

from two_stage_object_detection_tpu_torch.ops.geometry import bbox_iou

NEG_INF = -1e9


def topk_stable(x: torch.Tensor, k: int):
    """Top-``k`` along the last axis, descending, ties to the lower index.

    ``torch.topk`` on CUDA does not promise the tie order that ``lax.top_k``
    gives, so this is a stable sort cut to ``k``.
    """
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def nms(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float,
        max_output: int, valid: torch.Tensor | None = None):
    """Greedy NMS returning indices into the input, score-descending.

    Args:
      boxes: ``[B, N, 4]`` xyxy.
      scores: ``[B, N]``.
      iou_threshold: strict-greater suppression threshold.
      max_output: output length.
      valid: optional ``[B, N]`` bool mask of real (non-padding) inputs;
        the rest score ``NEG_INF`` and are never kept.

    Returns:
      ``(indices, keep_valid)``: ``[B, max_output]`` int64 indices (0 for
      padding slots) and the ``[B, max_output]`` bool mask of real slots.
    """
    # kernel 1's module imports this one; looked up at call time
    from two_stage_object_detection_tpu_torch.ops import proposals
    b, n, _ = boxes.shape
    if valid is not None:
        scores = torch.where(valid, scores, NEG_INF)
    order = torch.sort(-scores, dim=1, stable=True).indices
    _, _, keep, index = proposals.greedy_nms(
        torch.gather(boxes, 1, order[..., None].expand(b, n, 4)),
        torch.gather(scores, 1, order), n_post=max_output,
        iou_threshold=iou_threshold,
        use_kernel=boxes.dtype == scores.dtype == torch.float32)
    return torch.where(keep, torch.gather(order, 1, index.long()), 0), keep


def nms_padded(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float,
               n_post: int, valid: torch.Tensor | None = None):
    """NMS returning the kept boxes themselves, zero-padded to ``n_post``.

    Returns ``(boxes_out [B, n_post, 4], scores_out [B, n_post],
    valid_out [B, n_post])``.
    """
    idx, keep = nms(boxes, scores, iou_threshold, n_post, valid=valid)
    vf = keep.to(boxes.dtype)
    kept_boxes = torch.gather(boxes, -2, idx[..., None].expand(*idx.shape, 4))
    return (kept_boxes * vf[..., None], torch.gather(scores, -1, idx) * vf,
            keep)


def _self_suppress(tile: torch.Tensor, iou_threshold: float) -> torch.Tensor:
    """Greedy NMS within one score-sorted tile ``[T, 4]``: its alive mask,
    the fixpoint of "alive unless an earlier alive box overlaps it"."""
    iou = bbox_iou(tile, tile)
    idx = torch.arange(tile.shape[0], device=tile.device)
    can = (iou > iou_threshold) & (idx[:, None] < idx[None, :])
    alive = torch.ones(tile.shape[0], dtype=torch.bool, device=tile.device)
    while True:
        new = ~(can & alive[:, None]).any(dim=0)
        if torch.equal(new, alive):
            return alive
        alive = new


def nms_keep_mask_sorted(boxes_sorted: torch.Tensor, iou_threshold: float,
                         tile_size: int = 256) -> torch.Tensor:
    """Keep mask of boxes already sorted by descending score, tile by tile.

    ``boxes_sorted [n, 4]`` xyxy, ``n`` a multiple of ``tile_size`` (pad
    with zero boxes); suppression is strict ``iou > iou_threshold``.  Each
    tile is first cleared against the boxes kept in earlier tiles, then
    suppressed within itself; a suppressed box is zeroed.  Returns ``[n]``
    bool; zero-area padding rows come back True, so callers AND it with
    their own validity mask.
    """
    n = boxes_sorted.shape[0]
    if n % tile_size:
        raise ValueError(f"{n} boxes are not a multiple of tile_size "
                         f"{tile_size}")
    out = boxes_sorted.clone()
    for i in range(0, n, tile_size):
        tile = out[i:i + tile_size]
        for j in range(0, i, tile_size):
            dead = (bbox_iou(out[j:j + tile_size], tile)
                    > iou_threshold).any(dim=0)
            tile = tile * (~dead[:, None]).to(tile.dtype)
        alive = _self_suppress(tile, iou_threshold)
        out[i:i + tile_size] = tile * alive[:, None].to(tile.dtype)
    survived = (out != 0.0).any(dim=1)
    return survived | ~(boxes_sorted != 0.0).any(dim=1)
