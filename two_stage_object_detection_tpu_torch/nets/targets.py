"""Training-target assignment with static shapes, batched over images.

The counterparts of the JAX package's ``nets/targets.py`` (per image there,
``vmap``-ed by the detector; here every function takes a leading batch
axis).  GT boxes arrive padded to a fixed ``max_gt`` with a validity mask.

Sampling keeps the first k candidates in index order when ``generator`` is
None, and draws uniform random priorities from the ``torch.Generator``
otherwise.  The random stream is torch's own: it selects the same *number*
of samples as the JAX package under a key, not the same ones.

Two things are written differently from the JAX source, for the GPU:

* a gt forces its best anchor positive and takes that anchor over; when
  several gts share a best anchor the highest gt index wins, as the JAX
  scatter resolves it.  A scatter with duplicate rows has no defined order
  on CUDA, so the winner is taken with an ``amax`` scatter-reduce of the gt
  index;
* the assigned gt box of each anchor is a row gather, exact in float32 (the
  JAX package uses a one-hot product at full precision for the TPU's sake).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from two_stage_object_detection_tpu_torch.ops.geometry import (
    bbox2loc, bbox_iou, device_constant)

BIG = 1 << 30


def _take_first_k(mask: torch.Tensor, k,
                  generator: Optional[torch.Generator]) -> torch.Tensor:
    """Keep at most ``k`` True entries along the last axis of ``mask``.

    First k in index order when ``generator`` is None, uniformly at random
    otherwise.  ``k``: an int or a ``[...]`` tensor (one count per row).
    """
    if generator is not None:
        # random priorities among the selected entries
        prio = torch.rand(mask.shape, generator=generator,
                          device=generator.device).to(mask.device)
        prio = torch.where(mask, prio, 2.0)
        rank = torch.argsort(torch.argsort(prio, dim=-1), dim=-1)
    else:
        rank = torch.cumsum(mask, dim=-1) - 1
    if isinstance(k, torch.Tensor):
        k = k[..., None]
    return mask & (rank < k)


def anchor_target(anchors: torch.Tensor, gt_boxes: torch.Tensor,
                  gt_valid: torch.Tensor, *, n_sample: int = 256,
                  pos_iou_thresh: float = 0.7, neg_iou_thresh: float = 0.3,
                  pos_ratio: float = 0.5,
                  generator: Optional[torch.Generator] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """RPN label / regression-target assignment.

    Args:
      anchors: ``[A, 4]``.
      gt_boxes: ``[B, G, 4]`` padded GT boxes.
      gt_valid: ``[B, G]`` bool mask of real GT rows.

    Returns ``(loc [B, A, 4] f32, label [B, A] int64)``; label is 1 positive,
    0 negative, -1 ignore.
    """
    b, g = gt_valid.shape
    a = anchors.shape[0]
    dev = anchors.device
    any_gt = gt_valid.any(dim=1)                                # [B]

    iou = bbox_iou(anchors, gt_boxes)                           # [B, A, G]
    iou = torch.where(gt_valid[:, None, :], iou, -1.0)
    max_ious, argmax_ious = iou.max(dim=2)                      # best gt per anchor

    label = torch.full((b, a), -1, dtype=torch.int64, device=dev)
    label = torch.where(max_ious < neg_iou_thresh, 0, label)
    label = torch.where(max_ious >= pos_iou_thresh, 1, label)

    # every valid gt forces its best anchor positive and takes it over; the
    # highest gt index wins a shared anchor.  Column ``a`` collects the
    # invalid gts and is dropped.
    gt_argmax = torch.where(gt_valid[:, None, :], iou,
                            -torch.inf).argmax(dim=1)           # [B, G]
    safe_rows = torch.where(gt_valid, gt_argmax, a)
    forced = torch.full((b, a + 1), -1, dtype=torch.int64, device=dev)
    forced.scatter_reduce_(1, safe_rows,
                           torch.arange(g, device=dev).expand(b, g), "amax")
    forced = forced[:, :a]
    label = torch.where(forced >= 0, 1, label)
    argmax_ious = torch.where(forced >= 0, forced, argmax_ious)

    # subsample: cap positives at pos_ratio * n_sample, fill with negatives
    n_pos_cap = int(pos_ratio * n_sample)
    pos = label == 1
    pos_keep = _take_first_k(pos, n_pos_cap, generator)
    label = torch.where(pos & ~pos_keep, -1, label)
    n_pos = pos.sum(dim=1).clamp(max=n_pos_cap)

    neg = label == 0
    neg_keep = _take_first_k(neg, n_sample - n_pos, generator)
    label = torch.where(neg & ~neg_keep, -1, label)

    assigned = torch.gather(gt_boxes, 1,
                            argmax_ious[..., None].expand(b, a, 4))
    loc = bbox2loc(anchors, assigned)
    # no valid gt: all-ignore labels, zero loc
    loc = torch.where(any_gt[:, None, None], loc, 0.0)
    label = torch.where(any_gt[:, None], label, -1)
    return loc, label


def proposal_target(rois: torch.Tensor, roi_valid: torch.Tensor,
                    gt_boxes: torch.Tensor, gt_valid: torch.Tensor,
                    gt_labels: torch.Tensor, *, n_sample: int = 128,
                    pos_ratio: float = 0.5, pos_iou_thresh: float = 0.5,
                    neg_iou_thresh_high: float = 0.5,
                    neg_iou_thresh_low: float = 0.0,
                    loc_std: Optional[Tuple[float, float, float, float]] = None,
                    generator: Optional[torch.Generator] = None):
    """RoI-head sample selection and targets.

    Args:
      rois: ``[B, R, 4]`` proposals (padded).  roi_valid: ``[B, R]``.
      gt_boxes: ``[B, G, 4]`` padded GT boxes; ``gt_valid``: ``[B, G]``.
      gt_labels: ``[B, G]`` class indices (0-based foreground classes).
      loc_std: optional per-coordinate stds that divide the regression
        targets (``Config.loc_normalize``).

    Returns ``(sample_roi [B, S, 4], gt_roi_loc [B, S, 4], gt_roi_label
    [B, S] int64, sample_valid [B, S], gt_index [B, S] int64)`` with ``S =
    n_sample``; labels are shifted by one so that background is 0,
    positives come first, and invalid slots are zero with ``sample_valid``
    False.  ``gt_index`` is the row of ``gt_boxes`` each sample is matched
    to (its best IoU; 0 in invalid slots), whose mask the mask head learns
    (:func:`mask_targets`).
    """
    b = rois.shape[0]
    dev = rois.device
    # GT boxes join the candidate pool
    pool = torch.cat([rois, gt_boxes], dim=1)                   # [B, R+G, 4]
    pool_valid = torch.cat([roi_valid, gt_valid], dim=1)

    iou = bbox_iou(pool, gt_boxes)                              # [B, R+G, G]
    iou = torch.where(gt_valid[:, None, :], iou, -1.0)
    max_iou, gt_assignment = iou.max(dim=2)
    max_iou = torch.where(pool_valid, max_iou, -1.0)
    roi_label = torch.gather(gt_labels.to(torch.int64), 1, gt_assignment) + 1

    pos = max_iou >= pos_iou_thresh
    neg = ((max_iou < neg_iou_thresh_high) & (max_iou >= neg_iou_thresh_low)
           & pool_valid)

    n_pos_cap = int(n_sample * pos_ratio)
    pos_keep = _take_first_k(pos, n_pos_cap, generator)
    n_pos = pos_keep.sum(dim=1)
    neg_keep = _take_first_k(neg, n_sample - n_pos, generator)

    # compact: positives first (index order), then negatives; the kept keys
    # are unique, and the stable sort leaves the BIG rest in index order
    n_pool = pool.shape[1]
    ar = torch.arange(n_pool, device=dev)
    sort_key = torch.where(pos_keep, ar,
                           torch.where(neg_keep, n_pool + ar, BIG))
    sel = torch.sort(sort_key, dim=1, stable=True)[1][:, :n_sample]

    def take(t):
        return torch.gather(t, 1, sel)

    sel4 = sel[..., None].expand(b, n_sample, 4)
    sample_roi = torch.gather(pool, 1, sel4)
    sample_valid = take(pos_keep | neg_keep)
    gt_index = take(gt_assignment)
    assigned = torch.gather(gt_boxes, 1,
                            gt_index[..., None].expand(b, n_sample, 4))
    gt_roi_loc = bbox2loc(sample_roi, assigned)
    if loc_std is not None:
        gt_roi_loc = gt_roi_loc / device_constant(loc_std, gt_roi_loc.dtype,
                                                  dev)
    # negatives (and padding) -> background label 0
    gt_roi_label = torch.where(take(pos_keep), take(roi_label), 0)
    gt_roi_label = torch.where(sample_valid, gt_roi_label, 0)
    vf = sample_valid[..., None].to(sample_roi.dtype)
    return (sample_roi * vf, gt_roi_loc * vf, gt_roi_label, sample_valid,
            torch.where(sample_valid, gt_index, 0))


def mask_targets(polys: torch.Tensor, edges: torch.Tensor,
                 gt_index: torch.Tensor, rois: torch.Tensor,
                 size: int) -> torch.Tensor:
    """Each roi's matched ground-truth polygon rasterised on the roi's own
    ``size x size`` grid, as Detectron's ``polys_to_mask_wrt_box`` does, by
    the even-odd rule at the bin centres.

    Args:
      polys: ``[B, G, V, 2]`` f32 vertices in image coordinates.
      edges: ``[B, G, V]`` bool: the edge from vertex ``v`` to ``v + 1``
        (mod ``V``) lies inside one ring.
      gt_index: ``[B, S]`` the row of each roi's polygon.
      rois: ``[B, S, 4]`` xyxy.

    Returns ``[B, S, size, size]`` f32 in {0, 1}: a bin is 1 where a ray
    from its centre ``(x1 + (j + 0.5) * w / size, y1 + (i + 0.5) * h /
    size)``, ``w, h`` the roi's sides (at least 1), crosses the polygon's
    valid edges an odd number of times (an edge counts where ``(y_a > y) !=
    (y_b > y)``, so a ray through a vertex crosses once).  One comparison of every bin with every edge:
    ``B * S * size^2 * V`` booleans (205 M at b=16, 128 positives, 28x28
    and 128 vertices).
    """
    b, s = gt_index.shape
    v = polys.shape[2]
    p = torch.gather(polys, 1, gt_index[..., None, None].expand(b, s, v, 2))
    e = torch.gather(edges, 1, gt_index[..., None].expand(b, s, v))
    xa, ya = p[..., 0], p[..., 1]                               # [B, S, V]
    xb, yb = torch.roll(xa, -1, dims=-1), torch.roll(ya, -1, dims=-1)
    x1, y1, x2, y2 = rois.to(torch.float32).unbind(-1)          # [B, S]
    w = torch.clamp(x2 - x1, min=1.0)
    h = torch.clamp(y2 - y1, min=1.0)
    g = (torch.arange(size, dtype=torch.float32, device=rois.device)
         + 0.5) / size
    ys = y1[..., None] + g * h[..., None]                       # [B, S, M]
    xs = x1[..., None] + g * w[..., None]
    # each row's crossing abscissa of each edge ([B, S, M, V])
    yq = ys[..., :, None]
    crosses = e[..., None, :] & ((ya[..., None, :] > yq)
                                 != (yb[..., None, :] > yq))
    dy = torch.where(crosses, (yb - ya)[..., None, :], 1.0)
    xint = xa[..., None, :] + (yq - ya[..., None, :]) * (
        (xb - xa)[..., None, :] / dy)
    xint = torch.where(crosses, xint, -torch.inf)
    # bins left of each crossing: [B, S, M (rows), M (columns), V]
    n = (xs[..., None, :, None] < xint[..., :, None, :]).sum(-1)
    return (n % 2).to(torch.float32)
