"""Detection metrics: PR curves, AP, mAP (host-side numpy).

The port's copy of the JAX package's ``eval/metrics.py``, unchanged numpy.

Correct re-implementation of the reference's evaluation intent.  The
reference's mAP path is broken as shipped (``frcnn_training.py:543`` loops
``range(1, n+1, -1)`` — never iterates; line 554 calls ``compute_ap`` with
two args against a one-arg signature; matching double-counts because a GT box
may match any number of predictions).  Here:

* :func:`filter_pr` / :func:`compute_ap` keep the reference utility API
  (``utils/utils.py:18-39``): precision-at-recall-level table, right-to-left
  monotonisation, rectangle integration;
* :func:`compute_map` does standard greedy matching — predictions sorted by
  score, each GT matched at most once — with per-class AP and mean over
  classes that have ground truth.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np


def _iou_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)), np.float32)
    tl = np.maximum(a[:, None, :2], b[None, :, :2])
    br = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(br - tl, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    return inter / (area_a[:, None] + area_b[None, :] - inter + 1e-8)


def filter_pr(x: np.ndarray, n_gt: int) -> np.ndarray:
    """Best precision at each recall level ``n_gt/n_gt .. 0/n_gt``.

    ``x``: ``[n, 2]`` rows of ``(precision, recall)``.  Returns
    ``[n_gt+1, 2]`` of ``(precision, recall)`` (reference
    ``utils/utils.py:18-23``).
    """
    if x.size == 0:
        return np.zeros((n_gt + 1, 2), np.float32)
    recalls = np.arange(n_gt, -1, -1, dtype=np.float32) / n_gt
    precisions = []
    for r in recalls:
        sel = x[:, 1] >= r - 1e-6
        precisions.append(float(x[sel, 0].max()) if sel.any() else 0.0)
    return np.stack([np.asarray(precisions, np.float32), recalls], axis=1)


def compute_ap(pr: np.ndarray) -> float:
    """Rectangle-integrate a PR table ordered by *descending* recall.

    Interpolated precision at recall ``r`` is ``max`` over points with
    recall >= ``r`` — rows 0..i for row i — i.e. a prefix max.  (The
    reference's ``compute_ap`` instead propagates the max from the *low*
    recall end, ``utils/utils.py:30-33``, which assigns the easy low-recall
    precision to recall levels the detector never reached and inflates AP —
    one of the metric defects fixed here.)  Each recall segment
    ``[r[i+1], r[i]]`` contributes its high-recall-end precision.
    """
    if len(pr) == 0:
        return 0.0
    prec = np.maximum.accumulate(pr[:, 0].astype(np.float64))
    rec = pr[:, 1]
    ap = 0.0
    for i in range(len(prec) - 1):
        ap += (rec[i] - rec[i + 1]) * prec[i]
    return float(ap)


def _ap_from_matches(scores: np.ndarray, is_tp: np.ndarray, n_gt: int) -> float:
    """AP from per-prediction (score, tp) pairs via the PR-table utilities."""
    if n_gt == 0:
        return 0.0
    order = np.argsort(-scores, kind="stable")
    tp = np.cumsum(is_tp[order])
    fp = np.cumsum(~is_tp[order])
    precision = tp / np.maximum(tp + fp, 1)
    recall = tp / n_gt
    pr = np.stack([precision, recall], axis=1).astype(np.float32)
    return compute_ap(filter_pr(pr, n_gt))


def compute_map(
    predictions: Sequence[Tuple[np.ndarray, np.ndarray, np.ndarray]],
    ground_truths: Sequence[Tuple[np.ndarray, np.ndarray]],
    num_classes: int,
    iou_threshold: float = 0.5,
) -> Dict:
    """mAP over foreground classes (labels 1..num_classes).

    Args:
      predictions: per image ``(boxes [n,4], scores [n], labels [n])``.
      ground_truths: per image ``(boxes [m,4], labels [m])`` — labels 1-based
        to match the trainer's background=0 contract.
      iou_threshold: match threshold.

    Returns:
      ``{"mAP", "class_metrics": {cls: {AP, Precision, Recall, TP, FP, FN}}}``
      (the reference's per-class result surface, ``frcnn_training.py:391-405``).
    """
    class_metrics = {}
    aps: List[float] = []
    for c in range(1, num_classes + 1):
        all_scores, all_tp = [], []
        n_gt_total = 0
        for (p_boxes, p_scores, p_labels), (g_boxes, g_labels) in zip(
                predictions, ground_truths):
            pm = p_labels == c
            gm = g_labels == c
            pb, ps = p_boxes[pm], p_scores[pm]
            gb = g_boxes[gm]
            n_gt_total += len(gb)
            if len(pb) == 0:
                continue
            order = np.argsort(-ps, kind="stable")
            iou = _iou_matrix(pb[order], gb)
            matched = np.zeros(len(gb), bool)
            tp_flags = np.zeros(len(pb), bool)
            for k in range(len(pb)):
                if len(gb) == 0:
                    break
                j = int(np.argmax(np.where(matched, -1.0, iou[k])))
                if iou[k, j] > iou_threshold and not matched[j]:
                    matched[j] = True
                    tp_flags[k] = True
            all_scores.append(ps[order])
            all_tp.append(tp_flags)

        scores = np.concatenate(all_scores) if all_scores else np.zeros(0)
        tps = np.concatenate(all_tp) if all_tp else np.zeros(0, bool)
        tp = int(tps.sum())
        fp = int((~tps).sum())
        fn = n_gt_total - tp
        ap = _ap_from_matches(scores, tps, n_gt_total)
        class_metrics[c] = {
            "AP": ap,
            "Precision": tp / (tp + fp) if tp + fp else 0.0,
            "Recall": tp / (tp + fn) if tp + fn else 0.0,
            "TP": tp, "FP": fp, "FN": fn, "n_gt": n_gt_total,
        }
        if n_gt_total > 0:
            # classes absent from the GT are excluded from the mean (the
            # reference appends 0 for them, frcnn_training.py:517-523 — a
            # defect that drags mAP toward 0 on sparse batches)
            aps.append(ap)

    return {"mAP": float(np.mean(aps)) if aps else 0.0,
            "class_metrics": class_metrics}


def compute_map_sweep(
    predictions: Sequence[Tuple[np.ndarray, np.ndarray, np.ndarray]],
    ground_truths: Sequence[Tuple[np.ndarray, np.ndarray]],
    num_classes: int,
    thresholds: Sequence[float],
) -> Dict[float, float]:
    """``{threshold: mAP}`` over several IoU thresholds, IoU computed once.

    Identical results to calling :func:`compute_map` per threshold — the
    per-(class, image) IoU matrices and score sorts do not depend on the
    threshold, so they are hoisted out of the sweep and only the tiny
    greedy matching repeats (the dominant host cost of
    ``evaluate_sweep``'s 10-threshold pass)."""
    per_class = []
    for c in range(1, num_classes + 1):
        items, n_gt_total = [], 0
        for (p_boxes, p_scores, p_labels), (g_boxes, g_labels) in zip(
                predictions, ground_truths):
            pm = p_labels == c
            gm = g_labels == c
            pb, ps, gb = p_boxes[pm], p_scores[pm], g_boxes[gm]
            n_gt_total += len(gb)
            if len(pb) == 0:
                continue
            order = np.argsort(-ps, kind="stable")
            items.append((ps[order], _iou_matrix(pb[order], gb)))
        per_class.append((items, n_gt_total))

    out = {}
    for t in (float(t) for t in thresholds):
        aps = []
        for items, n_gt_total in per_class:
            all_scores, all_tp = [], []
            for ps, iou in items:
                n_gb = iou.shape[1]
                matched = np.zeros(n_gb, bool)
                tp_flags = np.zeros(len(ps), bool)
                for k in range(len(ps)):
                    if n_gb == 0:
                        break
                    j = int(np.argmax(np.where(matched, -1.0, iou[k])))
                    if iou[k, j] > t and not matched[j]:
                        matched[j] = True
                        tp_flags[k] = True
                all_scores.append(ps)
                all_tp.append(tp_flags)
            if n_gt_total > 0:
                scores = (np.concatenate(all_scores) if all_scores
                          else np.zeros(0))
                tps = (np.concatenate(all_tp) if all_tp
                       else np.zeros(0, bool))
                aps.append(_ap_from_matches(scores, tps, n_gt_total))
        out[t] = float(np.mean(aps)) if aps else 0.0
    return out


# --------------------------------------------------------------- COCO-style
_AREA_RANGES = {
    "all": (0.0, float("inf")),
    "small": (0.0, 32.0 ** 2),
    "medium": (32.0 ** 2, 96.0 ** 2),
    "large": (96.0 ** 2, float("inf")),
}


def _match_class_coco(preds, gts, cls, iou_t, area_rng, max_dets):
    """COCO-semantics matching for one class across all images.

    GT boxes outside ``area_rng`` are *ignored*: they can absorb a matching
    prediction (which is then dropped from scoring) but never count toward
    ``n_gt`` or FP.  Matching considers non-ignored GTs first, so an
    above-threshold non-ignored match always beats a higher-IoU ignored one
    (pycocotools gt ordering).  A detection left unmatched whose *own* area
    is outside ``area_rng`` is also dropped rather than scored as FP
    (pycocotools ``dtIg``).  Detections are capped at ``max_dets`` per image
    by score.  Returns ``(scores, tp_flags, n_gt)`` over scored detections.
    """
    lo, hi = area_rng
    all_scores, all_tp = [], []
    n_gt = 0
    for (p_boxes, p_scores, p_labels), (g_boxes, g_labels) in zip(preds, gts):
        pm = p_labels == cls
        gm = g_labels == cls
        pb, ps = p_boxes[pm], p_scores[pm]
        gb = g_boxes[gm]
        g_area = ((gb[:, 2] - gb[:, 0]) * (gb[:, 3] - gb[:, 1])
                  if len(gb) else np.zeros(0))
        g_ign = (g_area < lo) | (g_area >= hi)
        n_gt += int((~g_ign).sum())

        order = np.argsort(-ps, kind="stable")[:max_dets]
        pb, ps = pb[order], ps[order]
        if len(pb) == 0:
            continue
        p_area = (pb[:, 2] - pb[:, 0]) * (pb[:, 3] - pb[:, 1])
        p_out = (p_area < lo) | (p_area >= hi)
        iou = _iou_matrix(pb, gb)
        matched = np.zeros(len(gb), bool)
        tp_flags = np.zeros(len(pb), bool)
        keep = np.ones(len(pb), bool)
        # non-ignored GTs first: an above-threshold non-ignored match must
        # win over any ignored GT regardless of IoU
        gt_order = list(np.flatnonzero(~g_ign)) + list(np.flatnonzero(g_ign))
        for k in range(len(pb)):
            best_j, best_iou, best_ign = -1, iou_t, True
            for j in gt_order:
                if matched[j] or iou[k, j] < best_iou:
                    continue
                if best_j >= 0 and not best_ign and g_ign[j]:
                    break   # already matched non-ignored; ignored can't improve
                best_j, best_iou, best_ign = j, iou[k, j], bool(g_ign[j])
            if best_j >= 0:
                matched[best_j] = True
                if best_ign:
                    keep[k] = False        # matched an ignored GT: drop
                else:
                    tp_flags[k] = True
            elif p_out[k]:
                keep[k] = False            # unmatched out-of-bin det: ignore
        all_scores.append(ps[keep])
        all_tp.append(tp_flags[keep])
    scores = np.concatenate(all_scores) if all_scores else np.zeros(0)
    tps = np.concatenate(all_tp) if all_tp else np.zeros(0, bool)
    return scores, tps, n_gt


def compute_coco_summary(
    predictions: Sequence[Tuple[np.ndarray, np.ndarray, np.ndarray]],
    ground_truths: Sequence[Tuple[np.ndarray, np.ndarray]],
    num_classes: int,
    iou_thresholds: Sequence[float] = tuple(np.arange(0.5, 1.0, 0.05)),
    max_dets: Sequence[int] = (1, 10, 100),
) -> Dict[str, float]:
    """COCO-style summary: AP/AP50/AP75, area-binned AP, AR@maxDets.

    Beyond the reference's surface (it reports mAP@{.5,.95,.5:.95} only,
    ``train/train.py:97-117``): standard COCO axes — area bins
    small/medium/large (32^2 / 96^2 px) with proper *ignore* semantics, and
    average recall at detection budgets.  AP integration uses this
    framework's recall-level table (:func:`filter_pr`/:func:`compute_ap`),
    not pycocotools' 101-point grid, so absolute values differ slightly
    from pycocotools on the same inputs; comparisons within this framework
    are consistent.
    """
    md = max(max_dets)
    ap_acc = {name: [] for name in _AREA_RANGES}    # over (iou, class)
    ap50, ap75 = [], []
    ar_acc = {f"AR{m}": [] for m in max_dets}
    ar_area = {name: [] for name in ("small", "medium", "large")}

    for c in range(1, num_classes + 1):
        for name, rng in _AREA_RANGES.items():
            per_iou_recall = []
            for t in iou_thresholds:
                scores, tps, n_gt = _match_class_coco(
                    predictions, ground_truths, c, float(t), rng, md)
                if n_gt == 0:
                    continue
                ap = _ap_from_matches(scores, tps, n_gt)
                ap_acc[name].append(ap)
                per_iou_recall.append(tps.sum() / n_gt)
                if name == "all":
                    if abs(t - 0.5) < 1e-6:
                        ap50.append(ap)
                    if abs(t - 0.75) < 1e-6:
                        ap75.append(ap)
            if name != "all" and per_iou_recall:
                ar_area[name].append(float(np.mean(per_iou_recall)))
        for m in max_dets:
            per_iou = []
            for t in iou_thresholds:
                _, tps, n_gt = _match_class_coco(
                    predictions, ground_truths, c, float(t),
                    _AREA_RANGES["all"], m)
                if n_gt:
                    per_iou.append(tps.sum() / n_gt)
            if per_iou:
                ar_acc[f"AR{m}"].append(float(np.mean(per_iou)))

    def mean(xs):
        return float(np.mean(xs)) if xs else 0.0

    out = {"AP": mean(ap_acc["all"]), "AP50": mean(ap50), "AP75": mean(ap75),
           "APsmall": mean(ap_acc["small"]), "APmedium": mean(ap_acc["medium"]),
           "APlarge": mean(ap_acc["large"]),
           "ARsmall": mean(ar_area["small"]),
           "ARmedium": mean(ar_area["medium"]),
           "ARlarge": mean(ar_area["large"])}
    for m in max_dets:
        out[f"AR{m}"] = mean(ar_acc[f"AR{m}"])
    return out
