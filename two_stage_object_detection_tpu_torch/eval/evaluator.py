"""Evaluation loop: device forward + host-side metric aggregation.

The port's copy of the JAX package's ``eval/evaluator.py``.  Equivalent of
reference ``FasterRCNNTrainer.eval_fn`` (``nets/frcnn_training.py:347-370``):
iterate the eval loader through the training graph (losses + per-sample
predictions, :func:`~..nets.trainer.eval_step`), apply per-class NMS to the
predictions, and accumulate mAP — with the metric math corrected
(:mod:`.metrics`).  A second mode evaluates the *true* inference path
(:func:`~..nets.trainer.predict_step`) instead.

Device outputs come to the host with ``.cpu().numpy()`` once a batch; over
a dataset held on the device (:class:`~..data.device_cache.DeviceDatasetCache`)
the whole pass runs first and its outputs come over in one copy
(:func:`~..nets.trainer.eval_scan_resident`).

On a data mesh over several ranks (``state.group``) every rank iterates the
same full eval set; each batch's rows are split over the ranks and the
predictions all-gathered (:func:`~..parallel.multiprocess.fetch_global`),
so every rank scores the same predictions and takes the same ``_best``
decision.  With image rows over the mesh's model axis the ranks of a
model group take the same rows of the batch, and the model splits each
image's rows over them (``FasterRCNN.features``); they compute the same
outputs, and the data group gathers them.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional, Sequence

import numpy as np
import torch

from two_stage_object_detection_tpu_torch.config import Config
from two_stage_object_detection_tpu_torch.data.device_cache import (
    DeviceDatasetCache)
from two_stage_object_detection_tpu_torch.eval.metrics import (
    compute_coco_summary, compute_map, compute_map_sweep)
from two_stage_object_detection_tpu_torch.nets.trainer import (
    TrainState, eval_scan_resident, eval_step, predict_step)
from two_stage_object_detection_tpu_torch.parallel.multiprocess import (
    fetch_global, rank, world_size)


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _per_class_nms_host(boxes, scores, labels, num_classes, iou_threshold):
    """Per-class greedy NMS on host numpy (small arrays post-forward).

    Vectorised: boxes are class-offset (cross-class IoU becomes exactly 0,
    the same trick the device predict path uses, ``nets/detector.py``), the
    full IoU matrix is computed once, and greedy suppression walks the
    score order masking whole rows — identical keeps to the per-class
    pop-loop formulation but ~40x less Python.  128 images x 128 rois of
    trainer-graph eval spent ~1.1 s here per sweep before this."""
    n = len(boxes)
    if n == 0:
        return np.zeros((0,), np.int64)
    # class offset: bands are sized from the ACTUAL coordinate range, not a
    # fixed 1e4 — train-graph eval boxes come from loc2bbox without
    # clip_boxes, so an early-training divergent decode (w*exp(dw)) can
    # exceed any fixed band and leak cross-class IoU (the device predict
    # path applies the same trick only after clip_boxes, so it can use a
    # fixed span)
    bb = boxes.astype(np.float64)
    lo = float(bb.min())
    span = max(1e4, float(bb.max()) - lo + 1.0)
    b = (bb - lo) + labels[:, None].astype(np.float64) * span
    order = np.argsort(-scores, kind="stable")
    b = b[order]
    tl = np.maximum(b[:, None, :2], b[None, :, :2])
    br = np.minimum(b[:, None, 2:], b[None, :, 2:])
    wh = np.clip(br - tl, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    iou = inter / (area[:, None] + area[None, :] - inter + 1e-8)
    # background (label 0) never participates: the per-class loop started
    # at class 1 (call sites pre-filter, but keep the contract here too)
    alive = labels[order] >= 1
    keep = []
    for i in range(n):
        if alive[i]:
            keep.append(order[i])
            alive &= iou[i] <= iou_threshold
    return np.asarray(sorted(keep), np.int64)


def _append_sample(preds, gts, boxes, scores, labels, valid,
                   gt_boxes, gt_labels, gt_valid, cfg: Config,
                   use_predict: bool, nms_iou_threshold: float):
    """Host post-processing for ONE image: validity filter, (train-graph
    mode) background drop + per-class NMS, GT unpadding."""
    v = np.asarray(valid)
    b = np.asarray(boxes)[v]
    s = np.asarray(scores)[v]
    l = np.asarray(labels)[v]
    if not use_predict:
        # drop background argmaxes, then per-class NMS
        # (reference frcnn_training.py:450-456)
        fg = l > 0
        b, s, l = b[fg], s[fg], l[fg]
        if len(b):
            keep = _per_class_nms_host(b, s, l, cfg.num_classes,
                                       nms_iou_threshold)
            b, s, l = b[keep], s[keep], l[keep]
    preds.append((b, s, l))
    gv = np.asarray(gt_valid)
    gts.append((np.asarray(gt_boxes)[gv], np.asarray(gt_labels)[gv] + 1))


def _batch_outputs(state: TrainState, batch, use_predict: bool):
    """``(loss or None, boxes, scores, labels, valid)`` of one whole batch,
    host numpy.  On a data mesh whose ranks divide the batch each rank runs
    its block of rows, and the outputs (the loss: a rank's mean, averaged)
    are gathered in rank order; otherwise every rank runs the whole batch."""
    group = state.group
    n = world_size(group) if group is not None else 1
    b = batch["image"].shape[0]
    split = n > 1 and b % n == 0
    if split:
        r = rank(group)
        batch = {k: v[r * b // n:(r + 1) * b // n] for k, v in batch.items()}
    if use_predict:
        # the box fields (a Mask R-CNN's masks are not scored here)
        loss, outs = None, predict_step(state, batch["image"])[:4]
    else:
        out = eval_step(state, batch)
        loss = out["losses"]["total"]
        outs = tuple(out[k] for k in ("boxes_pred", "classes_score_pred",
                                      "classes_pred", "pred_valid"))
    if split:
        got = fetch_global({"outs": outs} if loss is None
                           else {"outs": outs, "loss": loss}, group)
        loss = None if loss is None else float(np.mean(got["loss"]))
        return (loss, *got["outs"])
    return (None if loss is None else float(loss), *(_host(t) for t in outs))


def collect_predictions(state: TrainState, loader: Iterable, cfg: Config,
                        nms_iou_threshold: float = 0.7,
                        use_predict: bool = False,
                        max_batches: Optional[int] = None):
    """One device pass over the loader -> ``(preds, gts, avg_loss)``.

    Predictions do not depend on the mAP IoU threshold, so a threshold sweep
    only needs this once (the reference re-runs the full forward per
    threshold, ``train/train.py:97-103`` — 10x the device cost for identical
    predictions).

    ``use_predict=False`` mirrors the reference (train-graph forward with GT
    inputs, per-class NMS on the sampled-roi predictions); ``True`` evaluates
    the true inference path.  ``max_batches``: stop after that many batches
    (None: the whole loader).

    A :class:`~..data.device_cache.DeviceDatasetCache` loader takes the
    resident pass (:func:`~..nets.trainer.eval_scan_resident`): the same
    forwards over every batch, then one copy to the host; with
    ``max_batches``, or on a data mesh, it is iterated batch by batch like
    any loader, as in the JAX package.
    """
    preds, gts = [], []
    loss_total, n_batches = 0.0, 0
    if (isinstance(loader, DeviceDatasetCache) and max_batches is None
            and state.group is None):
        outs = eval_scan_resident(state, loader.data, loader.all_indices(),
                                  use_predict=use_predict)
        for bi in range(outs["loss_total"].shape[0]):
            if not use_predict:
                loss_total += float(outs["loss_total"][bi])
            for i in range(outs["boxes_pred"].shape[1]):
                _append_sample(
                    preds, gts, *(outs[k][bi][i] for k in (
                        "boxes_pred", "classes_score_pred", "classes_pred",
                        "pred_valid", "gt_boxes", "gt_labels", "gt_valid")),
                    cfg, use_predict, nms_iou_threshold)
        return preds, gts, loss_total / max(outs["loss_total"].shape[0], 1)
    for bi, batch in enumerate(loader):
        if max_batches is not None and bi >= max_batches:
            break
        loss, boxes, scores, labels, valid = _batch_outputs(state, batch,
                                                            use_predict)
        if loss is not None:
            loss_total += loss
        n_batches += 1

        gt_boxes, gt_labels, gt_valid = (
            _host(batch[k]) for k in ("boxes", "labels", "valid"))

        for i in range(boxes.shape[0]):
            _append_sample(preds, gts, boxes[i], scores[i], labels[i],
                           valid[i], gt_boxes[i], gt_labels[i], gt_valid[i],
                           cfg, use_predict, nms_iou_threshold)

    avg_loss = loss_total / max(n_batches, 1)
    return preds, gts, avg_loss


def evaluate(state: TrainState, loader: Iterable, cfg: Config,
             map_iou_threshold: float = 0.5, nms_iou_threshold: float = 0.7,
             use_predict: bool = False, max_batches: Optional[int] = None):
    """Run one eval pass -> ``(avg_loss, mAP, metrics_dict)``; at most
    ``max_batches`` batches when given.

    Equivalent of reference ``eval_fn`` (``nets/frcnn_training.py:347-370``).
    """
    preds, gts, avg_loss = collect_predictions(
        state, loader, cfg, nms_iou_threshold=nms_iou_threshold,
        use_predict=use_predict, max_batches=max_batches)
    metrics = compute_map(preds, gts, cfg.num_classes,
                          iou_threshold=map_iou_threshold)
    return avg_loss, metrics["mAP"], metrics


def evaluate_sweep(state: TrainState, loader_fn, cfg: Config,
                   thresholds: Sequence[float] = tuple(np.arange(0.5, 1.0, 0.05)),
                   coco_summary: bool = False, **kw) -> Dict[str, float]:
    """mAP@{.5, .95, .5:.95} sweep (reference ``train/train.py:97-117``).

    Forward-once: the device pass runs a single time and the matching is
    repeated per IoU threshold on host (the reference re-forwards the whole
    eval set per threshold — 10 device passes for the same predictions).

    ``loader_fn``: zero-arg callable returning a fresh eval iterator.
    ``coco_summary``: additionally attach the COCO-style axes (area-binned
    AP, AR@maxDets — :func:`..metrics.compute_coco_summary`) under
    ``"coco"``, computed from the same cached predictions.
    """
    preds, gts, eval_loss = collect_predictions(state, loader_fn(), cfg, **kw)
    maps = compute_map_sweep(preds, gts, cfg.num_classes, thresholds)
    total, m50, m95 = 0.0, 0.0, 0.0
    for t, m in maps.items():
        total += m
        if abs(t - 0.5) < 1e-6:
            m50 = m
        if abs(t - 0.95) < 1e-6:
            m95 = m
    n = len(maps)
    out = {"mAP50": m50, "mAP95": m95, "mAP50_95": total / n,
           "eval_loss": eval_loss}
    if coco_summary:
        out["coco"] = compute_coco_summary(preds, gts, cfg.num_classes)
    return out
