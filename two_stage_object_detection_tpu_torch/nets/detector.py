"""FasterRCNN: the end-to-end detector (``predict`` and ``train_forward``).

The counterpart of the JAX package's ``nets/detector.py``, both branches:

* ``Config(fpn=True)``: ResNet (or strided HarDNet, or the Swin-T
  transformer of ``models/swin.py``) trunk -> FPN neck -> shared RPN head
  over the anchor pyramid -> proposals (kernel 1, or kernel 3 on small
  inputs) -> windowed RoIAlign (kernel 2) and the 2-FC box head;
* ``Config(fpn=False)`` (the default ``Config()``: HarDNet-39): stride-16
  map -> 1x1 RPN head over ``make_anchors`` -> whole-table proposals
  (kernel 3) -> RoIPool max (kernel 5), a global mean and two dense heads.

Both end in the same per-class decode, score threshold and one
class-offset NMS (:meth:`FasterRCNN.post_process`, kernel 1 on the card).
``predict`` takes ``[B, H, W, 3]`` float images in [0, 1] and returns
``(boxes [B, D, 4], scores [B, D], labels [B, D] (1-based), valid [B, D])``
with ``D = cfg.max_detections``, invalid slots zeroed.

With ``Config(mask_head=True)`` (FPN only) the model is Mask R-CNN:
:meth:`FasterRCNN.mask_predict` runs the mask head (``nets/fpn.py:
FPNMaskHead``) on the kept detections after ``detect``, and ``predict``
returns a fifth output, ``masks [B, D, M, M]``, the sigmoid of each
detection's class channel (``M = 2 * mask_roi_size``), zero where ``valid``
is False.  Training adds ``mask_loss`` on the positive sampled rois.

``train_forward`` takes a padded batch (images, ``gt_boxes [B, G, 4]``,
``gt_labels [B, G]`` 0-based, ``gt_valid [B, G]``) and returns the four
losses, their total and the trainer-parity predictions.  Proposals are cut
from the graph (their inputs are detached), the RoI head pools the sampled
rois on its train route (``Config.roi_bwd`` / ``pallas_roi`` for the
single-scale head, the hybrid RoIAlign for the FPN head), and batch norm
runs in the module's mode: :meth:`FasterRCNN.set_mode` puts the model in
train or eval mode and keeps a ``freeze_bn`` trunk on its running
statistics.  The model is built in eval mode; ``train_forward(train=True)``
and ``predict`` set the mode they need.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn as nn

from two_stage_object_detection_tpu_torch.config import (
    Config, compute_dtype, resolve_device, use_kernels)
from two_stage_object_detection_tpu_torch.models.layers import init_weights
from two_stage_object_detection_tpu_torch.models.registry import build_backbone
from two_stage_object_detection_tpu_torch.nets.fpn import (
    FPNMaskHead, FPNNeck, FPNRoIHead, FPNRPNHead)
from two_stage_object_detection_tpu_torch.nets.losses import (
    fast_rcnn_loc_loss, mask_loss, softmax_cross_entropy_with_ignore)
from two_stage_object_detection_tpu_torch.nets.roi_head import RoIHead
from two_stage_object_detection_tpu_torch.nets.rpn import RPNHead
from two_stage_object_detection_tpu_torch.nets.targets import (
    anchor_target, mask_targets, proposal_target)
from two_stage_object_detection_tpu_torch.ops.anchors import (
    make_anchors, make_fpn_anchors)
from two_stage_object_detection_tpu_torch.ops.geometry import (
    clip_boxes, device_constant, loc2bbox)
from two_stage_object_detection_tpu_torch.ops import proposals as proposal_ops
from two_stage_object_detection_tpu_torch.ops.nms import NEG_INF, topk_stable
from two_stage_object_detection_tpu_torch.ops.proposals import proposals_batched
from two_stage_object_detection_tpu_torch.parallel import spatial
from two_stage_object_detection_tpu_torch.utils.profiling import annotate


def class_offset_nms(cand_boxes, cand_scores, cand_labels, img_size, *,
                     iou_threshold: float, max_detections: int,
                     use_kernel: bool):
    """Greedy NMS over ``[B, N, 4]`` candidates sorted by score, descending,
    ties to the lower index (:func:`topk_stable`'s order), each class's
    boxes shifted by ``label * (max(img_size) + 2)`` so that boxes of two
    classes never overlap.  A candidate is valid where its score is above 0.

    One call of kernel 1 (:func:`~..ops.proposals.greedy_nms`, looked up
    at call time), whose fourth output is the kept rows' index: one launch
    on the kernel route, its plain version on the CPU or with
    ``use_kernel=False``.
    Invalid rows score ``NEG_INF`` and sort last, so the selection is
    :func:`~..ops.nms.nms`'s over the same candidates, index for index.
    Returns ``(index [B, max_detections] int64, 0 in slots not kept;
    keep [B, max_detections] bool)``.
    """
    span = float(max(img_size)) + 2.0
    offset = cand_labels.to(torch.float32) * span
    boxes = cand_boxes.to(torch.float32) + offset[..., None]
    scores = torch.where(cand_scores > 0, cand_scores.to(torch.float32),
                         NEG_INF)
    _, _, keep, index = proposal_ops.greedy_nms(
        boxes, scores, n_post=max_detections, iou_threshold=iou_threshold,
        use_kernel=use_kernel)
    return index.to(torch.int64), keep


class FasterRCNN(nn.Module):
    """Two-stage detector over a stride-16 map or an FPN pyramid.

    Args:
      cfg: the recipe (``cfg.fpn`` picks the branch).
      device: where the model lives; ``None`` takes ``cfg.device``.  A CUDA
        device with no GPU present raises.
      seed: initialisation seed (parameters are drawn on the CPU from a
        ``torch.Generator`` seeded with it, then moved).
    """

    def __init__(self, cfg: Config, device=None, seed: int = 0):
        super().__init__()
        self.cfg = cfg
        dev = resolve_device(cfg.device if device is None else device)
        dtype = compute_dtype(cfg)
        if cfg.mask_head and not cfg.fpn:
            raise ValueError("mask_head=True needs fpn=True: the mask head "
                             "pools from the FPN pyramid")
        self.extractor, feat_channels = build_backbone(
            cfg.backbone, dtype, remat=cfg.remat_backbone, pyramid=cfg.fpn)
        n_class = cfg.num_classes + 1
        if cfg.fpn:
            self.neck = FPNNeck(feat_channels, cfg.fpn_channels, dtype)
            self.rpn_head = FPNRPNHead(len(cfg.anchor_ratios),
                                       cfg.fpn_channels, dtype)
            self.roi_head = FPNRoIHead(
                n_class=n_class, channels=cfg.fpn_channels,
                roi_size=cfg.roi_size, min_level=cfg.fpn_min_level,
                n_pool_levels=cfg.fpn_max_level - cfg.fpn_min_level,
                canonical_level=cfg.fpn_canonical_level,
                canonical_size=cfg.fpn_canonical_size, fc_dim=cfg.fpn_fc_dim,
                window=cfg.fpn_roi_window, use_kernel=use_kernels(cfg),
                span_aware=cfg.fpn_span_aware, dtype=dtype)
            anchors = make_fpn_anchors(cfg)
            self.mask_head = None
            if cfg.mask_head:
                self.mask_head = FPNMaskHead(
                    n_fg_class=cfg.num_classes, channels=cfg.fpn_channels,
                    roi_size=cfg.mask_roi_size, dim=cfg.mask_dim,
                    n_convs=cfg.mask_convs, min_level=cfg.fpn_min_level,
                    n_pool_levels=cfg.fpn_max_level - cfg.fpn_min_level,
                    canonical_level=cfg.fpn_canonical_level,
                    canonical_size=cfg.fpn_canonical_size,
                    window=cfg.fpn_roi_window, use_kernel=use_kernels(cfg),
                    span_aware=cfg.fpn_span_aware, dtype=dtype)
        else:
            self.mask_head = None
            self.rpn_head = RPNHead(cfg.n_anchors_per_cell, feat_channels,
                                    dtype)
            self.roi_head = RoIHead(n_class, feat_channels, cfg.roi_size,
                                    cfg.roi_pool_mode, use_kernels(cfg), dtype,
                                    pallas_roi=cfg.pallas_roi,
                                    roi_bwd=cfg.roi_bwd)
            anchors = make_anchors(cfg)
        self.register_buffer("anchors", torch.from_numpy(anchors),
                             persistent=False)
        # image rows over a mesh's model axis (parallel/spatial.py), set by
        # parallel.mesh.place_train_state(spatial=True); None: whole images
        self.spatial = None
        init_weights(self, torch.Generator().manual_seed(seed))
        self.to(dev)
        if dev.type == "cuda":
            # NCHW logical, NHWC in memory: cuDNN's fast layout, and the
            # NHWC views of the maps for kernels 2 and 5 are free
            self.to(memory_format=torch.channels_last)
        self.eval()

    @property
    def device(self) -> torch.device:
        return self.anchors.device

    def set_mode(self, train: bool) -> "FasterRCNN":
        """Train or eval mode (batch-norm statistics, dropout); with
        ``cfg.freeze_bn`` the trunk stays on its running statistics while
        its weights still train."""
        self.train(train)
        if train and self.cfg.freeze_bn:
            self.extractor.eval()
        return self

    # ----------------------------------------------------------------- parts
    def features(self, images: torch.Tensor,
                 generator: Optional[torch.Generator] = None):
        """Backbone (+ FPN neck) on ``[B, H, W, 3]`` images: the stride-16
        map, or (P2..P6) with ``cfg.fpn``; NCHW.  ``generator`` feeds the
        train-mode dropout of HarDNet-85, the one backbone that has any.

        With :attr:`spatial` (image rows over the model axis) every rank
        of the model group runs the backbone and neck on its block of rows
        (``images`` are its data index's whole images, of which it takes
        its rows, or already its rows, ``parallel.mesh.shard_batch_spatial``),
        exchanging halos with the others, and then gathers the rows: every
        rank of a process group returns the whole maps; of an in-process
        group of threads (``Predictor(spatial=True)``) the lead alone does,
        and the others return None (``parallel.spatial.Shard.gather``)."""
        with annotate("tsod.features"):
            if self.spatial is None:
                return self.local_features(images, generator)
            h, w = self.cfg.input_size
            shard = self.spatial.shard(h, w)
            if images.shape[1] == h:
                images = shard.own_image_rows(images)
            with spatial.sharded(shard):
                local = self.local_features(images, generator)
            maps = shard.gather(local if self.cfg.fpn else (local,))
            return maps if maps is None or self.cfg.fpn else maps[0]

    def local_features(self, images: torch.Tensor,
                       generator: Optional[torch.Generator] = None):
        """:meth:`features` of the rows given, on the row shard active on
        this thread (``parallel.spatial.sharded``; none: whole images)."""
        taps = self.extractor(images.permute(0, 3, 1, 2), generator)
        return self.neck(taps) if self.cfg.fpn else taps

    def image_size(self, images: torch.Tensor):
        """``(H, W)`` of the images ``images`` belong to: their own, or
        with :attr:`spatial` those of ``cfg.input_size`` when ``images``
        are a rank's block of rows."""
        size = tuple(images.shape[1:3])
        if self.spatial is not None and size != tuple(self.cfg.input_size):
            h, w = self.cfg.input_size
            if size != (h // self.spatial.size, w):
                raise ValueError(
                    f"images of {size} are neither cfg.input_size {(h, w)} "
                    f"nor a rank's rows of it over {self.spatial.size}")
            return (h, w)
        return size

    def _check_anchor_contract(self, n_locs: int):
        n_anchors = self.anchors.shape[0]
        if n_locs != n_anchors:
            raise ValueError(
                f"image size mismatch: the RPN produced {n_locs} anchor slots "
                f"but the anchor table built from cfg.input_size="
                f"{self.cfg.input_size} has {n_anchors}; pass images of "
                f"cfg.input_size or construct the model with a matching Config")

    def proposals(self, rpn_locs, rpn_scores, img_size, scale: float = 1.0,
                  train: bool = False):
        """Proposals ``(rois, scores, valid)``, each ``[B, n_post, ...]``:
        ``n_test_pre_nms`` / ``n_test_post_nms`` of them, or the ``n_train``
        pair with ``train``."""
        cfg = self.cfg
        self._check_anchor_contract(rpn_locs.shape[1])
        fg = torch.softmax(rpn_scores, dim=-1)[..., 1]
        return proposals_batched(
            rpn_locs, fg, self.anchors, tuple(img_size),
            nms_iou=cfg.rpn_nms_iou,
            n_post_nms=cfg.n_train_post_nms if train else cfg.n_test_post_nms,
            min_size=cfg.proposal_min_size * scale,
            n_pre_nms=cfg.n_train_pre_nms if train else cfg.n_test_pre_nms,
            use_kernel=use_kernels(cfg))

    # ----------------------------------------------------------------- train
    def train_forward(self, images: torch.Tensor, gt_boxes: torch.Tensor,
                      gt_labels: torch.Tensor, gt_valid: torch.Tensor,
                      scale: float = 1.0, train: bool = True,
                      generator: Optional[torch.Generator] = None,
                      gt_polys: Optional[torch.Tensor] = None,
                      gt_poly_edges: Optional[torch.Tensor] = None
                      ) -> Dict[str, Any]:
        """Losses + predictions for one (padded) batch.

        Args:
          images: ``[B, H, W, 3]`` float32 in [0, 1].
          gt_boxes: ``[B, G, 4]`` xyxy, zero-padded; ``gt_valid``: ``[B, G]``.
          gt_labels: ``[B, G]`` integer, 0-based foreground classes.
          train: True for training (batch-statistics BN, 12000/600
            proposals); False for evaluation through the same graph
            (running-average BN, 3000/300 proposals, no statistics moved).
          generator: draws the target samplers' random priorities; None
            samples the first k in index order.
          gt_polys: ``[B, G, V, 2]`` f32 polygon vertices in image
            coordinates, and ``gt_poly_edges [B, G, V]`` bool, the edge from
            vertex ``v`` to ``v + 1`` lying inside one ring
            (:func:`~.targets.mask_targets`): the masks, needed with
            ``cfg.mask_head`` and read only then.  A gt with no valid edge
            (a crowd or RLE object) trains no mask.

        Returns a dict: ``losses`` (``rpn_loc``, ``rpn_cls``, ``roi_loc``,
        ``roi_cls``, with ``cfg.mask_head`` ``mask``, and ``total``), the
        per-sample ``boxes_pred``,
        ``classes_pred``, ``classes_score_pred``, ``pred_valid``, and the GT
        (labels shifted so that background is 0).
        """
        with annotate("tsod.train_forward"):
            cfg = self.cfg
            self.set_mode(train)
            img_size = self.image_size(images)
            feats = self.features(images, generator)
            with annotate("tsod.rpn_head"):
                rpn_locs, rpn_scores = self.rpn_head(feats)
            # proposals are samples, not a differentiable function: the RPN
            # learns through its own losses below
            with annotate("tsod.proposals"):
                rois, _, roi_valid = self.proposals(
                    rpn_locs.detach(), rpn_scores.detach(), img_size, scale,
                    train)

            gt_valid = gt_valid.to(torch.bool)
            with annotate("tsod.anchor_target"):
                gt_rpn_loc, gt_rpn_label = anchor_target(
                    self.anchors, gt_boxes, gt_valid,
                    n_sample=cfg.rpn_n_sample,
                    pos_iou_thresh=cfg.rpn_pos_iou_thresh,
                    neg_iou_thresh=cfg.rpn_neg_iou_thresh,
                    pos_ratio=cfg.rpn_pos_ratio, generator=generator)
            rpn_loc_loss = fast_rcnn_loc_loss(
                rpn_locs, gt_rpn_loc, gt_rpn_label, cfg.rpn_sigma).mean()
            rpn_cls_loss = softmax_cross_entropy_with_ignore(
                rpn_scores, gt_rpn_label).mean()

            with annotate("tsod.proposal_target"):
                (sample_roi, gt_roi_loc, gt_roi_label, sample_valid,
                 gt_index) = proposal_target(
                        rois, roi_valid, gt_boxes, gt_valid, gt_labels,
                        n_sample=cfg.roi_n_sample, pos_ratio=cfg.roi_pos_ratio,
                        pos_iou_thresh=cfg.roi_pos_iou_thresh,
                        neg_iou_thresh_high=cfg.roi_neg_iou_thresh_high,
                        neg_iou_thresh_low=cfg.roi_neg_iou_thresh_low,
                        loc_std=(cfg.loc_normalize_std if cfg.loc_normalize
                                 else None),
                        generator=generator)

            with annotate("tsod.roi_head"):
                if cfg.fpn:
                    # the hybrid route: windowed forward, dense backward
                    roi_cls_locs, roi_scores = self.roi_head(
                        feats, sample_roi, img_size, use_window=False)
                else:
                    roi_cls_locs, roi_scores = self.roi_head(feats, sample_roi,
                                                             img_size)
            b, s = sample_roi.shape[:2]
            locs4 = roi_cls_locs.reshape(b, s, -1, 4)
            # the GT class's regression
            roi_loc = torch.gather(
                locs4, 2,
                gt_roi_label[..., None, None].expand(b, s, 1, 4))[:, :, 0]

            # padding samples are ignored by the cross-entropy
            ce_labels = torch.where(sample_valid, gt_roi_label, -1)
            roi_loc_loss = fast_rcnn_loc_loss(
                roi_loc, gt_roi_loc,
                torch.where(sample_valid, gt_roi_label, 0),
                cfg.roi_sigma).mean()
            roi_cls_loss = softmax_cross_entropy_with_ignore(
                roi_scores, ce_labels).mean()
            total = rpn_loc_loss + rpn_cls_loss + roi_loc_loss + roi_cls_loss
            losses = {"rpn_loc": rpn_loc_loss, "rpn_cls": rpn_cls_loss,
                      "roi_loc": roi_loc_loss, "roi_cls": roi_cls_loss}
            if self.mask_head is not None:
                losses["mask"] = self._mask_loss(
                    feats, img_size, sample_roi, gt_roi_label, sample_valid,
                    gt_index, gt_polys, gt_poly_edges)
                total = total + losses["mask"]

            # trainer-parity predictions (un-normalised before the decode
            # when the head trains against normalised targets)
            dec_loc = roi_loc.detach()
            if cfg.loc_normalize:
                dec_loc = dec_loc * device_constant(
                    cfg.loc_normalize_std, dec_loc.dtype, dec_loc.device)
            probs = torch.softmax(roi_scores.detach(), dim=-1)
            classes_score_pred, classes_pred = probs.max(dim=-1)
            return {
                "losses": {**losses, "total": total},
                "boxes_pred": loc2bbox(sample_roi, dec_loc),    # [B, S, 4]
                "classes_pred": classes_pred,
                "classes_score_pred": classes_score_pred,
                "pred_valid": sample_valid,
                "gt_boxes": gt_boxes,
                "gt_labels": gt_labels + 1,                     # bg = 0
                "gt_valid": gt_valid,
            }

    def _mask_loss(self, feats, img_size, sample_roi, gt_roi_label,
                   sample_valid, gt_index, gt_polys, gt_poly_edges):
        """The mask head on the positive slots (the first ``roi_n_sample *
        roi_pos_ratio`` of each image, where :func:`proposal_target` puts
        the positives), through the hybrid route, against the matched
        polygons rasterised on each roi's grid."""
        cfg = self.cfg
        if gt_polys is None or gt_poly_edges is None:
            raise ValueError("mask_head=True trains on gt_polys and "
                             "gt_poly_edges; the batch has none")
        n_pos = int(cfg.roi_n_sample * cfg.roi_pos_ratio)
        rois, labels = sample_roi[:, :n_pos], gt_roi_label[:, :n_pos]
        index = gt_index[:, :n_pos]
        edges = gt_poly_edges.to(torch.bool)
        has_mask = torch.gather(edges.any(-1), 1, index)
        valid = sample_valid[:, :n_pos] & (labels > 0) & has_mask
        with annotate("tsod.mask_target"):
            target = mask_targets(gt_polys.to(torch.float32), edges, index,
                                  rois, cfg.mask_size)
        with annotate("tsod.mask_head"):
            logits = self.mask_head(feats, rois, labels, img_size,
                                    use_window=False)
        return mask_loss(logits, target, valid)

    # --------------------------------------------------------------- predict
    @torch.inference_mode()
    def predict(self, images: torch.Tensor, scale: float = 1.0):
        """True inference: ``[B, H, W, 3] -> (boxes, scores, labels,
        valid)``, and ``masks`` with ``cfg.mask_head``; None on a row shard
        that is not its thread group's lead (see :meth:`features`)."""
        if self.training:
            self.set_mode(False)
        feats = self.features(images)
        if feats is None:
            return None
        img_size = self.image_size(images)
        det = self.detect(feats, img_size, scale)
        if self.mask_head is None:
            return det
        return (*det, self.mask_predict(feats, det[0], det[2], det[3],
                                        img_size))

    @torch.inference_mode()
    def mask_predict(self, feats, boxes, labels, valid, img_size):
        """The mask head on given detections: ``boxes [B, D, 4]``, ``labels
        [B, D]`` 1-based and ``valid [B, D]`` -> ``[B, D, M, M]`` f32, the
        sigmoid of each detection's class channel, zero where ``valid`` is
        False.  Every slot runs, valid or not: no shape depends on the
        data."""
        with annotate("tsod.mask_head"):
            logits = self.mask_head(feats, boxes, labels, img_size)
            return torch.sigmoid(logits) * valid[..., None, None].to(
                logits.dtype)

    @torch.inference_mode()
    def detect(self, feats, img_size, scale: float = 1.0):
        """Everything after the backbone: RPN, proposals, box head, decode,
        class-offset NMS."""
        with annotate("tsod.detect"):
            cfg = self.cfg
            with annotate("tsod.rpn_head"):
                rpn_locs, rpn_scores = self.rpn_head(feats)
            with annotate("tsod.proposals"):
                rois, _, roi_valid = self.proposals(rpn_locs, rpn_scores,
                                                    img_size, scale)
            with annotate("tsod.roi_head"):
                roi_cls_locs, roi_scores = self.roi_head(feats, rois,
                                                         img_size)
            with annotate("tsod.post_process"):
                return self.post_process(rois, roi_valid, roi_cls_locs,
                                         roi_scores, img_size)

    def post_process(self, rois, roi_valid, roi_cls_locs, roi_scores,
                     img_size):
        """The tail of :meth:`detect`: decode every class of the box head's
        outputs, cut to the best ``4 * max_detections`` (box, class)
        candidates over the score threshold, and one class-offset NMS
        (:func:`class_offset_nms`)."""
        cfg = self.cfg
        b, r = rois.shape[:2]
        n_class = cfg.num_classes + 1
        if cfg.loc_normalize:
            # per-class strided layout [R, C*4]: tile the stds across classes
            std = device_constant(tuple(cfg.loc_normalize_std) * n_class,
                                  roi_cls_locs.dtype, roi_cls_locs.device)
            roi_cls_locs = roi_cls_locs * std
        probs = torch.softmax(roi_scores, dim=-1)     # [B, R, C]
        n_cand = min(4 * cfg.max_detections, r * (n_class - 1))

        # decode every class at once, then ONE class-aware NMS over the
        # top-k (box, class) candidates, boxes offset by class
        boxes = clip_boxes(loc2bbox(rois, roi_cls_locs), img_size)
        # drop the background
        boxes = boxes.reshape(b, r, n_class, 4)[:, :, 1:, :]
        fg = probs[..., 1:]
        ok = roi_valid[..., None] & (fg >= cfg.score_thresh)
        flat_scores = torch.where(ok, fg, -1.0).reshape(b, -1)
        cand_scores, cand = topk_stable(flat_scores, n_cand)
        cand_boxes = torch.gather(boxes.reshape(b, -1, 4), 1,
                                  cand[..., None].expand(b, n_cand, 4))
        cand_labels = (cand % (n_class - 1) + 1).to(torch.int32)

        idx, keep = class_offset_nms(
            cand_boxes, cand_scores, cand_labels, img_size,
            iou_threshold=cfg.predict_nms_iou,
            max_detections=cfg.max_detections, use_kernel=use_kernels(cfg))
        kf = keep.to(torch.float32)
        det_boxes = torch.gather(cand_boxes, 1, idx[..., None].expand(
            *idx.shape, 4)) * kf[..., None]
        det_scores = torch.gather(cand_scores, 1, idx) * kf
        det_labels = torch.gather(cand_labels, 1, idx) * keep
        return det_boxes, det_scores, det_labels, keep
