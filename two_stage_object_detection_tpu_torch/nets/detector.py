"""FasterRCNN: the end-to-end detector (predict path).

The counterpart of the JAX package's ``nets/detector.py``, both branches:

* ``Config(fpn=True)``: ResNet (or strided HarDNet) trunk -> FPN neck ->
  shared RPN head over the anchor pyramid -> proposals (kernel 1, or
  kernel 3 on small inputs) -> windowed RoIAlign (kernel 2) and the 2-FC
  box head;
* ``Config(fpn=False)`` (the default ``Config()``: HarDNet-39): stride-16
  map -> 1x1 RPN head over ``make_anchors`` -> whole-table proposals
  (kernel 3) -> RoIPool max (kernel 5), a global mean and two dense heads.

Both end in the same per-class decode, score threshold and one
class-offset NMS (:meth:`FasterRCNN.detect`).  ``predict`` takes
``[B, H, W, 3]`` float images in [0, 1] and returns ``(boxes [B, D, 4],
scores [B, D], labels [B, D] (1-based), valid [B, D])`` with
``D = cfg.max_detections``, invalid slots zeroed.

``train_forward`` is not ported yet.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from two_stage_object_detection_tpu_torch.config import (
    Config, compute_dtype, resolve_device, use_kernels)
from two_stage_object_detection_tpu_torch.models.layers import init_weights
from two_stage_object_detection_tpu_torch.models.registry import build_backbone
from two_stage_object_detection_tpu_torch.nets.fpn import (
    FPNNeck, FPNRoIHead, FPNRPNHead)
from two_stage_object_detection_tpu_torch.nets.roi_head import RoIHead
from two_stage_object_detection_tpu_torch.nets.rpn import RPNHead
from two_stage_object_detection_tpu_torch.ops.anchors import (
    make_anchors, make_fpn_anchors)
from two_stage_object_detection_tpu_torch.ops.geometry import (
    clip_boxes, loc2bbox)
from two_stage_object_detection_tpu_torch.ops.nms import nms, topk_stable
from two_stage_object_detection_tpu_torch.ops.proposals import proposals_batched


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
        self.extractor, feat_channels = build_backbone(cfg.backbone, dtype,
                                                       pyramid=cfg.fpn)
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
        else:
            self.rpn_head = RPNHead(cfg.n_anchors_per_cell, feat_channels,
                                    dtype)
            self.roi_head = RoIHead(n_class, feat_channels, cfg.roi_size,
                                    cfg.roi_pool_mode, use_kernels(cfg), dtype)
            anchors = make_anchors(cfg)
        self.register_buffer("anchors", torch.from_numpy(anchors),
                             persistent=False)
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

    # ----------------------------------------------------------------- parts
    def features(self, images: torch.Tensor):
        """Backbone (+ FPN neck) on ``[B, H, W, 3]`` images: the stride-16
        map, or (P2..P6) with ``cfg.fpn``; NCHW."""
        taps = self.extractor(images.permute(0, 3, 1, 2))
        return self.neck(taps) if self.cfg.fpn else taps

    def _check_anchor_contract(self, n_locs: int):
        n_anchors = self.anchors.shape[0]
        if n_locs != n_anchors:
            raise ValueError(
                f"image size mismatch: the RPN produced {n_locs} anchor slots "
                f"but the anchor table built from cfg.input_size="
                f"{self.cfg.input_size} has {n_anchors}; pass images of "
                f"cfg.input_size or construct the model with a matching Config")

    def proposals(self, rpn_locs, rpn_scores, img_size, scale: float = 1.0):
        """Predict-time proposals: ``(rois, scores, valid)``, each ``[B, n_post, ...]``."""
        cfg = self.cfg
        self._check_anchor_contract(rpn_locs.shape[1])
        fg = torch.softmax(rpn_scores, dim=-1)[..., 1]
        return proposals_batched(
            rpn_locs, fg, self.anchors, tuple(img_size),
            nms_iou=cfg.rpn_nms_iou, n_post_nms=cfg.n_test_post_nms,
            min_size=cfg.proposal_min_size * scale,
            n_pre_nms=cfg.n_test_pre_nms, use_kernel=use_kernels(cfg))

    # --------------------------------------------------------------- predict
    @torch.inference_mode()
    def predict(self, images: torch.Tensor, scale: float = 1.0):
        """True inference: ``[B, H, W, 3] -> (boxes, scores, labels, valid)``."""
        return self.detect(self.features(images), tuple(images.shape[1:3]), scale)

    @torch.inference_mode()
    def detect(self, feats, img_size, scale: float = 1.0):
        """Everything after the backbone: RPN, proposals, box head, decode,
        class-offset NMS."""
        cfg = self.cfg
        rpn_locs, rpn_scores = self.rpn_head(feats)
        rois, _, roi_valid = self.proposals(rpn_locs, rpn_scores, img_size,
                                            scale)
        roi_cls_locs, roi_scores = self.roi_head(feats, rois, img_size)

        b, r = rois.shape[:2]
        n_class = cfg.num_classes + 1
        if cfg.loc_normalize:
            # per-class strided layout [R, C*4]: tile the stds across classes
            std = torch.tensor(cfg.loc_normalize_std, dtype=roi_cls_locs.dtype,
                               device=roi_cls_locs.device).repeat(n_class)
            roi_cls_locs = roi_cls_locs * std
        probs = torch.softmax(roi_scores, dim=-1)             # [B, R, C]
        n_cand = min(4 * cfg.max_detections, r * (n_class - 1))

        # decode every class at once, then ONE class-aware NMS over the
        # top-k (box, class) candidates, boxes offset by class
        boxes = clip_boxes(loc2bbox(rois, roi_cls_locs), img_size)
        boxes = boxes.reshape(b, r, n_class, 4)[:, :, 1:, :]  # drop background
        fg = probs[..., 1:]
        ok = roi_valid[..., None] & (fg >= cfg.score_thresh)
        flat_scores = torch.where(ok, fg, -1.0).reshape(b, -1)
        cand_scores, cand = topk_stable(flat_scores, n_cand)
        cand_boxes = torch.gather(boxes.reshape(b, -1, 4), 1,
                                  cand[..., None].expand(b, n_cand, 4))
        cand_labels = (cand % (n_class - 1) + 1).to(torch.int32)
        cand_valid = cand_scores > 0

        span = float(max(img_size)) + 2.0
        offset = cand_labels.to(torch.float32) * span
        idx, keep = nms(cand_boxes + offset[..., None], cand_scores,
                        cfg.predict_nms_iou, cfg.max_detections,
                        valid=cand_valid)
        kf = keep.to(torch.float32)
        det_boxes = torch.gather(cand_boxes, 1, idx[..., None].expand(
            *idx.shape, 4)) * kf[..., None]
        det_scores = torch.gather(cand_scores, 1, idx) * kf
        det_labels = torch.gather(cand_labels, 1, idx) * keep
        return det_boxes, det_scores, det_labels, keep
