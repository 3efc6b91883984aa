"""The recipe of the reference detector.

Frozen from the port's ``config.py``: the same field names and defaults,
so one configuration file builds both sides; ``pallas``, ``pallas_roi``
and ``device`` are read by nothing here.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class Config:
    """All framework hyper-parameters (training recipe + network contract).

    See the JAX package's ``config.py`` for the meaning of each field.
    """

    # ---- public config.json surface ----
    num_epochs: int = 2
    lr: float = 1e-3
    train_ratio: float = 0.0001
    eval_ratio: float = 0.001
    device: str = "cuda"
    num_workers: int = 12
    prefetch_factor: int = 8
    persistent_workers: bool = True
    batch_size: int = 16

    # ---- network contract ----
    num_classes: int = 80
    input_size: Tuple[int, int] = (600, 600)        # (H, W)
    feat_stride: int = 16
    anchor_base_size: int = 8
    anchor_ratios: Sequence[float] = (0.5, 1.0, 2.0)
    anchor_scales: Sequence[float] = (8.0, 16.0, 32.0)

    # proposal generation
    rpn_nms_iou: float = 0.7
    n_train_pre_nms: int = 12000
    n_train_post_nms: int = 600
    n_test_pre_nms: int = 3000
    n_test_post_nms: int = 300
    proposal_min_size: float = 16.0

    # target assignment
    rpn_n_sample: int = 256
    rpn_pos_iou_thresh: float = 0.7
    rpn_neg_iou_thresh: float = 0.3
    rpn_pos_ratio: float = 0.5
    roi_n_sample: int = 128
    roi_pos_ratio: float = 0.5
    roi_pos_iou_thresh: float = 0.5
    roi_neg_iou_thresh_high: float = 0.5
    roi_neg_iou_thresh_low: float = 0.0
    loc_normalize: bool = False
    loc_normalize_std: Tuple[float, float, float, float] = (0.1, 0.1, 0.2, 0.2)

    # head
    roi_size: int = 7
    roi_pool_mode: str = "pool"

    # inference
    score_thresh: float = 0.05
    predict_nms_iou: float = 0.1
    max_detections: int = 100
    backbone: str = "hardnet39"
    backbone_channels: int = 512

    # ---- FPN variant ----
    fpn: bool = False
    fpn_channels: int = 256
    fpn_anchor_scale: float = 8.0
    fpn_min_level: int = 2
    fpn_max_level: int = 6
    fpn_canonical_level: int = 4
    fpn_canonical_size: float = 224.0
    fpn_fc_dim: int = 1024
    fpn_roi_window: int = 32
    fpn_span_aware: bool = True

    # losses
    rpn_sigma: float = 1.0
    roi_sigma: float = 1.0
    grad_accum_steps: int = 32
    weight_decay: float = 1e-4
    cosine_t_max: int = 5
    freeze_bn: bool = False

    # data pipeline
    max_gt_boxes: int = 100
    worker_mode: str = "thread"
    device_augment: bool = False
    cache_decoded: bool = False
    cache_max_bytes: int = 4 << 30
    cache_device: bool = False
    cache_device_max_bytes: int = 8 << 30
    transfer_uint8: bool = False
    fused_accum: bool = False
    augment: bool = True

    # execution
    compute_dtype: str = "bfloat16"   # conv/dense compute dtype; params stay f32
    mesh_data_axis: str = "data"
    mesh_model_axis: str = "model"
    pallas: str = "auto"              # hand-written kernels: auto | on | off
    pallas_roi: bool = False
    roi_bwd: str = "xla"
    remat_backbone: bool = False
    compilation_cache: str = ""

    @property
    def n_anchors_per_cell(self) -> int:
        return len(self.anchor_ratios) * len(self.anchor_scales)

    @property
    def feat_size(self) -> Tuple[int, int]:
        """Feature-map (H, W) after four ceil-halving stride-2 stages."""
        h, w = self.input_size
        for _ in range(4):
            h = (h + 1) // 2
            w = (w + 1) // 2
        return (h, w)

    @property
    def num_anchors(self) -> int:
        fh, fw = self.feat_size
        return fh * fw * self.n_anchors_per_cell

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


def compute_dtype(cfg: Config) -> torch.dtype:
    if cfg.compute_dtype not in ("bfloat16", "float32"):
        raise ValueError(f"compute_dtype must be 'bfloat16' or 'float32', "
                         f"got {cfg.compute_dtype!r}")
    return torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32
