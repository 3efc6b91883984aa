"""Single-source configuration of the PyTorch port.

Field for field the JAX package's ``Config``: the same names and defaults,
so one recipe drives both packages.  Three things differ:

* ``device`` defaults to ``"cuda"``: entry points run on the GPU unless the
  caller passes ``device="cpu"``, and with no GPU present they raise rather
  than fall back (:func:`resolve_device`).
* ``pallas`` keeps its name and values as the hand-written-kernel switch:
  ``"auto"`` and ``"on"`` launch the CUDA kernels for CUDA tensors, ``"off"``
  selects the plain PyTorch versions on any device.  On the CPU only the
  plain versions exist.
* the port alone has Mask R-CNN's mask branch (:data:`MASK_FIELDS`, last,
  off by default): ``mask_head`` adds, after the box NMS, RoIAlign at
  ``mask_roi_size`` on the kept detections, ``mask_convs`` 3x3
  convolutions ``mask_dim`` wide, a 2x2 stride-2 transposed convolution and
  a 1x1 predictor to one ``2 * mask_roi_size`` square mask a class; ground
  truth polygons travel padded or resampled to ``max_mask_vertices``.
"""

from __future__ import annotations

import dataclasses
import json
import os
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

    # ---- Mask R-CNN's mask branch (the port's own; needs fpn) ----
    mask_head: bool = False
    mask_roi_size: int = 14
    mask_dim: int = 256
    mask_convs: int = 4
    max_mask_vertices: int = 128

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

    @property
    def mask_size(self) -> int:
        """Side of a predicted mask: the transposed convolution doubles the
        pooled ``mask_roi_size``."""
        return 2 * self.mask_roi_size

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


# the fields the JAX package's Config lacks
MASK_FIELDS = ("mask_head", "mask_roi_size", "mask_dim", "mask_convs",
               "max_mask_vertices")


def resolve_device(device) -> torch.device:
    """The torch device an entry point runs on; raises if it is a CUDA
    device and no GPU is present (the port never falls back to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but no CUDA device is available; "
            "pass device='cpu' to run the plain PyTorch path on the CPU")
    return dev


def compute_dtype(cfg: Config) -> torch.dtype:
    if cfg.compute_dtype not in ("bfloat16", "float32"):
        raise ValueError(f"compute_dtype must be 'bfloat16' or 'float32', "
                         f"got {cfg.compute_dtype!r}")
    return torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32


def use_kernels(cfg: Config) -> bool:
    """``Config.pallas`` as the kernel switch (see the module docstring)."""
    if cfg.pallas not in ("auto", "on", "off"):
        raise ValueError(f"pallas must be 'auto', 'on' or 'off', "
                         f"got {cfg.pallas!r}")
    return cfg.pallas != "off"


def load_config(path: str | None = None, **overrides) -> Config:
    """Load a :class:`Config`, optionally merging a reference-format JSON file."""
    kw = {}
    if path is None:
        default = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                               "configs", "config.json")
        path = default if os.path.exists(default) else None
    if path is not None:
        with open(path, "r") as f:
            raw = json.load(f)
        # the file's ``device`` names the JAX package's backend ("tpu"):
        # the port's device is chosen by its caller
        names = {f.name for f in dataclasses.fields(Config)} - {"device"}
        kw.update({k: v for k, v in raw.items() if k in names})
    kw.update(overrides)
    return Config(**kw)
