"""Mask R-CNN on the Swin-T trunk, plain PyTorch, float32: the reference of
the ``mask_swin_t`` configuration.

Liu et al., "Swin Transformer" (arXiv:2103.14030), as the published
detection configuration tests it (Swin-Transformer-Object-Detection,
``configs/swin/mask_rcnn_swin_tiny_patch4_window7_mstrain_480-800_adamw_
1x_coco.py``): the Swin-T trunk (:mod:`.swin`) under the FPN at 256
channels, the RPN, the box head and the mask head of
:class:`~.mask_rcnn.MaskRCNN`.  :func:`swin_detector` composes them: the
detector is built as the R50-FPN one, then its trunk is replaced by
:class:`~.swin.SwinFeatureExtraction` and its neck rebuilt at Swin's
widths (96, 192, 384, 768), so that every module after the trunk is the
mask reference's own.  It imports nothing of the program.

Departures from the published model, beside those of
:mod:`.mask_rcnn`:

* pre-NMS top-k is global, 5,000 over the five levels, where mmdet takes
  1,000 a level;
* RoIAlign has the program's semantics (the level rule with the
  span-aware bump, a 32-cell window, 2x2 samples a bin, unaligned), where
  mmdet's is aligned with adaptive sampling;
* no stochastic depth (the published ``drop_path_rate`` 0.2 trains with
  it; serving is unaffected);
* one fixed 800x1088 input (the published test pipeline keeps each
  image's own padded size);
* weights are seeded (:func:`init_swin_detector`): the published trunk
  init, no ImageNet pretraining and no trained checkpoint.
"""

from __future__ import annotations

import dataclasses

import torch

from .config import compute_dtype
from .detector import FasterRCNN
from .fpn import FPNNeck
from .layers import init_weights
from .mask_rcnn import MaskRCNN
from .swin import SWIN_T, SwinFeatureExtraction, init_swin

# the trunk the detector is first built with, then replaced
_STAND_IN = "resnet10"


def swin_detector(cfg, device="cpu", mask_kw=None) -> FasterRCNN:
    """The reference detector of ``cfg`` (``backbone="swin_t"``, FPN) on the
    Swin-T trunk: a :class:`~.mask_rcnn.MaskRCNN` with ``mask_kw``
    (``mask_roi_size``, ``mask_dim``, ``mask_convs``), the box detector
    alone without; float32, in eval mode.  Weights are uninitialised
    (:func:`init_swin_detector` draws them)."""
    if cfg.backbone != "swin_t" or not cfg.fpn:
        raise ValueError(f"the Swin reference takes backbone='swin_t' with "
                         f"fpn=True, got {cfg.backbone!r}, fpn={cfg.fpn}")
    stand_in = dataclasses.replace(cfg, backbone=_STAND_IN)
    model = (FasterRCNN(stand_in, device) if mask_kw is None
             else MaskRCNN(stand_in, **mask_kw, device=device))
    dtype = compute_dtype(cfg)
    model.cfg = cfg
    model.extractor = SwinFeatureExtraction(dtype=dtype, **SWIN_T)
    model.neck = FPNNeck(model.extractor.out_channels, cfg.fpn_channels, dtype)
    model.to(device)
    if torch.device(device).type == "cuda":
        model.to(memory_format=torch.channels_last)
    return model.eval()


def init_swin_detector(model: FasterRCNN, seed: int, trunk_seed: int) -> None:
    """Every convolution and dense layer after the trunk as the reference
    draws them (:func:`~.layers.init_weights` from ``seed``), then the trunk
    as published (:func:`~.swin.init_swin` from ``trunk_seed``)."""
    init_weights(model, seed)
    init_swin(model.extractor, trunk_seed)
