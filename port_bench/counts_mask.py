"""The model FLOPs of a Mask R-CNN image: :func:`port_bench.counts.
model_flops` for the box detector, plus the mask head on the detections.

The mask head's convolutions are counted as :func:`counts.model_flops`
counts the box detector's, ``2 * outputs * (inputs an output)``, through
the reference's modules on the meta device: four 3x3 convolutions at
14x14x256 (231 MFLOP each a roi), the 2x2 stride-2 transposed convolution
(each of its 28x28x256 outputs sums one pixel's 256 inputs: 103 MFLOP) and
the 1x1 predictor to 80 classes at 28x28 (32 MFLOP): 1.06 GFLOP a roi.
"""

from __future__ import annotations

import torch

from port_bench import counts


def mask_head_flops(ref_cfg, mask_kw: dict, rois: int) -> float:
    """Convolution FLOPs of the mask head on ``rois`` pooled rois, forward."""
    from port_bench.reference.layers import Conv
    from port_bench.reference.mask_rcnn import ConvTranspose, MaskHead
    head = MaskHead(
        ref_cfg.num_classes, ref_cfg.fpn_channels, mask_kw["mask_roi_size"],
        mask_kw["mask_dim"], mask_kw["mask_convs"], ref_cfg.fpn_min_level,
        ref_cfg.fpn_max_level - ref_cfg.fpn_min_level,
        ref_cfg.fpn_canonical_level, ref_cfg.fpn_canonical_size,
        ref_cfg.fpn_roi_window, ref_cfg.fpn_span_aware).to("meta")
    total = [0.0]

    def conv(module, inp, out):
        total[0] += counts._layer_flops(module, inp, out)

    def deconv(module, inp, out):
        total[0] += 2.0 * out.numel() * module.weight.shape[0]

    hooks = [m.register_forward_hook(deconv if isinstance(m, ConvTranspose)
                                     else conv)
             for m in head.modules() if isinstance(m, (Conv, ConvTranspose))]
    p = mask_kw["mask_roi_size"]
    try:
        head.layers(torch.zeros((rois, ref_cfg.fpn_channels, p, p),
                                device="meta"))
    finally:
        for hk in hooks:
            hk.remove()
    return total[0]


def model_flops(ref_cfg, mask_kw: dict) -> float:
    """FLOPs of one served image: the box detector's
    (``counts.model_flops(train=False)``) and the mask head on its
    ``max_detections`` slots, all of which run."""
    return (counts.model_flops(ref_cfg, train=False)
            + mask_head_flops(ref_cfg, mask_kw, ref_cfg.max_detections))
