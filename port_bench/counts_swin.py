"""The Swin-T configuration's arithmetic: its attention calls' work, read
from the configuration's padded shapes, and its model FLOPs an image.

Each block's attention core (``softmax(q k^T * scale + mask) v`` over 7x7
windows) is one call on every window of the padded token grid: a stage of
``h x w`` tokens pads to ``Hp x Wp``, multiples of 7, and attends ``(Hp /
7) * (Wp / 7)`` windows an image, ``heads`` heads of ``d = 32`` channels.
A call on ``B`` images does ``4 * B * windows * heads * 49^2 * d`` FLOPs
(``q k^T`` and ``attn v``, a multiply-add counted as 2) and reads and
writes at least ``q``, ``k``, ``v`` and the output once, ``4 * B *
windows * heads * 49 * d`` elements, and the additive mask (bias and
shift mask) once, ``windows * heads * 49^2`` elements, the same for every
image: the call's least time is the larger of the FLOPs over the dense
bf16 rate and the bytes over the HBM bandwidth (``peaks.json``).  The
work is that of the computation, whatever kernel does it.

:func:`model_flops` counts the convolutions and matrix products of one
served image with ``torch.utils.flop_counter.FlopCounterMode`` on the meta
device, through the reference (:mod:`port_bench.reference.swin_mask_rcnn`):
the trunk (its linear layers, the attention's two products a window and
the patch convolution), the neck and the RPN head on the input size, the
box head's dense layers on ``n_test_post_nms`` rois, and the mask head on
``max_detections`` (:func:`port_bench.counts_mask.mask_head_flops`).  It
imports nothing of the program.
"""

from __future__ import annotations

import math

import torch
from torch.utils.flop_counter import FlopCounterMode

from port_bench import counts_mask
from port_bench.reference.swin import SWIN_T

WINDOW_TOKENS = SWIN_T["window"] ** 2


def stage_grids(input_size, spec=SWIN_T):
    """``[(h, w)]`` tokens of each stage: the image over the 4x4 patches
    (padded up), then halved (rounded up) by each patch merging."""
    h, w = (math.ceil(s / 4) for s in input_size)
    grids = []
    for _ in spec["depths"]:
        grids.append((h, w))
        h, w = math.ceil(h / 2), math.ceil(w / 2)
    return grids


def attention_calls(input_size, spec=SWIN_T):
    """``[(windows an image, heads, head dim)]`` of each block's attention
    call, in order, on the padded grid."""
    ws = spec["window"]
    calls = []
    for i, (h, w) in enumerate(stage_grids(input_size, spec)):
        windows = math.ceil(h / ws) * math.ceil(w / ws)
        heads = spec["num_heads"][i]
        dim = spec["embed_dim"] * 2 ** i
        calls += [(windows, heads, dim // heads)] * spec["depths"][i]
    return calls


def attention_work(call, images: int, elem_bytes: int = 2):
    """``(FLOPs, bytes)`` of one attention call on ``images`` images."""
    windows, heads, d = call
    n = WINDOW_TOKENS
    flops = 4.0 * images * windows * heads * n * n * d
    nbytes = (4.0 * images * windows * heads * n * d
              + windows * heads * n * n) * elem_bytes
    return flops, nbytes


def attention_bound_ms(call, images: int, pk, elem_bytes: int = 2) -> float:
    """The least time of one attention call on the card (ms)."""
    flops, nbytes = attention_work(call, images, elem_bytes)
    return max(flops / pk["bf16_flops"], nbytes / pk["hbm_bytes_per_s"]) * 1e3


def _detector(ref_cfg):
    from port_bench.reference.swin_mask_rcnn import swin_detector
    return swin_detector(ref_cfg, device="meta")


def trunk_flops(ref_cfg) -> float:
    """FLOPs of the Swin trunk on one image of ``ref_cfg.input_size``."""
    model = _detector(ref_cfg)
    h, w = ref_cfg.input_size
    with FlopCounterMode(display=False) as fc:
        model.extractor(torch.zeros((1, 3, h, w), device="meta"))
    return float(fc.get_total_flops())


def model_flops(ref_cfg, mask_kw: dict) -> float:
    """FLOPs of one served image of the Swin-T Mask R-CNN (see the module
    docstring)."""
    model = _detector(ref_cfg)
    h, w = ref_cfg.input_size
    head = model.roi_head
    c = ref_cfg.fpn_channels * ref_cfg.roi_size ** 2
    with FlopCounterMode(display=False) as fc:
        feats = model.features(torch.zeros((1, h, w, 3), device="meta"))
        model.rpn_head(feats)
        t = torch.zeros((1, ref_cfg.n_test_post_nms, c), device="meta")
        t = torch.relu(head.fc2(torch.relu(head.fc1(t))))
        head.cls_loc(t)
        head.score(t)
    return (float(fc.get_total_flops())
            + counts_mask.mask_head_flops(ref_cfg, mask_kw,
                                          ref_cfg.max_detections))
