"""The yardstick's arithmetic: peaks, the hand kernels' bounds, model FLOPs.

The bound functions are frozen copies of the repository's
``chip_smoke.py`` count functions (``nms_bound_ms``, ``alive_ious``,
``fused_bound_ms``, ``touched_bytes`` with kernel 2's byte and operation
count, ``bin_pixels``, ``roi_pool_bound_ms``), reading the reference's
copies of the helpers they use, so that nothing here imports the program.
Each returns the least time in milliseconds that the launch could take on
the card: the larger of its operations over the float32 rate and its bytes
over the HBM bandwidth (``peaks.json``).  Operations and bytes come from
the launch's own inputs and outputs: the IoUs greedy NMS needs on this
data, the pixels the rois touch, the bins' pixels.

:func:`model_flops` counts the convolutions and matrix products of one
image through the reference's modules on the meta device
(``torch.utils.flop_counter.FlopCounterMode``): the forward for serving,
forward and backward for training, no recomputation.
"""

from __future__ import annotations

import json
import os

import torch

from port_bench.reference import roi_pool as ref_roi_pool
from port_bench.reference.proposals import _decode_masked

HERE = os.path.dirname(os.path.abspath(__file__))
IOU_FLOPS = 14    # max/min x4, sub x2, clamp x2, mul, add, sub, add, div, cmp
DECODE_FLOPS = 26  # anchor w/h/centre 6, deltas 4, exp 2, box 4, clip 8, sides 2


def peaks(kind: str):
    """The published peaks of a card by its ``torch.cuda.get_device_name``,
    or None for a card the table does not hold."""
    with open(os.path.join(HERE, "peaks.json")) as f:
        return json.load(f).get(kind)


def _bound(nbytes: float, ops: float, pk) -> float:
    return max(nbytes / pk["hbm_bytes_per_s"], ops / pk["f32_flops"]) * 1e3


# ---------------------------------------------------------------- kernel 1
def nms_bound_ms(boxes, out_boxes, valid, n_post: int, pk) -> float:
    """Bytes: inputs once, outputs once.  Operations: the IoUs greedy NMS
    needs on this data -- each kept row i against the K - 1 - i rows after
    it -- plus one area per row."""
    b, k, _ = boxes.shape
    nbytes = b * k * (16 + 4) + b * n_post * (16 + 4 + 1)
    # row index of each kept box in its image
    match = (out_boxes[:, :, None, :] == boxes[:, None, :, :]).all(-1)
    row = match.to(torch.uint8).argmax(-1)
    ious = int(((k - 1 - row) * valid).sum())
    ops = ious * IOU_FLOPS + b * k * 3
    return _bound(nbytes, ops, pk)


# ---------------------------------------------------------------- kernel 3
def alive_ious(locs, fg, anchors, img, n_post: int, min_size: float,
               thr: float) -> int:
    """IoUs that greedy NMS needs on this data: at each valid step, the
    winner against every row still alive (masked and suppressed rows need
    none)."""
    boxes, s = _decode_masked(locs, fg, anchors, img, min_size)
    x1, y1, x2, y2 = boxes.unbind(-1)
    area = (x2 - x1) * (y2 - y1)
    rows = torch.arange(boxes.shape[0], device=boxes.device)
    total = torch.zeros((), dtype=torch.int64, device=boxes.device)
    for _ in range(n_post):
        alive = s > -5e8
        i = torch.argmax(s, dim=1)
        ok = alive[rows, i]
        total += (alive.sum(1) * ok).sum()
        sel = boxes[rows, i]
        inter = (torch.clamp(torch.minimum(x2, sel[:, 2:3])
                             - torch.maximum(x1, sel[:, 0:1]), min=0.0)
                 * torch.clamp(torch.minimum(y2, sel[:, 3:4])
                               - torch.maximum(y1, sel[:, 1:2]), min=0.0))
        iou = inter / (area + area[rows, i][:, None] - inter + 1e-8)
        sup = iou > thr
        sup[rows, i] = True
        s = torch.where(sup, -1e9, s)
    return int(total)


def fused_bound_ms(locs, fg, anchors, img, n_post: int, min_size: float,
                   thr: float, pk) -> float:
    b, n, _ = locs.shape
    nbytes = b * n * (16 + 4) + n * 16 + b * n_post * (16 + 4 + 1)
    ops = (alive_ious(locs, fg, anchors, img, n_post, min_size, thr)
           * IOU_FLOPS + b * n * DECODE_FLOPS)
    return _bound(nbytes, ops, pk)


# ---------------------------------------------------------------- kernel 2
def touched_bytes(pyr, rois, levels, scales, win=32, p=7, s=2) -> int:
    """Bytes of the distinct pyramid pixels the rois' bilinear taps read,
    over the whole batch (each pixel once: the HBM bound).  ``pyr``: the
    NHWC levels the kernel reads."""
    levels_hw = [tuple(f.shape[1:3]) for f in pyr]
    dev = rois.device
    sizes = torch.tensor(levels_hw, dtype=torch.float32, device=dev)
    sc = ref_roi_pool._norm_scales(scales, len(levels_hw)).to(dev)
    lv = levels.long()
    cy, cx = ref_roi_pool._roi_samples(rois, lv, sizes, sc, p, s, False)
    w_pad = max(max(w for _, w in levels_hw), win)
    block_h = torch.tensor([max(h, win) for h, _ in levels_hw], device=dev)
    oy = torch.minimum(torch.clamp(torch.floor(cy[..., 0]).long(), min=0),
                       block_h[lv] - win)
    ox = torch.clamp(torch.floor(cx[..., 0]).long(), 0, w_pad - win)

    def taps(c, o):
        loc = torch.clamp(c - o[..., None].float(), 0.0, win - 1.0)
        i0 = torch.floor(loc).long()
        return torch.cat([i0, torch.clamp(i0 + 1, max=win - 1)], -1) + o[..., None]

    ty, tx = taps(cy, oy), taps(cx, ox)                  # [B, R, 2*P*S]
    total = 0
    bidx = torch.arange(rois.shape[0], device=dev)[:, None, None, None]
    for li, (h, w) in enumerate(levels_hw):
        m = lv == li
        occ = torch.zeros((rois.shape[0], h, w), dtype=torch.bool, device=dev)
        yy = ty[..., :, None].expand(-1, -1, -1, tx.shape[-1])
        xx = tx[..., None, :].expand(-1, -1, ty.shape[-1], -1)
        ok = m[..., None, None] & (yy < h) & (xx < w)
        bb = bidx.expand_as(yy)
        occ[bb[ok], yy[ok], xx[ok]] = True
        total += int(occ.sum())
    return total * pyr[0].shape[-1] * pyr[0].element_size()


def align_bound_ms(pyr, rois, levels, scales, p: int, win: int, pk) -> float:
    """Kernel 2: the touched pyramid pixels, the rois and levels read once,
    the pooled output written once; 16 taps x (w*w, *v, +) per bin."""
    n_roi, c = rois.shape[0] * rois.shape[1], pyr[0].shape[-1]
    nbytes = (touched_bytes(pyr, rois, levels, scales, win, p)
              + n_roi * (16 + 4) + n_roi * p * p * c * pyr[0].element_size())
    ops = n_roi * c * (p * p * 16 * 3 + p * p)
    return _bound(nbytes, ops, pk)


# ---------------------------------------------------------------- kernel 5
def bin_pixels(rois, h: int, w: int, p: int = 7) -> int:
    """Pixels in all bins of ``rois [B, R, 4]`` (map coordinates)."""
    q = torch.round(rois).to(torch.int64)
    xs, xe = ref_roi_pool._bin_edges_pool(q[..., 0], q[..., 2], p)
    ys, ye = ref_roi_pool._bin_edges_pool(q[..., 1], q[..., 3], p)
    bw = (xe.clamp(0, w) - xs.clamp(0, w)).clamp(min=0)
    bh = (ye.clamp(0, h) - ys.clamp(0, h)).clamp(min=0)
    return int((bh[..., :, None] * bw[..., None, :]).sum())


def roi_pool_bound_ms(feats, rois, p: int, out_bytes: int, pk) -> float:
    """Bytes: the map and rois read once, the f32 values (and with
    ``out_bytes=8`` the int32 indices) written once.  Operations: one
    compare per pixel of each bin per channel."""
    b, h, w, c = feats.shape
    r = rois.shape[1]
    ops = bin_pixels(rois, h, w, p) * c
    nbytes = (feats.numel() * feats.element_size() + rois.numel() * 4
              + b * r * p * p * c * out_bytes)
    return _bound(nbytes, ops, pk)


# ---------------------------------------------------------------- model
def _layer_flops(module, inp, out) -> float:
    """Multiply-adds of one convolution or dense layer, times 2."""
    from port_bench.reference.layers import Conv
    if isinstance(module, Conv):
        k = module.weight.shape[1] * module.weight.shape[2] * module.weight.shape[3]
    else:
        k = module.in_features
    return 2.0 * out.numel() * k


def model_flops(ref_cfg, train: bool) -> float:
    """Convolution and matrix-product FLOPs of one image through the
    reference detector built on the meta device: backbone, neck and RPN
    head on the input size, the box head's dense layers on the rois a step
    pools (``n_test_post_nms`` to serve, ``roi_n_sample`` to train).

    Each layer's forward is ``2 * outputs * (inputs a output)``, a grouped
    convolution's inputs being its group's; with ``train`` the backward
    adds the weight gradient (as much again) and, where the layer's input
    needs a gradient (not the image), the input gradient (as much again).
    ``torch.utils.flop_counter`` is not used: it counts a grouped
    convolution's backward as a dense one's."""
    from port_bench.reference.detector import FasterRCNN
    from port_bench.reference.layers import Conv, Dense
    model = FasterRCNN(ref_cfg, device="meta")
    model.set_mode(train)
    total = [0.0]

    def count(module, inp, out):
        f = _layer_flops(module, inp, out)
        if train:
            f *= 3.0 if inp[0].requires_grad else 2.0
        total[0] += f

    hooks = [m.register_forward_hook(count) for m in model.modules()
             if isinstance(m, (Conv, Dense))]
    h, w = ref_cfg.input_size
    rois = ref_cfg.roi_n_sample if train else ref_cfg.n_test_post_nms
    head = model.roi_head
    try:
        with torch.set_grad_enabled(train):
            feats = model.features(torch.zeros((1, h, w, 3), device="meta"))
            model.rpn_head(feats)
            if ref_cfg.fpn:
                c = ref_cfg.fpn_channels * ref_cfg.roi_size ** 2
                t = torch.zeros((1, rois, c), device="meta",
                                requires_grad=train)
                t = torch.relu(head.fc2(torch.relu(head.fc1(t))))
            else:
                t = torch.zeros((1, rois, ref_cfg.backbone_channels),
                                device="meta", requires_grad=train)
            head.cls_loc(t)
            head.score(t)
    finally:
        for hk in hooks:
            hk.remove()
    return total[0]
