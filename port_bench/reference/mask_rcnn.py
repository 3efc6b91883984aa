"""Mask R-CNN's mask branch on the reference detector, plain PyTorch.

He, Gkioxari, Dollar, Girshick, "Mask R-CNN" (arXiv:1703.06870), as
Detectron's ``configs/12_2017_baselines/e2e_mask_rcnn_R-50-FPN_1x.yaml``
configures it: each detection (serving) or positive sampled roi (training)
pooled by RoIAlign at 14x14 from its FPN level, four 3x3 convolutions 256
wide with ReLU, a 2x2 stride-2 transposed convolution 256 wide with ReLU,
and a 1x1 convolution to one 28x28 mask logit a foreground class; the
sigmoid of the detected class's channel is the mask.  Training rasterises
each positive roi's matched ground-truth polygon on the roi's own 28x28
grid (Detectron's ``polys_to_mask_wrt_box``) and takes the per-pixel binary
cross-entropy on the ground-truth class's channel, with weight 1.

:class:`MaskRCNN` subclasses the frozen :class:`~.detector.FasterRCNN`,
float32, every operation plain (no kernel: the windowed RoIAlign is
:func:`~.roi_pool.multilevel_roi_align`, through the box head's own
``pool``); it imports nothing of the program.  Its departures from
Detectron, beside those of the box detector it extends:

* pre-NMS top-k over the pyramid is global (5,000 over the five levels),
  not 1,000 a level;
* each roi's level is eq. 1 of the FPN paper with the span-aware bump (a
  roi whose long side overflows the 32-cell window moves to the first
  coarser level where it fits), and RoIAlign reads through that window
  (the box head's windowed semantics), 2x2 samples a bin, unaligned;
* 80 mask channels, one a foreground class, as in detectron2, where
  Detectron 1 has 81 with the background's;
* the rasterisation is the even-odd rule at the bin centres, where
  pycocotools fills the polygon scan-line by scan-line: the two differ on
  boundary pixels and where rings overlap;
* weights are seeded (:func:`init_mask_head`), lecun-normal as every layer
  of the reference, where Detectron draws the mask head MSRA-normal.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from .config import compute_dtype
from .detector import FasterRCNN
from .fpn import FPNRoIHead
from .geometry import bbox_iou
from .layers import Conv, _operand, _output


class ConvTranspose(nn.Module):
    """Transposed convolution with kernel = stride on NCHW tensors
    (``weight [in, out, k, k]``, float32): each output pixel takes one input
    pixel's channels."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int = 2,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(in_ch, out_ch, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(out_ch))
        self.stride = kernel
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return _output(F.conv_transpose2d(
            _operand(x.to(dt)), _operand(self.weight.to(dt)),
            self.bias.to(dt), self.stride))


class MaskHead(nn.Module):
    """The mask branch: pooling (the box head's level rule and windowed
    RoIAlign, at ``roi_size``) and ``layers``.  ``(pyramid, rois [B, D, 4],
    labels [B, D] 1-based, img_size) -> [B, D, M, M]`` f32 logits of each
    roi's class (class 1 where a label is 0)."""

    pool = FPNRoIHead.pool
    _pool_dense = FPNRoIHead._pool_dense

    def __init__(self, n_fg_class: int, channels: int, roi_size: int,
                 dim: int, n_convs: int, min_level: int, n_pool_levels: int,
                 canonical_level: int, canonical_size: float, window: int,
                 span_aware: bool, dtype=torch.float32):
        super().__init__()
        self.roi_size, self.min_level = roi_size, min_level
        self.n_pool_levels = n_pool_levels
        self.canonical_level, self.canonical_size = canonical_level, canonical_size
        self.window, self.span_aware = window, span_aware
        self.n_convs = n_convs
        for i in range(n_convs):
            self.add_module(f"conv{i}", Conv(channels if i == 0 else dim, dim,
                                             3, 1, 1, compute_dtype=dtype))
        self.deconv = ConvTranspose(dim if n_convs else channels, dim, 2,
                                    compute_dtype=dtype)
        self.predictor = Conv(dim, n_fg_class, 1, compute_dtype=dtype)

    def layers(self, x: torch.Tensor) -> torch.Tensor:
        """``[N, C, P, P]`` pooled maps -> ``[N, K, 2P, 2P]`` logits."""
        for i in range(self.n_convs):
            x = F.relu(getattr(self, f"conv{i}")(x))
        return self.predictor(F.relu(self.deconv(x)))

    def forward(self, pyramid, rois, labels, img_size, use_window=True):
        b, d = rois.shape[:2]
        pooled = self.pool(pyramid, rois, img_size, use_window)
        x = pooled.reshape(b * d, *pooled.shape[2:]).permute(0, 3, 1, 2)
        logits = self.layers(x)
        cls = (labels.reshape(-1).long() - 1).clamp(min=0)
        picked = logits[torch.arange(b * d, device=cls.device), cls]
        return picked.float().reshape(b, d, *picked.shape[-2:])


def init_mask_head(head: MaskHead, seed: int) -> None:
    """The head's kernels from one standard normal truncated at +-2, drawn
    in one call from a ``torch.Generator`` seeded with ``seed``, each slice
    in module order scaled to lecun's std over its fan-in (a 3x3 or 1x1
    convolution's ``in * k * k``, the transposed convolution's ``in``: the
    inputs one output sums); biases zero."""
    layers = [m for m in head.modules() if isinstance(m, (Conv, ConvTranspose))]
    dev = layers[0].weight.device
    total = sum(m.weight.numel() for m in layers)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    flat = torch.empty(total, dtype=torch.float32, device=dev)
    nn.init.trunc_normal_(flat, 0.0, 1.0, -2.0, 2.0, generator=gen)
    at = 0
    with torch.no_grad():
        for m in layers:
            w = m.weight
            fan_in = w.shape[0] if isinstance(m, ConvTranspose) else w[0].numel()
            std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
            m.weight.copy_(flat[at:at + w.numel()].view_as(w) * std)
            m.bias.zero_()
            at += w.numel()


def rasterize(polys: torch.Tensor, edges: torch.Tensor, gt_index: torch.Tensor,
              rois: torch.Tensor, size: int) -> torch.Tensor:
    """Each roi's matched polygon (``polys [B, G, V, 2]``, ``edges [B, G,
    V]``: vertex ``v`` to ``v + 1`` mod ``V`` is an edge) at the centres of
    the roi's ``size x size`` bins (sides at least 1), by the even-odd rule:
    a point is inside where a ray towards +x crosses an odd number of
    edges, an edge counting where ``(y_a > y) != (y_b > y)`` and the point
    lies left of it.  ``-> [B, S, size, size]`` f32 in {0, 1}."""
    b, s = gt_index.shape
    v = polys.shape[2]
    p = polys.gather(1, gt_index[..., None, None].expand(b, s, v, 2))
    e = edges.gather(1, gt_index[..., None].expand(b, s, v))
    x1, y1, x2, y2 = rois.float().unbind(-1)
    w = torch.clamp(x2 - x1, min=1.0)
    h = torch.clamp(y2 - y1, min=1.0)
    g = (torch.arange(size, dtype=torch.float32, device=rois.device) + 0.5) / size
    py = (y1[..., None] + g * h[..., None])[..., :, None, None]  # [B,S,M,1,1]
    px = (x1[..., None] + g * w[..., None])[..., None, :, None]  # [B,S,1,M,1]
    xa, ya = p[..., 0], p[..., 1]
    xb, yb = xa.roll(-1, dims=-1), ya.roll(-1, dims=-1)
    xa, ya, xb, yb, e = (t[..., None, None, :] for t in (xa, ya, xb, yb, e))
    crosses = e & ((ya > py) != (yb > py))                       # [B,S,M,M,V]
    dy = torch.where(crosses, yb - ya, torch.ones_like(ya))
    xint = xa + (py - ya) * ((xb - xa) / dy)
    inside = (crosses & (px < xint)).sum(-1) % 2
    return inside.float()


def mask_bce(logits: torch.Tensor, targets: torch.Tensor,
             valid: torch.Tensor) -> torch.Tensor:
    """Per-pixel binary cross-entropy ``max(x, 0) - x t + log(1 +
    exp(-|x|))``, summed over the valid rois' pixels and divided by their
    number times ``M * M`` (0 with none)."""
    x = logits.float()
    bce = torch.clamp(x, min=0) - x * targets + torch.log1p(torch.exp(-x.abs()))
    n = valid.sum().clamp(min=1) * (x.shape[-2] * x.shape[-1])
    return (bce.sum((-2, -1)) * valid.float()).sum() / n


def paste_masks(boxes: torch.Tensor, masks: torch.Tensor, img_size,
                threshold: float = 0.5) -> torch.Tensor:
    """Each ``M x M`` mask (``masks [..., D, M, M]``) into the image at its
    box (``boxes [..., D, 4]``) -> ``[..., D, H, W]`` bool: each pixel
    centre's position in its box's mask grid, ``u = (x + 0.5 - x1) / (x2 -
    x1) * M - 0.5``, read bilinearly from the mask's four nearest bins
    (zero beyond the grid), then held to ``threshold``."""
    lead, m = masks.shape[:-2], masks.shape[-1]
    h, w = img_size
    bx = boxes.float().reshape(-1, 4)
    mk = F.pad(masks.float().reshape(-1, m, m), (1, 1, 1, 1))   # zero ring
    n = bx.shape[0]

    def coords(lo, hi, k):
        c = torch.arange(k, dtype=torch.float32, device=masks.device) + 0.5
        u = (c[None] - lo[:, None]) / (hi - lo)[:, None] * m - 0.5
        i0 = torch.floor(u)
        f = u - i0
        i0 = i0.long() + 1                                       # padded index
        return (i0.clamp(0, m + 1), (i0 + 1).clamp(0, m + 1), f)

    y0, y1, fy = coords(bx[:, 1], bx[:, 3], h)                   # [N, H]
    x0, x1, fx = coords(bx[:, 0], bx[:, 2], w)                   # [N, W]
    rows = torch.arange(n, device=masks.device)[:, None, None]

    def tap(yi, xi):
        return mk[rows, yi[:, :, None], xi[:, None, :]]

    out = (tap(y0, x0) * ((1 - fy)[:, :, None] * (1 - fx)[:, None, :])
           + tap(y0, x1) * ((1 - fy)[:, :, None] * fx[:, None, :])
           + tap(y1, x0) * (fy[:, :, None] * (1 - fx)[:, None, :])
           + tap(y1, x1) * (fy[:, :, None] * fx[:, None, :]))
    return (out >= threshold).reshape(*lead, h, w)


class MaskRCNN(FasterRCNN):
    """The reference detector with the mask branch (``mask_head``).

    ``mask_roi_size``, ``mask_dim``, ``mask_convs`` as the program's
    ``Config`` keys (the reference's ``Config`` lacks them).  ``predict``
    returns ``(boxes, scores, labels, valid, masks [B, D, M, M])``;
    ``train_forward`` takes ``gt_polys`` and ``gt_poly_edges`` and adds
    ``losses["mask"]`` to the total."""

    def __init__(self, cfg, mask_roi_size: int = 14, mask_dim: int = 256,
                 mask_convs: int = 4, device="cpu"):
        super().__init__(cfg, device)
        self.mask_head = MaskHead(
            cfg.num_classes, cfg.fpn_channels, mask_roi_size, mask_dim,
            mask_convs, cfg.fpn_min_level,
            cfg.fpn_max_level - cfg.fpn_min_level, cfg.fpn_canonical_level,
            cfg.fpn_canonical_size, cfg.fpn_roi_window, cfg.fpn_span_aware,
            compute_dtype(cfg)).to(device)
        if torch.device(device).type == "cuda":
            self.mask_head.to(memory_format=torch.channels_last)
        self.eval()

    @torch.inference_mode()
    def predict(self, images: torch.Tensor, scale: float = 1.0):
        if self.training:
            self.set_mode(False)
        feats = self.features(images)
        img_size = self.image_size(images)
        boxes, scores, labels, valid = self.detect(feats, img_size, scale)
        return (boxes, scores, labels, valid,
                self.mask_predict(feats, boxes, labels, valid, img_size))

    @torch.inference_mode()
    def mask_predict(self, feats, boxes, labels, valid, img_size):
        """``sigmoid`` of each detection's class channel, ``[B, D, M, M]``,
        zero where ``valid`` is False."""
        logits = self.mask_head(feats, boxes, labels, img_size)
        return torch.sigmoid(logits) * valid[..., None, None].float()

    def train_forward(self, images, gt_boxes, gt_labels, gt_valid,
                      scale: float = 1.0, train: bool = True,
                      generator: Optional[torch.Generator] = None,
                      gt_polys: Optional[torch.Tensor] = None,
                      gt_poly_edges: Optional[torch.Tensor] = None
                      ) -> Dict[str, Any]:
        """The box detector's losses, then the mask loss on its positive
        sampled rois: the first ``roi_n_sample * roi_pos_ratio`` that the box
        head pooled, those whose best IoU with a valid gt reaches
        ``roi_pos_iou_thresh``, each against that gt's polygon (a gt
        without one trains no mask).  The sampled rois and the pyramid are
        read from the box head's call."""
        cfg = self.cfg
        seen = {}

        def grab(module, args, kwargs):
            seen["feats"], seen["rois"] = args[0], args[1]

        hook = self.roi_head.register_forward_pre_hook(grab, with_kwargs=True)
        try:
            out = super().train_forward(images, gt_boxes, gt_labels, gt_valid,
                                        scale, train, generator)
        finally:
            hook.remove()
        n_pos = int(cfg.roi_n_sample * cfg.roi_pos_ratio)
        rois = seen["rois"][:, :n_pos]
        gt_valid = gt_valid.bool()
        iou = torch.where(gt_valid[:, None, :], bbox_iou(rois, gt_boxes), -1.0)
        best, index = iou.max(dim=2)
        edges = gt_poly_edges.bool()
        has_mask = edges.any(-1).gather(1, index)
        valid = (best >= cfg.roi_pos_iou_thresh) & has_mask
        labels = torch.where(valid, gt_labels.long().gather(1, index) + 1, 0)
        target = rasterize(gt_polys.float(), edges, index, rois,
                           2 * self.mask_head.roi_size)
        logits = self.mask_head(seen["feats"], rois, labels,
                                self.image_size(images), use_window=False)
        loss = mask_bce(logits, target, valid)
        out["losses"]["mask"] = loss
        out["losses"]["total"] = out["losses"]["total"] + loss
        return out
