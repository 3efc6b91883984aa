"""Anchor generation (host-side numpy, computed once at model-build time).

A copy of the JAX package's ``ops/anchors.py``: the same tables in the same
order, so the RPN outputs of both packages index the same anchors.
"""

from __future__ import annotations

import numpy as np


def generate_basic_anchor(base_size: int = 8, ratios=(0.5, 1.0, 2.0),
                          anchor_scales=(8.0, 16.0, 32.0)) -> np.ndarray:
    """``[len(ratios)*len(scales), 4]`` base anchors centred at the origin:
    ``h = base*scale*sqrt(ratio)``, ``w = base*scale*sqrt(1/ratio)``, xyxy."""
    ratios = np.asarray(ratios, np.float32)
    scales = np.asarray(anchor_scales, np.float32)
    h = base_size * scales[None, :] * np.sqrt(ratios)[:, None]      # [R, S]
    w = base_size * scales[None, :] * np.sqrt(1.0 / ratios)[:, None]
    h = h.reshape(-1)
    w = w.reshape(-1)
    return np.stack([-w / 2, -h / 2, w / 2, h / 2], axis=1).astype(np.float32)


def enumerate_shifted_anchor(anchor_base: np.ndarray, feat_stride: int,
                             height: int, width: int) -> np.ndarray:
    """Tile base anchors over the feature grid -> ``[H*W*A, 4]``: row-major
    over the grid (y outer, x inner), anchors innermost."""
    shift_x = np.arange(width, dtype=np.float32) * feat_stride
    shift_y = np.arange(height, dtype=np.float32) * feat_stride
    sx, sy = np.meshgrid(shift_x, shift_y)      # both [H, W]
    shift = np.stack([sx.ravel(), sy.ravel(), sx.ravel(), sy.ravel()], axis=1)
    a = anchor_base.shape[0]
    k = shift.shape[0]
    anchors = anchor_base.reshape(1, a, 4) + shift.reshape(k, 1, 4)
    return anchors.reshape(k * a, 4).astype(np.float32)


def make_anchors(cfg) -> np.ndarray:
    """All anchors of the single-scale geometry (``[N, 4]``)."""
    base = generate_basic_anchor(cfg.anchor_base_size, cfg.anchor_ratios,
                                 cfg.anchor_scales)
    fh, fw = cfg.feat_size
    return enumerate_shifted_anchor(base, cfg.feat_stride, fh, fw)


def fpn_feat_sizes(input_size, min_level: int, max_level: int):
    """Per-level feature (H, W) for strides ``2**min_level .. 2**max_level``
    by ceil-halving: 600 -> 300 -> 150 -> 75 -> 38 -> 19 -> 10."""
    h, w = input_size
    sizes = []
    for lvl in range(1, max_level + 1):
        h = (h + 1) // 2
        w = (w + 1) // 2
        if lvl >= min_level:
            sizes.append((h, w))
    return sizes


def make_fpn_anchors(cfg) -> np.ndarray:
    """Concatenated anchor table over the FPN pyramid (``[sum_l H_l*W_l*A, 4]``).

    One size per level (side ``fpn_anchor_scale * 2**level``) at every
    ``cfg.anchor_ratios`` aspect ratio; P_min first, row-major grid, ratios
    innermost — the order of the concatenated RPN outputs.
    """
    sizes = fpn_feat_sizes(cfg.input_size, cfg.fpn_min_level, cfg.fpn_max_level)
    tables = []
    for lvl, (fh, fw) in zip(range(cfg.fpn_min_level, cfg.fpn_max_level + 1),
                             sizes):
        stride = 2 ** lvl
        base = generate_basic_anchor(base_size=1, ratios=cfg.anchor_ratios,
                                     anchor_scales=(cfg.fpn_anchor_scale * stride,))
        tables.append(enumerate_shifted_anchor(base, stride, fh, fw))
    return np.concatenate(tables, axis=0)
