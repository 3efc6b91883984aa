"""RoI pooling, plain PyTorch: single-level RoIPool max and the FPN's
windowed multi-level RoIAlign.

The counterpart of the JAX package's ``ops/roi_pool.py``.

**RoIPool max** (:func:`roi_pool`, :func:`roi_pool_argmax`) has torchvision
RoIPool semantics: rois scaled and rounded half to even, exact integer bin
edges (``start = p*size // P + lo``, ``end = ceil((p+1)*size / P) + lo``,
``size = max(hi - lo, 1)``), clamped to the map; an empty bin gives 0.
:func:`roi_pool_argmax` is the plain version of kernel 5
(``ops/roi_pool_max.py``): it also gives the flat index ``y*W + x`` of the
first maximum of each bin in row-major order (-1 for an empty bin).  It
gathers one column offset of every bin at a time, so it holds
``[..., R, P, H, C]`` slabs and never the ``[R, P, H, W, C]`` broadcast of
the JAX masked max.  It takes as many offsets as the map is wide (and then
high), the most a clamped bin can span, masking the rest: its trip counts
depend on shapes alone, so it reads nothing back from the device and
``torch.export`` traces it.

**RoIPool max backward**, three rules that differ where a bin's maximum is
tied (often: the maps end in a ReLU-like activation, so zeros tie), each a
plain function ``(feats, rois, g) -> dfeat`` held against its own JAX
reference:

* :func:`roi_pool_grad_xla`: autodiff of the two-stage masked max (max over
  a bin's columns, then over its rows), which splits the cotangent evenly
  among the ties of each stage; the backward of the JAX ``roi_pool``;
* :func:`roi_pool_grad_structured`: the same credit written out with
  equality masks and tie counts (the JAX ``roi_pool_structured``);
* :func:`roi_pool_grad_first_argmax`: all of it to the first maximum of each
  bin in row-major order: the plain version of kernel 6
  (``ops/roi_pool_bwd.py``), built from :func:`scatter_argmax_grad`, the
  plain version of kernel 5's scatter backward.

The first two hold ``[r, P, H, W, C]`` masks, so they walk the batch one
image and ``_ROI_CHUNK`` rois at a time.

**Windowed multi-level RoIAlign** (the FPN part): each roi pools a
``[window, window]`` slice of its assigned pyramid level with 2-D bilinear
RoIAlign (``P x P`` bins, ``s x s`` samples per bin).  This is the plain
version of kernel 2 (``ops/windowed_align.py``), and it keeps the JAX sample
rules, which are not torchvision's RoIAlign boundary rules:

* sample coordinates clip to ``[0, size - 1]`` on the level;
* the window origin is ``clip(floor(first sample), 0, block - win)``, where
  a level block is the level padded with zeros to at least ``win`` rows,
  and to the widest level's width (at least ``win``) in columns;
* window-local coordinates clip again to ``[0, win - 1]`` and the upper tap
  is ``i1 = min(i0 + 1, win - 1)``.

Its train route pairs that forward with the gradient of the *dense*
RoIAlign (:func:`multilevel_roi_align_dense_grad`), two matrix products per
level; the two forwards are equal wherever the window covers the roi.

:func:`roi_pool_structured` is the JAX function of that name, RoIPool max
with the structured backward, and :func:`roi_align` the single-level
RoIAlign by gathers; neither is on a model's path.

Every function takes any number of leading batch axes.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .geometry import (
    device_constant, div_exact)


def _bin_edges_pool(lo: torch.Tensor, hi: torch.Tensor, pooled: int):
    """torchvision RoIPool bin ranges along one axis, in exact integers.

    ``lo``/``hi``: ``[...]`` rounded roi start/end (int64).  Returns
    ``(start, end)``, each ``[..., pooled]`` int64, start inclusive, end
    exclusive, not clamped.
    """
    size = torch.clamp(hi - lo, min=1)[..., None]
    p = torch.arange(pooled, dtype=torch.int64, device=lo.device)
    start = torch.div(p * size, pooled, rounding_mode="floor") + lo[..., None]
    end = (torch.div((p + 1) * size + pooled - 1, pooled, rounding_mode="floor")
           + lo[..., None])
    return start, end


def roi_pool_argmax(features: torch.Tensor, rois: torch.Tensor,
                    output_size: int = 7, spatial_scale: float = 1.0):
    """RoIPool max with the first row-major argmax: kernel 5's plain version.

    Args:
      features: ``[..., H, W, C]`` map, any float dtype (pooled in f32,
        which is exact for bf16 and f32 inputs).
      rois: ``[..., R, 4]`` xyxy, multiplied by ``spatial_scale`` to reach
        map coordinates.

    Returns ``(pooled [..., R, P, P, C] f32, argmax [..., R, P, P, C] int32)``.
    """
    lead = rois.shape[:-2]
    h, w, c = features.shape[-3:]
    r, p = rois.shape[-2], output_size
    f = features.reshape(-1, h, w, c)
    q = torch.round(rois.to(torch.float32).reshape(-1, r, 4)
                    * spatial_scale).to(torch.int64)
    xs, xe = _bin_edges_pool(q[..., 0], q[..., 2], p)          # [B, R, P]
    ys, ye = _bin_edges_pool(q[..., 1], q[..., 3], p)
    xs, xe = xs.clamp(0, w), xe.clamp(0, w)
    ys, ye = ys.clamp(0, h), ye.clamp(0, h)
    b = f.shape[0]
    bidx = torch.arange(b, device=f.device)[:, None, None]
    ridx = torch.arange(r, device=f.device)[None, :, None]

    # stage 1, per column bin: max over its columns of every row, and the
    # first column reaching it -> [B, R, Pw, H, C]; a clamped bin spans at
    # most the map, so the trip counts come from the shapes
    v1 = torch.zeros((b, r, p, h, c), dtype=torch.float32, device=f.device)
    x1 = torch.full((b, r, p, h, c), -1, dtype=torch.int32, device=f.device)
    for dx in range(w):
        x = xs + dx
        col = f[bidx, :, x.clamp(max=w - 1)].to(torch.float32)  # [B,R,Pw,H,C]
        better = (x < xe)[..., None, None] & ((col > v1) | (x1 < 0))
        v1 = torch.where(better, col, v1)
        x1 = torch.where(better, x.to(torch.int32)[..., None, None], x1)

    # stage 2, per row bin: max over its rows of the stage-1 maxima, and the
    # first row reaching it -> [B, R, Ph, Pw, C]
    v2 = torch.zeros((b, r, p, p, c), dtype=torch.float32, device=f.device)
    i2 = torch.full((b, r, p, p, c), -1, dtype=torch.int32, device=f.device)
    for dy in range(h):
        y = ys + dy
        yc = y.clamp(max=h - 1)
        row = v1[bidx, ridx, :, yc]                            # [B,R,Ph,Pw,C]
        col = x1[bidx, ridx, :, yc]
        better = ((y < ye)[..., None, None] & (col >= 0)
                  & ((row > v2) | (i2 < 0)))
        v2 = torch.where(better, row, v2)
        i2 = torch.where(better, (yc * w).to(torch.int32)[..., None, None] + col,
                         i2)
    return (v2.reshape(*lead, r, p, p, c), i2.reshape(*lead, r, p, p, c))


def roi_pool(features: torch.Tensor, rois: torch.Tensor, output_size: int = 7,
             spatial_scale: float = 1.0) -> torch.Tensor:
    """RoIPool max, torchvision semantics: ``[..., H, W, C]`` map and
    ``[..., R, 4]`` rois -> ``[..., R, P, P, C]`` f32 (empty bins 0)."""
    return roi_pool_argmax(features, rois, output_size, spatial_scale)[0]


NEG_INF = -1e30


def _pool_masks(rois: torch.Tensor, h: int, w: int, p: int,
                spatial_scale: float):
    """Column / row bin membership of ``rois [..., R, 4]``: ``(col [..., R,
    P, W], row [..., R, P, H])`` bool."""
    q = torch.round(rois.to(torch.float32) * spatial_scale).to(torch.int64)
    xs, xe = _bin_edges_pool(q[..., 0], q[..., 2], p)
    ys, ye = _bin_edges_pool(q[..., 1], q[..., 3], p)
    xs, xe = xs.clamp(0, w)[..., None], xe.clamp(0, w)[..., None]
    ys, ye = ys.clamp(0, h)[..., None], ye.clamp(0, h)[..., None]
    cols = torch.arange(w, device=rois.device)
    rows = torch.arange(h, device=rois.device)
    return (cols >= xs) & (cols < xe), (rows >= ys) & (rows < ye)


def _two_stage_max(f: torch.Tensor, cm: torch.Tensor, rm: torch.Tensor):
    """The separable masked max of the JAX ``roi_pool`` on one image:
    ``f [H, W, C]`` -> stage 1 ``[R, Pw, H, C]`` (max over a bin's columns
    in every row) and stage 2 ``[R, Ph, Pw, C]`` (max over a bin's rows);
    masked-out entries are ``NEG_INF``."""
    s1 = torch.where(cm[:, :, None, :, None], f[None, None], NEG_INF).amax(3)
    s2 = torch.where(rm[:, :, None, :, None], s1[:, None], NEG_INF).amax(3)
    return s1, s2


_ROI_CHUNK = 8


def _chunks(rois: torch.Tensor):
    """``(image index, roi slice)`` pairs covering ``rois [B, R, 4]``,
    ``_ROI_CHUNK`` rois each."""
    for i in range(rois.shape[0]):
        for r0 in range(0, rois.shape[1], _ROI_CHUNK):
            yield i, slice(r0, r0 + _ROI_CHUNK)


def roi_pool_grad_xla(feats: torch.Tensor, rois: torch.Tensor, g: torch.Tensor,
                      output_size: int = 7,
                      spatial_scale: float = 1.0) -> torch.Tensor:
    """RoIPool max backward by autodiff of the two-stage masked max.

    ``torch.amax`` hands its cotangent to the ties in equal shares, as the
    ``reduce_max`` of XLA does, so a tied stage-2 maximum is split among its
    rows and each row's share among that row's tied columns.

    ``feats [B, H, W, C]``, ``rois [B, R, 4]``, ``g [B, R, P, P, C]`` ->
    ``dfeat [B, H, W, C]`` in the map's dtype (accumulated in f32).
    """
    _, h, w, _ = feats.shape
    out = torch.zeros(feats.shape, dtype=torch.float32, device=feats.device)
    for i, rs in _chunks(rois):
        cm, rm = _pool_masks(rois[i, rs], h, w, output_size, spatial_scale)
        with torch.enable_grad():
            f = feats[i].detach().to(torch.float32).requires_grad_(True)
            s2 = _two_stage_max(f, cm, rm)[1]
            pooled = torch.where(s2 <= NEG_INF / 2, 0.0, s2)
            out[i] += torch.autograd.grad(pooled, f,
                                          g[i, rs].to(torch.float32))[0]
    return out.to(feats.dtype)


def roi_pool_grad_structured(feats: torch.Tensor, rois: torch.Tensor,
                             g: torch.Tensor, output_size: int = 7,
                             spatial_scale: float = 1.0) -> torch.Tensor:
    """RoIPool max backward with the credit written out: both max stages
    recomputed, equality masks against them, and each stage's credit divided
    by its tie count.  Shapes as :func:`roi_pool_grad_xla`."""
    _, h, w, _ = feats.shape
    out = torch.zeros(feats.shape, dtype=torch.float32, device=feats.device)
    for i, rs in _chunks(rois):
        cm, rm = _pool_masks(rois[i, rs], h, w, output_size, spatial_scale)
        f = feats[i].detach().to(torch.float32)
        s1, s2 = _two_stage_max(f, cm, rm)
        gi = g[i, rs].to(torch.float32)
        # stage-2 credit; empty bins die at the stage-1 compare (f != NEG_INF)
        eq2 = (rm[:, :, None, :, None]
               & (s1[:, None] == s2[:, :, :, None, :])).to(torch.float32)
        n2 = eq2.sum(dim=3, keepdim=True).clamp(min=1.0)     # [R,Ph,Pw,1,C]
        ds1 = (eq2 / n2 * gi[:, :, :, None, :]).sum(dim=1)   # [R,Pw,H,C]
        eq1 = (cm[:, :, None, :, None]
               & (f[None, None] == s1[:, :, :, None, :])).to(torch.float32)
        n1 = eq1.sum(dim=3, keepdim=True).clamp(min=1.0)     # [R,Pw,H,1,C]
        out[i] += (eq1 / n1 * ds1[:, :, :, None, :]).sum(dim=(0, 1))
    return out.to(feats.dtype)


def scatter_argmax_grad(argmax: torch.Tensor, g: torch.Tensor, h: int,
                        w: int) -> torch.Tensor:
    """Add each pooled cotangent at its bin's argmax: the plain version of
    kernel 5's scatter backward.

    ``argmax [B, R, P, P, C]`` flat ``y*W + x`` (-1: empty bin, dropped),
    ``g`` of the same shape -> ``[B, H, W, C]`` in ``g``'s dtype.
    """
    b, c = argmax.shape[0], argmax.shape[-1]
    idx = argmax.reshape(b, -1, c).to(torch.int64)
    # cell h*w collects the empty bins and is cut off
    idx = torch.where(idx < 0, h * w, idx)
    out = torch.zeros((b, h * w + 1, c), dtype=g.dtype, device=g.device)
    out.scatter_add_(1, idx, g.reshape(b, -1, c))
    return out[:, :h * w].reshape(b, h, w, c)


def roi_pool_grad_first_argmax(feats: torch.Tensor, rois: torch.Tensor,
                               g: torch.Tensor, output_size: int = 7,
                               spatial_scale: float = 1.0) -> torch.Tensor:
    """RoIPool max backward with all of a bin's cotangent credited to its
    first maximum in row-major order, recomputed from the map: the plain
    version of kernel 6.  Shapes as :func:`roi_pool_grad_xla`."""
    _, h, w, _ = feats.shape
    out = torch.empty(feats.shape, dtype=torch.float32, device=feats.device)
    for i in range(feats.shape[0]):       # [R, P, H, C] slabs, one image each
        argmax = roi_pool_argmax(feats[i:i + 1].detach(), rois[i:i + 1],
                                 output_size, spatial_scale)[1]
        out[i] = scatter_argmax_grad(argmax, g[i:i + 1].to(torch.float32),
                                     h, w)[0]
    return out.to(feats.dtype)


def roi_pool_structured(features: torch.Tensor, rois: torch.Tensor,
                        output_size: int = 7,
                        spatial_scale: float = 1.0) -> torch.Tensor:
    """:func:`roi_pool` whose backward is :func:`roi_pool_grad_structured`
    (the JAX ``roi_pool_structured``): both max stages recomputed, each
    stage's credit split evenly among its ties.  ``[..., H, W, C]`` map and
    ``[..., R, 4]`` rois -> ``[..., R, P, P, C]`` f32; the plain forward on
    any device."""
    from .roi_pool_bwd import (
        roi_pool_recompute)
    h, w, c = features.shape[-3:]
    r, p = rois.shape[-2], output_size
    out = roi_pool_recompute(features.reshape(-1, h, w, c),
                             rois.reshape(-1, r, 4), p, spatial_scale,
                             "structured")
    return out.reshape(*rois.shape[:-2], r, p, p, c)


def roi_align(features: torch.Tensor, rois: torch.Tensor,
              output_size: int = 7, spatial_scale: float = 1.0,
              sampling_ratio: int = 2, aligned: bool = False) -> torch.Tensor:
    """Single-level bilinear RoIAlign (the JAX ``roi_align``), computed as
    :func:`roi_align_mm` on the map in f32: the same bin averages of the
    same clipped samples, summed in another order.

    ``[..., H, W, C]`` map and ``[..., R, 4]`` xyxy rois (times
    ``spatial_scale``: map coordinates) -> ``[..., R, P, P, C]`` f32.
    """
    return roi_align_mm(features.float(), rois, output_size, spatial_scale,
                        sampling_ratio, aligned)


def scale_pairs(scales, n_levels: int):
    """Per-level ``(sy, sx)`` Python floats from scalar-or-pair scales."""
    return [(float(s), float(s)) if not isinstance(s, (tuple, list))
            else (float(s[0]), float(s[1])) for s in scales[:n_levels]]


def _norm_scales(scales, n_levels: int) -> torch.Tensor:
    """``[L, 2]`` (sy, sx) float32 from scalar-or-pair per-level scales."""
    return torch.tensor(scale_pairs(scales, n_levels), dtype=torch.float32)


def _sample_grid(p: int, s: int, device) -> torch.Tensor:
    """``[P*S]`` sample offsets in bins: ``q + (k + 0.5) / s``."""
    return (torch.arange(p, device=device)[:, None]
            + div_exact(torch.arange(s, device=device)[None, :] + 0.5, s)
            ).reshape(-1)


def _align_weights_local(c_global: torch.Tensor, origin: torch.Tensor,
                         p: int, s: int, win: int) -> torch.Tensor:
    """Window-relative RoIAlign weights ``[..., P, win]`` from the clipped
    level coordinates ``c_global [..., P*S]`` and window origins ``[...]``."""
    c = torch.clamp(c_global - origin[..., None].to(torch.float32),
                    0.0, win - 1.0)
    i0 = torch.floor(c).to(torch.int64)
    i1 = torch.clamp(i0 + 1, max=win - 1)
    f = c - i0
    w = (F.one_hot(i0, win).to(torch.float32) * (1.0 - f)[..., None]
         + F.one_hot(i1, win).to(torch.float32) * f[..., None])
    return div_exact(w.reshape(*w.shape[:-2], p, s, win).sum(dim=-2), s)


def _align_weights(lo: torch.Tensor, span: torch.Tensor, p: int, s: int,
                   size: int) -> torch.Tensor:
    """Dense separable RoIAlign weights along one axis, ``[..., R, P, size]``:
    row ``(r, q)`` holds the averaged bilinear weights of bin ``q``'s ``s``
    sample points on a level ``size`` cells long."""
    c = lo[..., None] + _sample_grid(p, s, lo.device) * div_exact(span, p)[..., None]
    c = torch.clamp(c, 0.0, size - 1.0)
    i0 = torch.floor(c).to(torch.int64)
    i1 = torch.clamp(i0 + 1, max=size - 1)
    f = c - i0
    w = (F.one_hot(i0, size).to(torch.float32) * (1.0 - f)[..., None]
         + F.one_hot(i1, size).to(torch.float32) * f[..., None])
    return div_exact(w.reshape(*w.shape[:-2], p, s, size).sum(dim=-2), s)


def _level_align_weights(rois: torch.Tensor, sy: float, sx: float, p: int,
                         s: int, h: int, w: int, aligned: bool):
    """Dense RoIAlign weight pair of one pyramid level for ``rois [..., R,
    4]`` in image coordinates: ``(wy [..., R, P, H], wx [..., R, P, W])``."""
    off = 0.5 if aligned else 0.0
    r4 = rois.to(torch.float32) * device_constant(
        [sx, sy, sx, sy], torch.float32, rois.device) - off
    roi_w = torch.clamp(r4[..., 2] - r4[..., 0], min=1.0)
    roi_h = torch.clamp(r4[..., 3] - r4[..., 1], min=1.0)
    return (_align_weights(r4[..., 1], roi_h, p, s, h),
            _align_weights(r4[..., 0], roi_w, p, s, w))


def roi_pool_mean(features: torch.Tensor, rois: torch.Tensor,
                  output_size: int = 7,
                  spatial_scale: float = 1.0) -> torch.Tensor:
    """Average RoI pooling over the RoIPool max bins, as two matrix products.

    ``features [..., H, W, C]``, ``rois [..., R, 4]`` -> ``[..., R, P, P,
    C]`` in the features' dtype: stage 1 sums each column bin, stage 2 each
    row bin, both with the bin masks cast to that dtype, and the sum is
    divided by ``max(count, 1)`` per axis, so an empty bin is 0.
    """
    h, w = features.shape[-3:-1]
    p, dt = output_size, features.dtype
    cm, rm = _pool_masks(rois, h, w, p, spatial_scale)    # [...,R,P,W], [...,R,P,H]
    cnt_c = cm.sum(-1).clamp(min=1).to(torch.float32)      # [..., R, P]
    cnt_r = rm.sum(-1).clamp(min=1).to(torch.float32)
    s1 = torch.einsum("...rqw,...hwc->...rqhc", cm.to(dt), features)
    s2 = torch.einsum("...rph,...rqhc->...rpqc", rm.to(dt), s1)
    norm = cnt_r[..., :, None, None] * cnt_c[..., None, :, None]
    return s2 / norm.to(dt)


def roi_align_mm(features: torch.Tensor, rois: torch.Tensor,
                 output_size: int = 7, spatial_scale: float = 1.0,
                 sampling_ratio: int = 2, aligned: bool = False) -> torch.Tensor:
    """Dense RoIAlign as two matrix products (the JAX package's
    ``roi_align_mm``): ``out[r, p, q, c] = sum_h WY[r, p, h] sum_w WX[r, q,
    w] f[h, w, c]``, the separable bilinear weights averaged over each bin's
    ``sampling_ratio`` samples per axis.

    ``features [..., H, W, C]``, ``rois [..., R, 4]`` xyxy (times
    ``spatial_scale`` to reach map coordinates) -> ``[..., R, P, P, C]`` in
    the features' dtype, the weights cast to it.  Stage 1 contracts the map
    rows of every roi at once (one ``[R*P, H] @ [H, W*C]`` product an
    image), stage 2 the columns per roi.
    """
    h, w = features.shape[-3:-1]
    p, s, dt = output_size, sampling_ratio, features.dtype
    wy, wx = _level_align_weights(rois, spatial_scale, spatial_scale, p, s,
                                  h, w, aligned)         # [...,R,P,H], [...,R,P,W]
    lead, r = rois.shape[:-2], rois.shape[-2]
    f = features.reshape(-1, h, w * features.shape[-1])
    s1 = torch.matmul(wy.to(dt).reshape(f.shape[0], r * p, h), f)
    s1 = s1.reshape(*lead, r, p, w, -1)                  # [..., R, Py, W, C]
    return torch.einsum("...rqw,...rpwc->...rpqc", wx.to(dt), s1)


def multilevel_roi_align_dense_grad(shapes, dtype, rois: torch.Tensor,
                                    levels: torch.Tensor, scales,
                                    g: torch.Tensor, output_size: int = 7,
                                    sampling_ratio: int = 2,
                                    aligned: bool = False):
    """Gradient of the dense multi-level RoIAlign with respect to the
    pyramid: ``dF_l = sum_r 1[lvl_r = l] WY_l[r]^T g[r] WX_l[r]``, two
    matrix products per level, in the levels' dtype.

    ``shapes``: per-level ``(H, W)``; ``rois [B, R, 4]``; ``levels [B, R]``
    (0 = finest); ``g [B, R, P, P, C]``.  Returns per-level ``[B, H, W, C]``.
    """
    p, s = output_size, sampling_ratio
    sc = scale_pairs(scales, len(shapes))
    out = []
    for li, (h, w) in enumerate(shapes):
        sy, sx = sc[li]
        wy, wx = _level_align_weights(rois, sy, sx, p, s, h, w, aligned)
        gm = torch.where((levels == li)[..., None, None, None], g, 0).to(dtype)
        t = torch.einsum("brqw,brpqc->brpwc", wx.to(dtype), gm)
        out.append(torch.einsum("brph,brpwc->bhwc", wy.to(dtype), t))
    return out


def _roi_samples(rois, levels, sizes, sc, p: int, s: int, aligned: bool):
    """Clipped level-space sample coordinates ``(cy, cx)``, each
    ``[..., R, P*S]``, of rois on their assigned levels."""
    off = 0.5 if aligned else 0.0
    sy, sx = sc[levels, 0], sc[levels, 1]
    r4 = rois.to(torch.float32) * torch.stack([sx, sy, sx, sy], dim=-1) - off
    h_l, w_l = sizes[levels, 0], sizes[levels, 1]
    roi_w = torch.clamp(r4[..., 2] - r4[..., 0], min=1.0)
    roi_h = torch.clamp(r4[..., 3] - r4[..., 1], min=1.0)
    grid = _sample_grid(p, s, rois.device)
    bin_h, bin_w = div_exact(roi_h, p), div_exact(roi_w, p)
    cy = torch.minimum(torch.clamp(r4[..., 1:2] + grid * bin_h[..., None],
                                   min=0.0), (h_l - 1.0)[..., None])
    cx = torch.minimum(torch.clamp(r4[..., 0:1] + grid * bin_w[..., None],
                                   min=0.0), (w_l - 1.0)[..., None])
    return cy, cx


def _windowed_prologue(pyramid, rois: torch.Tensor, levels: torch.Tensor,
                       scales, p: int, s: int, win: int, aligned: bool):
    """Level atlas, window origins and window-relative weights.

    ``pyramid``: per-level ``[..., H_l, W_l, C]``; ``rois [..., R, 4]``;
    ``levels [..., R]`` (0 = finest).  The JAX prologue with ``x_quant=1``.

    Returns ``(atlas [..., sum_hb, w_pad, C], starts_y [..., R], ox [..., R],
    wy [..., R, P, win], wx [..., R, P, win])``.
    """
    dev = rois.device
    w_pad = max(max(int(f.shape[-2]) for f in pyramid), win)
    blocks, row_off, block_h = [], [], []
    off = 0
    for f in pyramid:
        h_l, w_l = int(f.shape[-3]), int(f.shape[-2])
        hb = max(h_l, win)
        blocks.append(F.pad(f, (0, 0, 0, w_pad - w_l, 0, hb - h_l)))
        row_off.append(off)
        block_h.append(hb)
        off += hb
    atlas = torch.cat(blocks, dim=-3)                     # [..., sum_hb, w_pad, C]

    sizes = torch.tensor([[f.shape[-3], f.shape[-2]] for f in pyramid],
                         dtype=torch.float32, device=dev)
    sc = _norm_scales(scales, len(pyramid)).to(dev)
    levels = levels.to(torch.int64)
    cy, cx = _roi_samples(rois, levels, sizes, sc, p, s, aligned)
    block_h_t = torch.tensor(block_h, dtype=torch.int64, device=dev)
    row_off_t = torch.tensor(row_off, dtype=torch.int64, device=dev)
    oy = torch.minimum(torch.clamp(torch.floor(cy[..., 0]).to(torch.int64), min=0),
                       block_h_t[levels] - win)
    ox = torch.clamp(torch.floor(cx[..., 0]).to(torch.int64), 0, w_pad - win)
    wy = _align_weights_local(cy, oy, p, s, win)
    wx = _align_weights_local(cx, ox, p, s, win)
    return atlas, row_off_t[levels] + oy, ox, wy, wx


def multilevel_roi_align(pyramid, rois: torch.Tensor, levels: torch.Tensor,
                         scales, output_size: int = 7, sampling_ratio: int = 2,
                         window: int = 32, aligned: bool = False) -> torch.Tensor:
    """FPN multi-level RoIAlign via per-roi windows.

    Args:
      pyramid: per-level ``[..., H_l, W_l, C]`` features (P2..P5).
      rois: ``[..., R, 4]`` xyxy in image coordinates.
      levels: ``[..., R]`` integer index into ``pyramid`` (0 = finest).
      scales: per-level image->feature scale, scalars or ``(sy, sx)`` pairs.

    Returns ``[..., R, P, P, C]`` in the features' dtype: stage 1 contracts
    the window rows, stage 2 the window columns, both in that dtype.
    """
    p, s, win = output_size, sampling_ratio, window
    dt = pyramid[0].dtype
    atlas, starts_y, ox, wy, wx = _windowed_prologue(
        pyramid, rois, levels, scales, p, s, win, aligned)
    lead, r = rois.shape[:-2], rois.shape[-2]
    atlas = atlas.reshape(-1, *atlas.shape[-3:])          # [B, sum_hb, w_pad, C]
    ar = torch.arange(win, device=rois.device)
    ys = (starts_y.reshape(-1, r)[..., None] + ar)[..., :, None]   # [B, R, win, 1]
    xs = (ox.reshape(-1, r)[..., None] + ar)[..., None, :]         # [B, R, 1, win]
    bidx = torch.arange(atlas.shape[0], device=rois.device)[:, None, None, None]
    windows = atlas[bidx, ys, xs]                          # [B, R, win, win, C]
    wy = wy.reshape(-1, r, p, win)
    wx = wx.reshape(-1, r, p, win)
    s1 = torch.einsum("brph,brhwc->brpwc", wy.to(dt), windows)
    out = torch.einsum("brqw,brpwc->brpqc", wx.to(dt), s1)
    return out.reshape(*lead, r, p, p, -1)


def window_coverage(rois: torch.Tensor, levels: torch.Tensor, sizes, scales,
                    output_size: int = 7, sampling_ratio: int = 2,
                    window: int = 32, aligned: bool = False) -> torch.Tensor:
    """Per roi: does the window hold every bilinear tap of the roi?

    True where the windowed result equals a dense RoIAlign on the level;
    False where the edge clamp engages.  ``sizes``: ``[L, 2]`` level (H, W).
    """
    p, s, win = output_size, sampling_ratio, window
    dev = rois.device
    sizes = torch.as_tensor(sizes, dtype=torch.float32, device=dev)
    sc = _norm_scales(scales, sizes.shape[0]).to(dev)
    levels = levels.to(torch.int64)
    off = 0.5 if aligned else 0.0
    sy, sx = sc[levels, 0], sc[levels, 1]
    r4 = rois.to(torch.float32) * torch.stack([sx, sy, sx, sy], dim=-1) - off
    h_l, w_l = sizes[levels, 0], sizes[levels, 1]
    block_h = torch.clamp(h_l, min=float(win))
    block_w = torch.clamp(w_l, min=float(win))
    bin_w = div_exact(torch.clamp(r4[..., 2] - r4[..., 0], min=1.0), p)
    bin_h = div_exact(torch.clamp(r4[..., 3] - r4[..., 1], min=1.0), p)
    grid_last = (p - 1) + (s - 0.5) / s

    def clip(v, hi):
        return torch.minimum(torch.clamp(v, min=0.0), hi)

    y0 = clip(r4[..., 1] + 0.5 / s * bin_h, h_l - 1.0)
    x0 = clip(r4[..., 0] + 0.5 / s * bin_w, w_l - 1.0)
    y1 = clip(r4[..., 1] + grid_last * bin_h, h_l - 1.0)
    x1 = clip(r4[..., 0] + grid_last * bin_w, w_l - 1.0)
    oy = clip(torch.floor(y0), block_h - win)
    ox = clip(torch.floor(x0), block_w - win)
    return (torch.ceil(y1) <= oy + (win - 1)) & (torch.ceil(x1) <= ox + (win - 1))
