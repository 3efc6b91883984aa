"""RoIPool max with the hand-written kernel (kernel 5) and its backward.

The counterpart of the JAX package's ``ops/pallas_roi.py``
(``roi_pool_pallas``): RoIPool max with torchvision integer bins over a
batch, plus the flat index ``y*W + x`` of the first maximum of each bin in
row-major order (-1, value 0, for an empty bin).  On CUDA tensors it
launches ``csrc/roi_pool.cu`` through a custom op (``tsod::roi_pool_max``,
values only, or ``tsod::roi_pool_max_argmax``; ``torch.export`` keeps either
in its graph) on one of two routes, chosen by shape alone
(:func:`roi_pool_plan`):

* **slice** (every map whose one-vector slice fits in a block's shared
  memory, H x W up to 12,928 pixels with 16-byte vectors; the RoI head's
  38x38 map): a block per (channel slice, image, roi chunk) copies its
  ``[H, W, slice]`` part of the map into shared memory once and pools
  every roi of its chunk from there;
* **direct** (larger maps): a block per (roi, image) reads each bin from
  global memory, 4 channels a thread.

Its plain version is
:func:`~..ops.roi_pool.roi_pool_argmax`, which runs on the CPU, or on any
device with ``use_kernel=False``.  Same outputs either way, bit for bit:
max is exact in any float format.

:func:`roi_pool_max` is differentiable in the map: its backward adds each
pooled cotangent at the saved argmax and drops the empty bins
(:func:`roi_pool_bwd_scatter`, kernel 5b, in ``csrc/roi_pool_bwd.cu``;
plain version :func:`~..ops.roi_pool.scatter_argmax_grad`).  On the RoI
head's map a block adds one channel slice of an image in shared memory and
writes it once; maps too large for that take atomic adds into a zeroed map
(:func:`roi_pool_bwd_plan`, which also plans kernel 6).  The additions
collide in no fixed order, so that gradient equals the plain version's up
to f32 summation order.
"""

from __future__ import annotations

import functools

import torch

from two_stage_object_detection_tpu_torch.ops import _cuda
from two_stage_object_detection_tpu_torch.ops.roi_pool import (
    roi_pool_argmax, scatter_argmax_grad)

# what a block may hold in dynamic shared memory on the H100 (232,448
# bytes, less room for the slice kernel's static mbarrier), of which
# EDGE_BYTES are kept for the bin edges of a chunk's rois (8 * P bytes a
# roi) and the (ph, pw) of each bin (4 * P^2)
SLICE_SMEM_BYTES = 232448 - 1024
EDGE_BYTES = 24576
H100_SMS = 132
SLICE_THREADS = 1024


def roi_pool_plan(b: int, h: int, w: int, c: int, r: int, elem_bytes: int,
                  n_sm: int = H100_SMS, pooled: int = 7) -> dict:
    """How kernel 5 covers a ``[b, h, w, c]`` map and ``r`` rois an image.

    A pixel's channels go in vectors of 16 bytes (8 bf16 or 4 f32), or 8
    (4 bf16) where ``c * elem_bytes`` is not a multiple of 16.  A slice is
    ``nv`` vectors of every pixel; it must fit in ``SLICE_SMEM_BYTES -
    EDGE_BYTES``, and where even one vector a pixel does not (H x W above
    12,928 pixels with 16-byte vectors), the route is ``"direct"``.  Among
    the slice counts that fit, the plan takes the one that gives the fewest
    vectors a block times waves of ``n_sm`` blocks (ties: fewer slices),
    then splits the rois into chunks while the grid is under ``n_sm``
    blocks, and into more where one chunk's bin edges would not fit in
    ``EDGE_BYTES``.  Returns ``{"route", "vec_bytes", "nv", "n_slices",
    "n_chunks", "smem_bytes"}``.
    """
    vec = 16 if (c * elem_bytes) % 16 == 0 else 8
    cv = c * elem_bytes // vec
    max_nv = min((SLICE_SMEM_BYTES - EDGE_BYTES) // (h * w * vec),
                 SLICE_THREADS)
    max_rois = (EDGE_BYTES - 4 * pooled * pooled) // (8 * pooled)
    if max_nv == 0 or max_rois < 1 or h * w >= 1 << 16:
        return {"route": "direct", "vec_bytes": 0, "nv": 0, "n_slices": 0,
                "n_chunks": 0, "smem_bytes": 0}
    best = None
    for n_slices in range(-(-cv // max_nv), cv + 1):
        nv = -(-cv // n_slices)
        if -(-cv // nv) != n_slices:
            continue                       # the same nv as fewer slices
        cost = -(-(b * n_slices) // n_sm) * nv
        if best is None or cost < best[0]:
            best = (cost, n_slices, nv)
    _, n_slices, nv = best
    n_chunks = max(-(-r // max_rois), min(r, n_sm // (b * n_slices)), 1)
    per_chunk = -(-r // n_chunks)
    return {"route": "slice", "vec_bytes": vec, "nv": nv,
            "n_slices": n_slices, "n_chunks": -(-r // per_chunk),
            "smem_bytes": (-(-(h * w * nv * vec) // 16) * 16
                           + (per_chunk * 2 * pooled + pooled * pooled) * 4)}


BWD_KINDS = ("recompute", "scatter")


def roi_pool_bwd_plan(kind: str, b: int, h: int, w: int, c: int, r: int,
                      elem_bytes: int, n_sm: int = H100_SMS,
                      pooled: int = 7) -> dict:
    """How the RoIPool backward kernels cover a ``[b, h, w, c]`` map.

    ``kind`` ``"recompute"`` is kernel 6 (``ops/roi_pool_bwd.py``), whose
    block holds the map's slice (``elem_bytes`` a channel) in vectors of 16
    bytes (8 where ``c * elem_bytes`` is not a multiple of 16), its f32
    gradient, and the bin edges of up to ``rois_per_pass`` rois (8 * P
    bytes each; all ``r`` where ``EDGE_BYTES`` hold them) and each bin's
    (ph, pw) (4 * P^2).  ``"scatter"`` is kernel 5b
    (:func:`roi_pool_bwd_scatter`), whose block holds the f32 gradient
    slice alone, in vectors of 4 channels.  A slice is ``nv`` vectors of
    every pixel; kernel 6's gradient keeps one float more a pixel (an odd
    stride, so that a warp's adds spread over the banks).  It must fit in
    ``SLICE_SMEM_BYTES``; where even one vector does not (or the map has
    65,536 pixels or more), the route is ``"direct"``: the kernels before
    the slice, with global atomics into a zeroed f32 map.

    The grid is one block a slice and image (``n_slices`` x ``b``), with no
    roi chunks, so nothing is flushed across blocks.  Among the widths that
    fit, the plan takes the one whose busiest SM holds the fewest vectors,
    waves of ``n_sm`` blocks (one a SM: a slice takes most of its shared
    memory) times ``nv``; ties go to fewer slices.  As one-vector slices
    are always a choice, that is ``ceil(b * cv / n_sm)`` vectors, ``cv``
    the vectors of a pixel.  Returns ``{"route", "vec_bytes", "nv",
    "n_slices", "rois_per_pass", "smem_bytes"}``.
    """
    if kind not in BWD_KINDS:
        raise ValueError(f"kind must be one of {BWD_KINDS}, got {kind!r}")
    hw = h * w

    if kind == "recompute":
        vec = 16 if (c * elem_bytes) % 16 == 0 else 8
        ch = vec // elem_bytes
        rois_per_pass = max(1, min(r, (EDGE_BYTES - 4 * pooled * pooled)
                                   // (8 * pooled)))
        fixed = (rois_per_pass * 2 * pooled + pooled * pooled) * 4

        def smem(nv):
            grad = -(-(hw * (nv * ch + 1) * 4) // 16) * 16
            return -(-(hw * nv * vec) // 16) * 16 + grad + fixed
    else:
        vec, ch, rois_per_pass = 16, 4, 0

        def smem(nv):
            return hw * nv * 16
    cv = c // ch
    max_nv = min(cv, SLICE_THREADS)
    while max_nv > 0 and smem(max_nv) > SLICE_SMEM_BYTES:
        max_nv -= 1
    if max_nv == 0 or hw >= 1 << 16:
        return {"route": "direct", "vec_bytes": 0, "nv": 0, "n_slices": 0,
                "rois_per_pass": 0, "smem_bytes": 0}
    best = None
    for n_slices in range(-(-cv // max_nv), cv + 1):
        nv = -(-cv // n_slices)
        if -(-cv // nv) != n_slices:
            continue                       # the same nv as fewer slices
        cost = -(-(b * n_slices) // n_sm) * nv
        if best is None or cost < best[0]:
            best = (cost, n_slices, nv)
    _, n_slices, nv = best
    return {"route": "slice", "vec_bytes": vec, "nv": nv,
            "n_slices": n_slices, "rois_per_pass": rois_per_pass,
            "smem_bytes": smem(nv)}


def _forward(feats: torch.Tensor, rois: torch.Tensor, output_size: int,
             spatial_scale: float, use_kernel: bool, with_argmax: bool):
    """Kernel 5 or its plain version, outside autograd: ``(pooled, argmax or
    None)``."""
    if not (use_kernel and rois.is_cuda):
        pooled, argmax = roi_pool_argmax(feats, rois, output_size,
                                         spatial_scale)
        return pooled, (argmax if with_argmax else None)
    if with_argmax:
        return tuple(roi_pool_argmax_op(feats, rois, output_size,
                                        float(spatial_scale)))
    return roi_pool_values_op(feats, rois, output_size,
                              float(spatial_scale)), None


@torch.library.custom_op("tsod::roi_pool_max", mutates_args=(),
                         device_types="cuda")
def roi_pool_values_op(feats: torch.Tensor, rois: torch.Tensor,
                       output_size: int, spatial_scale: float) -> torch.Tensor:
    """Kernel 5 without the index, as a custom op, so that ``torch.export``
    keeps the launch in its graph; counted in ``launch.roi_pool_max``.
    Arguments as :func:`roi_pool_max`; returns ``pooled``."""
    return _launch(feats, rois, output_size, spatial_scale, False)[0]


@roi_pool_values_op.register_fake
def _(feats, rois, output_size, spatial_scale):
    return _pooled_like(feats, rois, output_size)


@torch.library.custom_op("tsod::roi_pool_max_argmax", mutates_args=(),
                         device_types="cuda")
def roi_pool_argmax_op(feats: torch.Tensor, rois: torch.Tensor,
                       output_size: int, spatial_scale: float
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel 5 with the index (a custom op cannot return ``None``, so the
    two forms are two ops); returns ``(pooled, argmax)``."""
    return _launch(feats, rois, output_size, spatial_scale, True)


@roi_pool_argmax_op.register_fake
def _(feats, rois, output_size, spatial_scale):
    pooled = _pooled_like(feats, rois, output_size)
    return pooled, torch.empty_like(pooled, dtype=torch.int32)


def _pooled_like(feats, rois, p):
    b, r = rois.shape[:2]
    return feats.new_empty((b, r, p, p, feats.shape[-1]), dtype=torch.float32)


def _launch(feats, rois, output_size, spatial_scale, with_argmax):
    """Launch kernel 5 (``csrc/roi_pool.cu``) on checked CUDA tensors."""
    feats, rois = feats.contiguous(), rois.contiguous()
    b, h, w, c = feats.shape
    r, p = rois.shape[1], output_size
    code = _cuda.dtype_code(feats.dtype, "roi_pool")
    if c % 4:
        raise ValueError(f"roi_pool kernel takes C a multiple of 4, got {c}")
    _cuda.require(feats, "feats", feats.dtype, (b, h, w, c))
    _cuda.require(rois, "rois", torch.float32, (b, r, 4))
    pooled = torch.empty((b, r, p, p, c), dtype=torch.float32, device=rois.device)
    argmax = (torch.empty((b, r, p, p, c), dtype=torch.int32, device=rois.device)
              if with_argmax else None)
    if r == 0 or b == 0:
        return pooled, argmax
    plan = _plan(rois.device.index, b, h, w, c, r, feats.element_size(), p)
    _cuda.launch("roi_pool_launch", rois.device, feats.data_ptr(),
                 rois.data_ptr(), pooled.data_ptr(),
                 None if argmax is None else argmax.data_ptr(), b, h, w, c, r,
                 p, spatial_scale, code, plan["vec_bytes"], plan["nv"],
                 plan["n_slices"], plan["n_chunks"],
                 count="launch.roi_pool_max")
    return pooled, argmax


class _RoIPoolMax(torch.autograd.Function):
    @staticmethod
    def forward(ctx, feats, rois, output_size, spatial_scale, use_kernel,
                with_argmax):
        need_grad = ctx.needs_input_grad[0]
        pooled, argmax = _forward(feats.detach(), rois, output_size,
                                  spatial_scale, use_kernel,
                                  with_argmax or need_grad)
        if need_grad:
            ctx.save_for_backward(argmax)
            ctx.hw, ctx.dtype = feats.shape[1:3], feats.dtype
            ctx.use_kernel = use_kernel
        if not with_argmax:
            return pooled, None
        ctx.mark_non_differentiable(argmax)
        return pooled, argmax

    @staticmethod
    def backward(ctx, g, _):
        (argmax,) = ctx.saved_tensors
        dfeat = roi_pool_bwd_scatter(argmax, g.contiguous(), *ctx.hw,
                                     use_kernel=ctx.use_kernel)
        return dfeat.to(ctx.dtype), None, None, None, None, None


def roi_pool_max(feats: torch.Tensor, rois: torch.Tensor, output_size: int = 7,
                 spatial_scale: float = 1.0, use_kernel: bool = True,
                 with_argmax: bool = True):
    """Kernel 5: RoIPool max with argmax over a batch, differentiable in
    ``feats``.

    Args:
      feats: ``[B, H, W, C]`` map, f32 or bf16 (pooled in f32); the kernel
        reads 4 channels a thread and takes C a multiple of 4.
      rois: ``[B, R, 4]`` xyxy f32, multiplied by ``spatial_scale`` to reach
        map coordinates.
      with_argmax: return the index.  With False the index is computed
        only where a backward pass will read it (gradients enabled and
        ``feats`` requires one); otherwise, as under ``inference_mode``, the
        kernel is handed no index buffer and skips that store, half of its
        bytes.

    Returns ``(pooled [B, R, P, P, C] f32, argmax [B, R, P, P, C] int32 or
    None)``.
    """
    return _RoIPoolMax.apply(feats, rois, output_size, spatial_scale,
                             use_kernel, with_argmax)


@functools.lru_cache(maxsize=None)
def _plan(device_index, b, h, w, c, r, elem_bytes, pooled):
    n_sm = torch.cuda.get_device_properties(device_index).multi_processor_count
    return roi_pool_plan(b, h, w, c, r, elem_bytes, n_sm, pooled)


@functools.lru_cache(maxsize=None)
def bwd_plan(kind, device_index, b, h, w, c, r, elem_bytes, pooled):
    """:func:`roi_pool_bwd_plan` for the card of ``device_index``."""
    n_sm = torch.cuda.get_device_properties(device_index).multi_processor_count
    return roi_pool_bwd_plan(kind, b, h, w, c, r, elem_bytes, n_sm, pooled)


def roi_pool_bwd_scatter(argmax: torch.Tensor, g: torch.Tensor, h: int,
                         w: int, use_kernel: bool = True) -> torch.Tensor:
    """Kernel 5b, kernel 5's backward: add ``g`` at each bin's argmax.

    ``argmax [B, R, P, P, C]`` int32 (-1: empty bin, dropped), ``g`` of the
    same shape, f32 -> ``dfeat [B, H, W, C]`` f32.  On CUDA tensors with
    ``use_kernel`` it launches ``csrc/roi_pool_bwd.cu`` on the route of
    :func:`roi_pool_bwd_plan` (``"slice"``: a block adds one channel slice
    of an image in shared memory and writes it once; ``"direct"``: atomic
    adds into a zeroed map); either way equal to the plain version up to f32
    summation order.  Otherwise it runs
    :func:`~..ops.roi_pool.scatter_argmax_grad`.  Each launch is counted in
    ``launch.roi_pool_bwd_scatter``.
    """
    if not (use_kernel and g.is_cuda):
        return scatter_argmax_grad(argmax, g, h, w)
    b, c = argmax.shape[0], argmax.shape[-1]
    if c % 4:
        raise ValueError(f"roi_pool_bwd kernel takes C a multiple of 4, got {c}")
    _cuda.require(argmax, "argmax", torch.int32)
    _cuda.require(g, "g", torch.float32, argmax.shape)
    r, p = argmax.shape[1], argmax.shape[2]
    plan = bwd_plan("scatter", g.device.index, b, h, w, c, r, 4, p)
    alloc = torch.empty if plan["route"] == "slice" else torch.zeros
    dfeat = alloc((b, h, w, c), dtype=torch.float32, device=g.device)
    _cuda.launch("roi_pool_bwd_scatter_launch", g.device, argmax.data_ptr(),
                 g.data_ptr(), dfeat.data_ptr(), b, argmax[0].numel() // c, c,
                 h * w, plan["nv"], plan["n_slices"],
                 count="launch.roi_pool_bwd_scatter")
    return dfeat
