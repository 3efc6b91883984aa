"""RoIPool max with the hand-written kernel (kernel 5) and its backward.

The counterpart of the JAX package's ``ops/pallas_roi.py``
(``roi_pool_pallas``): RoIPool max with torchvision integer bins over a
batch, plus the flat index ``y*W + x`` of the first maximum of each bin in
row-major order (-1, value 0, for an empty bin).  On CUDA tensors it
launches ``csrc/roi_pool.cu`` on one of two routes, chosen by shape alone
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
(:func:`roi_pool_bwd_scatter`, a second hand-written kernel, in
``csrc/roi_pool_bwd.cu``; plain version
:func:`~..ops.roi_pool.scatter_argmax_grad`).  The additions are atomic, so
that gradient equals the plain version's up to f32 summation order.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from two_stage_object_detection_tpu_torch.ops import _cuda
from two_stage_object_detection_tpu_torch.ops.roi_pool import (
    roi_pool_argmax, scatter_argmax_grad)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

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


def _forward(feats: torch.Tensor, rois: torch.Tensor, output_size: int,
             spatial_scale: float, use_kernel: bool, with_argmax: bool):
    """Kernel 5 or its plain version, outside autograd: ``(pooled, argmax or
    None)``."""
    if not (use_kernel and rois.is_cuda):
        pooled, argmax = roi_pool_argmax(feats, rois, output_size,
                                         spatial_scale)
        return pooled, (argmax if with_argmax else None)
    b, h, w, c = feats.shape
    r, p = rois.shape[1], output_size
    if feats.dtype not in _DTYPES:
        raise ValueError(f"roi_pool kernel takes f32 or bf16, got {feats.dtype}")
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
    fn = _pool_fn()
    with torch.cuda.device(rois.device):
        status = fn(feats.data_ptr(), rois.data_ptr(), pooled.data_ptr(),
                    None if argmax is None else argmax.data_ptr(), b, h, w, c,
                    r, p, spatial_scale, _DTYPES[feats.dtype],
                    plan["vec_bytes"], plan["nv"], plan["n_slices"],
                    plan["n_chunks"], _cuda.stream_handle(rois))
    _cuda.check(status, "roi_pool_launch")
    roi_pool_max.launches += 1
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


roi_pool_max.launches = 0


@functools.lru_cache(maxsize=None)
def _plan(device_index, b, h, w, c, r, elem_bytes, pooled):
    n_sm = torch.cuda.get_device_properties(device_index).multi_processor_count
    return roi_pool_plan(b, h, w, c, r, elem_bytes, n_sm, pooled)


def _pool_fn():
    fn = _cuda.library("roi_pool").roi_pool_launch
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                   + [ctypes.c_float] + [ctypes.c_int] * 5
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def roi_pool_bwd_scatter(argmax: torch.Tensor, g: torch.Tensor, h: int,
                         w: int, use_kernel: bool = True) -> torch.Tensor:
    """Kernel 5's backward: add ``g`` at each bin's argmax.

    ``argmax [B, R, P, P, C]`` int32 (-1: empty bin, dropped), ``g`` of the
    same shape, f32 -> ``dfeat [B, H, W, C]`` f32.  On CUDA tensors with
    ``use_kernel`` it launches ``csrc/roi_pool_bwd.cu`` (atomic adds: equal
    to the plain version up to f32 summation order); otherwise it runs
    :func:`~..ops.roi_pool.scatter_argmax_grad`.
    """
    if not (use_kernel and g.is_cuda):
        return scatter_argmax_grad(argmax, g, h, w)
    b, c = argmax.shape[0], argmax.shape[-1]
    if c % 4:
        raise ValueError(f"roi_pool_bwd kernel takes C a multiple of 4, got {c}")
    _cuda.require(argmax, "argmax", torch.int32)
    _cuda.require(g, "g", torch.float32, argmax.shape)
    dfeat = torch.zeros((b, h, w, c), dtype=torch.float32, device=g.device)
    fn = _cuda.library("roi_pool_bwd").roi_pool_bwd_scatter_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(g.device):
        status = fn(argmax.data_ptr(), g.data_ptr(), dfeat.data_ptr(), b,
                    argmax[0].numel() // c, c, h * w, _cuda.stream_handle(g))
    _cuda.check(status, "roi_pool_bwd_scatter_launch")
    roi_pool_bwd_scatter.launches += 1
    return dfeat


roi_pool_bwd_scatter.launches = 0
