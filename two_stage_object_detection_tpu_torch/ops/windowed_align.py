"""Batched windowed multi-level RoIAlign with the hand-written kernel.

The counterpart of the JAX package's ``ops/pallas_windowed_align.py``: the
same signature as its ``windowed_roi_align_batched``, launching kernel 2
(``csrc/windowed_align.cu``) on CUDA tensors through the custom op
``tsod::windowed_align`` (:func:`windowed_align_op`), which
``torch.export`` keeps in its graph.  The plain version is
:func:`~..ops.roi_pool.multilevel_roi_align` over the batch; it runs on the
CPU, or on any device with ``use_kernel=False``.

:func:`multilevel_roi_align_hybrid_batched` is the train route (the JAX
function of that name in ``ops/roi_pool.py``): that windowed forward, with
the gradient of the *dense* RoIAlign as its backward
(:func:`~..ops.roi_pool.multilevel_roi_align_dense_grad`, plain matrix
products in both packages).  Rois and levels get no gradient.
"""

from __future__ import annotations

import ctypes

import torch

from two_stage_object_detection_tpu_torch.ops import _cuda
from two_stage_object_detection_tpu_torch.ops.roi_pool import (
    multilevel_roi_align, multilevel_roi_align_dense_grad, scale_pairs)


def windowed_roi_align_batched(pyramid, rois: torch.Tensor,
                               levels: torch.Tensor, scales,
                               output_size: int = 7, sampling_ratio: int = 2,
                               window: int = 32, aligned: bool = False,
                               use_kernel: bool = True) -> torch.Tensor:
    """Kernel 2: windowed multi-level RoIAlign over a batch.

    Args:
      pyramid: per-level ``[B, H_l, W_l, C]`` features, f32 or bf16.
      rois: ``[B, R, 4]`` xyxy in image coordinates, f32.
      levels: ``[B, R]`` int32 index into ``pyramid`` (0 = finest), each in
        ``[0, len(pyramid))`` (the kernel does not check it).
      scales/output_size/sampling_ratio/window/aligned: as
        :func:`~..ops.roi_pool.multilevel_roi_align`.

    Returns ``[B, R, P, P, C]`` in the features' dtype.
    """
    if not (use_kernel and rois.is_cuda):
        return multilevel_roi_align(tuple(pyramid), rois, levels, scales,
                                    output_size, sampling_ratio, window, aligned)
    sc = [v for pair in scale_pairs(scales, len(pyramid)) for v in pair]
    return windowed_align_op(list(pyramid), rois, levels, sc, output_size,
                             sampling_ratio, window, aligned)


@torch.library.custom_op("tsod::windowed_align", mutates_args=(),
                         device_types="cuda")
def windowed_align_op(pyramid: list[torch.Tensor], rois: torch.Tensor,
                      levels: torch.Tensor, scales: list[float],
                      output_size: int, sampling_ratio: int, window: int,
                      aligned: bool) -> torch.Tensor:
    """Kernel 2 as a custom op, so that ``torch.export`` keeps the launch
    in its graph; counted in ``launch.windowed_roi_align_batched``.
    ``scales`` is the flat ``[sy_0, sx_0, sy_1, ...]`` list; the rest as
    :func:`windowed_roi_align_batched`."""
    p, s = output_size, sampling_ratio
    pyramid = [f.contiguous() for f in pyramid]
    rois, levels = rois.contiguous(), levels.contiguous()
    b, r, _ = rois.shape
    c = pyramid[0].shape[-1]
    dt = pyramid[0].dtype
    vec = _cuda.align_vector_width(c, dt)
    for i, f in enumerate(pyramid):
        _cuda.require(f, f"pyramid[{i}]", dt, (b, f.shape[1], f.shape[2], c))
    _cuda.require(rois, "rois", torch.float32, (b, r, 4))
    _cuda.require(levels, "levels", torch.int32, (b, r))
    n = len(pyramid)
    out = torch.empty((b, r, p, p, c), dtype=dt, device=rois.device)
    feats = (ctypes.c_void_p * n)(*[f.data_ptr() for f in pyramid])
    hw = (ctypes.c_int * (2 * n))(*[d for f in pyramid for d in f.shape[1:3]])
    scl = (ctypes.c_float * (2 * n))(*scales)
    _cuda.launch("windowed_align_launch", rois.device, feats, hw, scl, n,
                 rois.data_ptr(), levels.data_ptr(), out.data_ptr(), b, r, c,
                 p, s, window, int(aligned), _cuda.DTYPES[dt], vec,
                 count="launch.windowed_roi_align_batched")
    return out


@windowed_align_op.register_fake
def _(pyramid, rois, levels, scales, output_size, sampling_ratio, window,
      aligned):
    b, r, _ = rois.shape
    c = pyramid[0].shape[-1]
    return pyramid[0].new_empty((b, r, output_size, output_size, c))


class _Hybrid(torch.autograd.Function):
    @staticmethod
    def forward(ctx, rois, levels, scales, output_size, sampling_ratio,
                window, aligned, use_kernel, *pyramid):
        ctx.save_for_backward(rois, levels)
        ctx.shapes = [tuple(f.shape[1:3]) for f in pyramid]
        ctx.args = (pyramid[0].dtype, scales, output_size, sampling_ratio,
                    aligned)
        return windowed_roi_align_batched(
            [f.detach() for f in pyramid], rois, levels, scales, output_size,
            sampling_ratio, window, aligned, use_kernel)

    @staticmethod
    def backward(ctx, g):
        rois, levels = ctx.saved_tensors
        dtype, scales, output_size, sampling_ratio, aligned = ctx.args
        d_pyr = multilevel_roi_align_dense_grad(
            ctx.shapes, dtype, rois, levels, scales, g, output_size,
            sampling_ratio, aligned)
        return (None,) * 8 + tuple(d_pyr)


def multilevel_roi_align_hybrid_batched(pyramid, rois: torch.Tensor,
                                        levels: torch.Tensor, scales,
                                        output_size: int = 7,
                                        sampling_ratio: int = 2,
                                        window: int = 32,
                                        aligned: bool = False,
                                        use_kernel: bool = True) -> torch.Tensor:
    """Windowed forward (kernel 2 on CUDA tensors), dense matrix-product
    backward, whole batch at once.  Arguments and result as
    :func:`windowed_roi_align_batched`; differentiable in ``pyramid``."""
    return _Hybrid.apply(rois, levels, scales, output_size, sampling_ratio,
                         window, aligned, use_kernel, *pyramid)
