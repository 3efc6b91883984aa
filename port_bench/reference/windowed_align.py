"""Batched windowed multi-level RoIAlign, plain PyTorch.

Frozen from the port's ``ops/windowed_align.py`` with the kernel launch
taken out: the plain version of kernel 2 is
:func:`~.roi_pool.multilevel_roi_align` over the batch, and the train
route (:func:`multilevel_roi_align_hybrid_batched`) is that forward with
the gradient of the *dense* RoIAlign
(:func:`~.roi_pool.multilevel_roi_align_dense_grad`) as its backward.
Rois and levels get no gradient.
"""

from __future__ import annotations

import torch

from .roi_pool import multilevel_roi_align, multilevel_roi_align_dense_grad


def windowed_roi_align_batched(pyramid, rois: torch.Tensor,
                               levels: torch.Tensor, scales,
                               output_size: int = 7, sampling_ratio: int = 2,
                               window: int = 32, aligned: bool = False
                               ) -> torch.Tensor:
    """Windowed multi-level RoIAlign over a batch: per-level ``[B, H_l,
    W_l, C]`` features, ``rois [B, R, 4]`` image coordinates, ``levels [B,
    R]`` int32 into ``pyramid`` -> ``[B, R, P, P, C]`` in the features'
    dtype."""
    return multilevel_roi_align(tuple(pyramid), rois, levels, scales,
                                output_size, sampling_ratio, window, aligned)


class _Hybrid(torch.autograd.Function):
    @staticmethod
    def forward(ctx, rois, levels, scales, output_size, sampling_ratio,
                window, aligned, *pyramid):
        ctx.save_for_backward(rois, levels)
        ctx.shapes = [tuple(f.shape[1:3]) for f in pyramid]
        ctx.args = (pyramid[0].dtype, scales, output_size, sampling_ratio,
                    aligned)
        return windowed_roi_align_batched(
            [f.detach() for f in pyramid], rois, levels, scales, output_size,
            sampling_ratio, window, aligned)

    @staticmethod
    def backward(ctx, g):
        rois, levels = ctx.saved_tensors
        dtype, scales, output_size, sampling_ratio, aligned = ctx.args
        d_pyr = multilevel_roi_align_dense_grad(
            ctx.shapes, dtype, rois, levels, scales, g, output_size,
            sampling_ratio, aligned)
        return (None,) * 7 + tuple(d_pyr)


def multilevel_roi_align_hybrid_batched(pyramid, rois: torch.Tensor,
                                        levels: torch.Tensor, scales,
                                        output_size: int = 7,
                                        sampling_ratio: int = 2,
                                        window: int = 32,
                                        aligned: bool = False) -> torch.Tensor:
    """Windowed forward, dense matrix-product backward, whole batch at
    once; differentiable in ``pyramid``."""
    return _Hybrid.apply(rois, levels, scales, output_size, sampling_ratio,
                         window, aligned, *pyramid)
