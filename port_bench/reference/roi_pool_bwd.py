"""The differentiable RoIPool max of the single-scale train routes, plain
PyTorch.

Frozen from the port's ``ops/roi_pool_bwd.py`` with kernels 5 and 6 taken
out: the forward is the plain RoIPool max
(:func:`~.roi_pool.roi_pool_argmax`; max is exact, so every route gives
the same values), and the backward is recomputed from the map under the
rule ``mode``:

* ``"xla"``: ties share the cotangent evenly at each of the two max
  stages (autodiff of the JAX ``roi_pool``);
* ``"structured"``: the same shares from explicit tie counts;
* ``"pallas"``: all of it to the first row-major maximum.
"""

from __future__ import annotations

import torch

from .roi_pool import (
    roi_pool_argmax, roi_pool_grad_first_argmax, roi_pool_grad_structured,
    roi_pool_grad_xla)

BWD_MODES = ("xla", "structured", "pallas")


class _RoIPoolRecompute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, feats, rois, output_size, spatial_scale, mode):
        ctx.save_for_backward(feats, rois)
        ctx.args = (output_size, spatial_scale, mode)
        return roi_pool_argmax(feats.detach(), rois, output_size,
                               spatial_scale)[0]

    @staticmethod
    def backward(ctx, g):
        feats, rois = ctx.saved_tensors
        output_size, spatial_scale, mode = ctx.args
        grad = {"pallas": roi_pool_grad_first_argmax,
                "structured": roi_pool_grad_structured,
                "xla": roi_pool_grad_xla}[mode]
        return (grad(feats, rois, g, output_size, spatial_scale),
                None, None, None, None)


def roi_pool_recompute(feats: torch.Tensor, rois: torch.Tensor,
                       output_size: int = 7, spatial_scale: float = 1.0,
                       mode: str = "xla"):
    """Batched RoIPool max ``([B, H, W, C], [B, R, 4]) -> [B, R, P, P, C]``
    f32 whose backward recomputes from the map under the rule ``mode``."""
    if mode not in BWD_MODES:
        raise ValueError(f"roi_bwd must be one of {BWD_MODES}, got {mode!r}")
    return _RoIPoolRecompute.apply(feats, rois, output_size, spatial_scale,
                                   mode)
