"""RoIPool max backward by recomputation, with the hand-written kernel
(kernel 6), and the differentiable RoIPool max of the train routes.

The counterpart of the JAX package's ``ops/pallas_roi_bwd.py``:
:func:`roi_pool_bwd_recompute` maps ``(feat, rois, g)`` to ``dfeat``,
crediting each bin's pooled cotangent to the bin's first maximum in
row-major order, which it finds again from the map.  Unlike kernel 5's own
backward it reads no saved argmax, so nothing of size ``[B, R, P, P, C]``
lives between the forward and the backward pass.  On CUDA tensors it
launches ``csrc/roi_pool_bwd.cu`` on the route of
:func:`~..ops.roi_pool_max.roi_pool_bwd_plan`: **slice** (the RoI head's
38x38 map), a block per (channel slice, image) holds the map's slice and
its f32 gradient in shared memory, walks every roi of the image and writes
the slice once in the map's dtype; **direct** (maps too large for that), a
block per (roi, image) adds into a zeroed f32 map with global atomics.  Its
plain version is :func:`~..ops.roi_pool.roi_pool_grad_first_argmax`.  The
kernel's additions collide in no fixed order, so the two agree up to f32
summation order (about 1e-5 relative), not bit for bit.

:func:`roi_pool_fast` is the JAX function of that name: RoIPool max whose
backward is kernel 6.  :func:`roi_pool_recompute` is the same forward with
the backward rule chosen by name: the other two rules
(``Config.roi_bwd`` ``"xla"`` and ``"structured"``) are plain PyTorch, as
they are plain XLA in the JAX package.  The forward values come from
kernel 5 without its index store on CUDA tensors, from the plain version
otherwise; max is exact, so every route gives the same values.
"""

from __future__ import annotations

import torch

from two_stage_object_detection_tpu_torch.ops import _cuda
from two_stage_object_detection_tpu_torch.ops.roi_pool import (
    roi_pool_grad_first_argmax, roi_pool_grad_structured, roi_pool_grad_xla)
from two_stage_object_detection_tpu_torch.ops.roi_pool_max import (
    bwd_plan, roi_pool_max)

BWD_MODES = ("xla", "structured", "pallas")


def roi_pool_bwd_recompute(feats: torch.Tensor, rois: torch.Tensor,
                           g: torch.Tensor, output_size: int = 7,
                           spatial_scale: float = 1.0,
                           use_kernel: bool = True) -> torch.Tensor:
    """Kernel 6: RoIPool max backward, first row-major argmax recomputed.

    Args:
      feats: ``[B, H, W, C]`` map, f32 or bf16, C a multiple of 4.
      rois: ``[B, R, 4]`` xyxy f32 (times ``spatial_scale``: map coordinates).
      g: ``[B, R, P, P, C]`` f32 cotangent of the pooled values.

    Returns ``dfeat [B, H, W, C]`` in the map's dtype, accumulated in f32.
    Each launch is counted in ``launch.roi_pool_bwd_recompute``.
    """
    if not (use_kernel and g.is_cuda):
        return roi_pool_grad_first_argmax(feats, rois, g, output_size,
                                          spatial_scale)
    b, h, w, c = feats.shape
    r, p = rois.shape[1], output_size
    code = _cuda.dtype_code(feats.dtype, "roi_pool_bwd")
    if c % 4:
        raise ValueError(f"roi_pool_bwd kernel takes C a multiple of 4, got {c}")
    _cuda.require(feats, "feats", feats.dtype, (b, h, w, c))
    _cuda.require(rois, "rois", torch.float32, (b, r, 4))
    _cuda.require(g, "g", torch.float32, (b, r, p, p, c))
    plan = bwd_plan("recompute", g.device.index, b, h, w, c, r,
                    feats.element_size(), p)
    slice_route = plan["route"] == "slice"
    dfeat = (torch.empty((b, h, w, c), dtype=feats.dtype, device=g.device)
             if slice_route else
             torch.zeros((b, h, w, c), dtype=torch.float32, device=g.device))
    _cuda.launch("roi_pool_bwd_recompute_launch", g.device, feats.data_ptr(),
                 rois.data_ptr(), g.data_ptr(), dfeat.data_ptr(), b, h, w, c,
                 r, p, spatial_scale, code, plan["vec_bytes"], plan["nv"],
                 plan["n_slices"], plan["rois_per_pass"],
                 count="launch.roi_pool_bwd_recompute")
    return dfeat if slice_route else dfeat.to(feats.dtype)


class _RoIPoolRecompute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, feats, rois, output_size, spatial_scale, mode, use_kernel):
        ctx.save_for_backward(feats, rois)
        ctx.args = (output_size, spatial_scale, mode, use_kernel)
        return roi_pool_max(feats.detach(), rois, output_size, spatial_scale,
                            use_kernel, with_argmax=False)[0]

    @staticmethod
    def backward(ctx, g):
        feats, rois = ctx.saved_tensors
        output_size, spatial_scale, mode, use_kernel = ctx.args
        if mode == "pallas":
            dfeat = roi_pool_bwd_recompute(feats, rois, g.contiguous(),
                                           output_size, spatial_scale,
                                           use_kernel)
        elif mode == "structured":
            dfeat = roi_pool_grad_structured(feats, rois, g, output_size,
                                             spatial_scale)
        else:
            dfeat = roi_pool_grad_xla(feats, rois, g, output_size,
                                      spatial_scale)
        return dfeat, None, None, None, None, None


def roi_pool_recompute(feats: torch.Tensor, rois: torch.Tensor,
                       output_size: int = 7, spatial_scale: float = 1.0,
                       mode: str = "xla", use_kernel: bool = True):
    """Batched RoIPool max ``([B, H, W, C], [B, R, 4]) -> [B, R, P, P, C]``
    f32 whose backward recomputes from the map under the rule ``mode``:

    * ``"xla"``: ties share the cotangent evenly at each of the two max
      stages (autodiff of the JAX ``roi_pool``);
    * ``"structured"``: the same shares from explicit tie counts;
    * ``"pallas"``: all of it to the first row-major maximum, by kernel 6.
    """
    if mode not in BWD_MODES:
        raise ValueError(f"roi_bwd must be one of {BWD_MODES}, got {mode!r}")
    return _RoIPoolRecompute.apply(feats, rois, output_size, spatial_scale,
                                   mode, use_kernel)


def roi_pool_fast(feats: torch.Tensor, rois: torch.Tensor,
                  output_size: int = 7, spatial_scale: float = 1.0,
                  use_kernel: bool = True):
    """Batched RoIPool max whose backward is kernel 6."""
    return roi_pool_recompute(feats, rois, output_size, spatial_scale,
                              "pallas", use_kernel)
