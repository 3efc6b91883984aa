"""RoIPool max forward with the hand-written kernel (kernel 5).

The counterpart of the JAX package's ``ops/pallas_roi.py``
(``_roi_pool_fwd_impl``): RoIPool max with torchvision integer bins over a
batch, plus the flat index ``y*W + x`` of the first maximum of each bin in
row-major order (-1, value 0, for an empty bin).  On CUDA tensors it
launches ``csrc/roi_pool.cu``; its plain version is
:func:`~..ops.roi_pool.roi_pool_argmax`, which runs on the CPU, or on any
device with ``use_kernel=False``.  Same outputs either way, bit for bit:
max is exact in any float format.

The backward (a scatter-add of the pooled cotangent to the argmax) belongs
to the training slice (ROADMAP.md).
"""

from __future__ import annotations

import ctypes

import torch

from two_stage_object_detection_tpu_torch.ops import _cuda
from two_stage_object_detection_tpu_torch.ops.roi_pool import roi_pool_argmax

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def roi_pool_max(feats: torch.Tensor, rois: torch.Tensor, output_size: int = 7,
                 spatial_scale: float = 1.0, use_kernel: bool = True):
    """Kernel 5: RoIPool max with argmax over a batch.

    Args:
      feats: ``[B, H, W, C]`` map, f32 or bf16 (pooled in f32); the kernel
        reads 4 channels a thread and takes C a multiple of 4.
      rois: ``[B, R, 4]`` xyxy f32, multiplied by ``spatial_scale`` to reach
        map coordinates.

    Returns ``(pooled [B, R, P, P, C] f32, argmax [B, R, P, P, C] int32)``.
    """
    if not (use_kernel and rois.is_cuda):
        return roi_pool_argmax(feats, rois, output_size, spatial_scale)
    b, h, w, c = feats.shape
    r, p = rois.shape[1], output_size
    if feats.dtype not in _DTYPES:
        raise ValueError(f"roi_pool kernel takes f32 or bf16, got {feats.dtype}")
    if c % 4:
        raise ValueError(f"roi_pool kernel takes C a multiple of 4, got {c}")
    _cuda.require(feats, "feats", feats.dtype, (b, h, w, c))
    _cuda.require(rois, "rois", torch.float32, (b, r, 4))
    pooled = torch.empty((b, r, p, p, c), dtype=torch.float32, device=rois.device)
    argmax = torch.empty((b, r, p, p, c), dtype=torch.int32, device=rois.device)
    fn = _pool_fn()
    with torch.cuda.device(rois.device):
        status = fn(feats.data_ptr(), rois.data_ptr(), pooled.data_ptr(),
                    argmax.data_ptr(), b, h, w, c, r, p, spatial_scale,
                    _DTYPES[feats.dtype], _cuda.stream_handle(rois))
    _cuda.check(status, "roi_pool_launch")
    roi_pool_max.launches += 1
    return pooled, argmax


roi_pool_max.launches = 0


def _pool_fn():
    fn = _cuda.library("roi_pool").roi_pool_launch
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn
