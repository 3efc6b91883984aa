"""Box geometry primitives on torch tensors.

A copy of the JAX package's ``ops/geometry.py``: the same formulas in the
same operation order, broadcasting over leading batch axes.  All boxes are
``(x1, y1, x2, y2)`` in pixel coordinates.
"""

from __future__ import annotations

import torch
from torch._subclasses.fake_tensor import FakeTensor

EPS = 1e-8


def div_exact(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x / c`` rounded as an IEEE division on every device.

    PyTorch's CUDA kernels turn a division by a Python scalar into a
    multiplication by its reciprocal, which can be one ulp off (and can
    move a ``floor`` across an integer); dividing by a 0-dim device tensor
    divides, as the CPU and the JAX package do.
    """
    return x / torch.full((), c, dtype=x.dtype, device=x.device)


_CONSTANTS: dict = {}


def device_constant(values, dtype: torch.dtype, device) -> torch.Tensor:
    """``torch.tensor(values, dtype, device)``, made once per ``(values,
    dtype, device)`` and then reused.  A tensor made from host values on a
    CUDA device is a copy that waits for the device's queue; inside a train
    or predict step that would hold the host back at every call.

    The tensor is shared by every caller and is read-only: modifying it in
    place would change every later use.  The key holds the device's index
    (``"cuda"`` is the current device), so each card has its own.  The
    cache grows with the distinct constants of the configurations a process
    runs, a few small tensors each.  The constant is made outside inference
    mode, so autograd can use it too.  Under ``torch.export`` tracing a new
    constant is a fake tensor: it is returned and never cached, so a trace
    leaves nothing behind that a later eager call would read."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    key = (tuple(float(v) for v in values), dtype, device)
    hit = _CONSTANTS.get(key)
    if hit is None:
        with torch.inference_mode(False):
            hit = torch.tensor(key[0], dtype=dtype, device=device)
        if not isinstance(hit, FakeTensor):
            _CONSTANTS[key] = hit
    return hit


def box_area(boxes: torch.Tensor) -> torch.Tensor:
    """Area of ``[..., 4]`` xyxy boxes -> ``[...]``."""
    wh = boxes[..., 2:4] - boxes[..., 0:2]
    return wh[..., 0] * wh[..., 1]


def bbox_iou(bbox_a: torch.Tensor, bbox_b: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU ``[..., n_a, n_b]`` of ``[..., n_a, 4]`` and ``[..., n_b, 4]``."""
    tl = torch.maximum(bbox_a[..., :, None, :2], bbox_b[..., None, :, :2])
    br = torch.minimum(bbox_a[..., :, None, 2:4], bbox_b[..., None, :, 2:4])
    wh = torch.clamp(br - tl, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = box_area(bbox_a)[..., :, None] + box_area(bbox_b)[..., None, :] - inter
    return inter / (union + EPS)


def loc2bbox(src_bbox: torch.Tensor, loc: torch.Tensor) -> torch.Tensor:
    """Decode ``(dx, dy, dw, dh)`` deltas onto source boxes.

    ``src_bbox [..., N, 4]``, ``loc [..., N, 4*C]`` in the strided per-class
    layout (each group of 4 along the last axis is one class's deltas) ->
    ``[..., N, 4*C]`` xyxy boxes.  Leading axes broadcast.
    """
    src_w = src_bbox[..., 2:3] - src_bbox[..., 0:1]
    src_h = src_bbox[..., 3:4] - src_bbox[..., 1:2]
    src_cx = src_bbox[..., 0:1] + 0.5 * src_w
    src_cy = src_bbox[..., 1:2] + 0.5 * src_h

    shape = loc.shape
    loc4 = loc.reshape(*shape[:-1], -1, 4)                 # [..., N, C, 4]
    dx, dy, dw, dh = loc4.unbind(-1)

    cx = dx * src_w + src_cx
    cy = dy * src_h + src_cy
    w = torch.exp(dw) * src_w
    h = torch.exp(dh) * src_h

    out = torch.stack([cx - 0.5 * w, cy - 0.5 * h, cx + 0.5 * w, cy + 0.5 * h],
                      dim=-1)                               # [..., N, C, 4]
    return out.reshape(*out.shape[:-2], -1)


def bbox2loc(src_bbox: torch.Tensor, dst_bbox: torch.Tensor) -> torch.Tensor:
    """Encode the offsets from ``src_bbox`` to ``dst_bbox`` (both ``[..., N, 4]``)."""
    w = src_bbox[..., 2] - src_bbox[..., 0]
    h = src_bbox[..., 3] - src_bbox[..., 1]
    cx = src_bbox[..., 0] + 0.5 * w
    cy = src_bbox[..., 1] + 0.5 * h

    bw = dst_bbox[..., 2] - dst_bbox[..., 0]
    bh = dst_bbox[..., 3] - dst_bbox[..., 1]
    bcx = dst_bbox[..., 0] + 0.5 * bw
    bcy = dst_bbox[..., 1] + 0.5 * bh

    eps = torch.finfo(src_bbox.dtype).eps
    w = torch.clamp(w, min=eps)
    h = torch.clamp(h, min=eps)

    dx = (bcx - cx) / w
    dy = (bcy - cy) / h
    # guard the log against non-positive padded boxes (padded GT rows are zeros)
    dw = torch.log(torch.clamp(bw, min=eps) / w)
    dh = torch.log(torch.clamp(bh, min=eps) / h)
    return torch.stack([dx, dy, dw, dh], dim=-1)


def clip_boxes(boxes: torch.Tensor, img_size) -> torch.Tensor:
    """Clamp xyxy boxes (any ``[..., 4*C]`` layout) into ``(H, W)`` bounds."""
    h, w = img_size
    out = torch.empty_like(boxes)
    out[..., 0::2] = torch.clamp(boxes[..., 0::2], 0.0, float(w))
    out[..., 1::2] = torch.clamp(boxes[..., 1::2], 0.0, float(h))
    return out


def xywh2xyxy(box):
    """``(x, y, w, h) -> (x1, y1, x2, y2)`` for a python list or a ``[..., 4]`` tensor."""
    if isinstance(box, list):
        return [box[0], box[1], box[0] + box[2], box[1] + box[3]]
    box = torch.as_tensor(box)
    return torch.cat([box[..., :2], box[..., :2] + box[..., 2:4]], dim=-1)
