"""Int8 post-training quantization of the dense convolutions for inference.

The port's copy of the JAX package's ``quantize.py``, with its semantics:
symmetric scales, round half to even, int8 operands, int32 accumulation and
a float32 requant::

    s_w[o] = max|W[o, ...]| / 127          # per output channel, from the weights
    s_x    = calibrated max|x| / 127       # per conv instance
    y      = conv(q(x, s_x), q(W, s_w)) (int32) * (s_w * s_x) + bias

Only :class:`~.models.layers.Conv` layers with ``groups == 1`` are
quantized, as the JAX package quantizes only ``feature_group_count == 1``.
A conv is keyed by its module path joined with ``/``; the port's modules
carry the flax names (``utils/jax_weights.py``), so a scales dict from
either package serves the other.

* :func:`calibrate` records each eligible conv's input absmax over some
  batches (forward pre-hooks on the port's modules, in place of flax's
  method interception).
* :func:`quantized` is a context manager: inside it, every eligible conv
  listed with a positive absmax computes :func:`int8_conv`.  It replaces
  those layers' ``forward`` on the instances and restores them on exit, so
  a model is quantized only for the calls made inside.
* The int32 accumulation (:func:`conv_int32`) runs, on a CUDA tensor, as
  an im2col of the int8 input and one ``torch._int_mm`` product (cuBLASLt's
  int8 GEMM): the JAX package computes this conv with XLA's
  ``lax.conv_general_dilated``, not in a Pallas kernel.  Its plain version,
  :func:`conv_int32_reference`, is a float64 convolution of the int8
  values, exact while every sum stays below 2^53, and runs on the CPU.

Weights stay float: the per-channel scales and the int8 weights are derived
at each call, as the JAX package derives them in its traced graph.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Dict, Iterable, Mapping

import torch
import torch.nn as nn
import torch.nn.functional as F

from two_stage_object_detection_tpu_torch.models.layers import Conv
from two_stage_object_detection_tpu_torch.models.registry import check_route
from two_stage_object_detection_tpu_torch.parallel import spatial
from two_stage_object_detection_tpu_torch.ops.geometry import div_exact

__all__ = ["calibrate", "quantized", "filter_scales", "int8_conv",
           "conv_int32", "conv_int32_reference"]


def eligible_convs(model: nn.Module) -> Dict[str, Conv]:
    """The dense convs of ``model`` by flax path (``a/b/c``)."""
    return {name.replace(".", "/"): m for name, m in model.named_modules()
            if isinstance(m, Conv) and m.groups == 1}


def quantize_weight(weight: torch.Tensor):
    """``(w_q int8 [O, I, kh, kw], s_w f32 [O])`` of a float OIHW weight."""
    w = weight.to(torch.float32)
    s_w = torch.clamp(div_exact(w.abs().amax(dim=(1, 2, 3)), 127.0), min=1e-12)
    w_q = torch.round(w / s_w[:, None, None, None]).to(torch.int8)
    return w_q, s_w


def quantize_input(x: torch.Tensor, s_x: float) -> torch.Tensor:
    """``round(clip(x / s_x, -127, 127))`` as int8."""
    q = torch.clamp(div_exact(x.to(torch.float32), s_x), -127.0, 127.0)
    return torch.round(q).to(torch.int8)


def conv_int32_reference(x_q: torch.Tensor, w_q: torch.Tensor, stride: int,
                         padding) -> torch.Tensor:
    """Plain version of :func:`conv_int32`: a float64 convolution of the
    int8 values, exact below 2^53; ``[N, C, H, W]`` int8 and ``[O, C, kh,
    kw]`` int8 -> ``[N, O, OH, OW]`` int32.  ``padding``: one size, or
    ``(rows, columns)``."""
    acc = F.conv2d(x_q.to(torch.float64), w_q.to(torch.float64), None,
                   stride, padding)
    return acc.to(torch.int32)


def _pad_to(t: torch.Tensor, dim: int, multiple: int, least: int = 0):
    n = t.shape[dim]
    want = max(-(-n // multiple) * multiple, least)
    if want == n:
        return t
    pad = [0, 0] * (t.dim() - 1 - dim) + [0, want - n]
    return F.pad(t, pad)


def conv_int32(x_q: torch.Tensor, w_q: torch.Tensor, stride: int,
               padding) -> torch.Tensor:
    """Int8 x int8 -> int32 convolution, NCHW.

    On a CUDA tensor: im2col of the padded int8 input (``Tensor.unfold``
    views, one copy into ``[N*OH*OW, C*kh*kw]``) and ``torch._int_mm``
    against the ``[C*kh*kw, O]`` weights.  ``_int_mm`` takes ``M > 16`` and
    ``K`` and ``N`` multiples of 8, so the rows, the depth and the output
    channels are padded with zeros and cut back.  The result is
    channels-last in memory, as the port's maps are on the card.  On the CPU
    it is :func:`conv_int32_reference`; either way the same integers.
    """
    if not x_q.is_cuda:
        return conv_int32_reference(x_q, w_q, stride, padding)
    n, c, _, _ = x_q.shape
    o, _, kh, kw = w_q.shape
    ph, pw = (padding, padding) if isinstance(padding, int) else padding
    xp = F.pad(x_q, (pw, pw, ph, ph)) if ph or pw else x_q
    cols = xp.unfold(2, kh, stride).unfold(3, kw, stride)  # [N,C,OH,OW,kh,kw]
    oh, ow = cols.shape[2:4]
    a = cols.permute(0, 2, 3, 1, 4, 5).reshape(n * oh * ow, c * kh * kw)
    b = w_q.reshape(o, c * kh * kw)
    a = _pad_to(_pad_to(a, 1, 8), 0, 1, least=17)
    b = _pad_to(_pad_to(b, 1, 8), 0, 8)
    acc = torch._int_mm(a, b.t())                         # [M, O] int32
    acc = acc[:n * oh * ow, :o].reshape(n, oh, ow, o).permute(0, 3, 1, 2)
    return acc.contiguous(memory_format=torch.channels_last)


def int8_conv(conv: Conv, x: torch.Tensor, s_x: float) -> torch.Tensor:
    """The quantized forward of ``conv`` on ``x``: int8 operands, int32
    accumulation, ``acc * (s_w * s_x) + bias`` in float32, cast to the
    conv's compute dtype (the JAX ``_quantized_conv``).  On a row shard
    (``parallel/spatial.py``) it runs on the shard's rows and halo, as the
    float conv does."""
    w_q, s_w = quantize_weight(conv.weight)
    shard = spatial.current()
    if shard is not None:
        acc = shard.conv(x, w_q.shape[2], conv.stride, conv.padding,
                         lambda slab: conv_int32(
                             quantize_input(slab, s_x), w_q, conv.stride,
                             (0, conv.padding)))
    else:
        acc = conv_int32(quantize_input(x, s_x), w_q, conv.stride,
                         conv.padding)
    y = acc.to(torch.float32) * (s_w * s_x)[:, None, None]
    if conv.bias is not None:
        y = y + conv.bias.to(torch.float32)[:, None, None]
    return y.to(conv.compute_dtype)


def _check_trunk(model: nn.Module) -> None:
    cfg = getattr(model, "cfg", None)
    if cfg is not None:
        check_route(cfg.backbone, "int8")


@torch.no_grad()
def calibrate(model: nn.Module, batches: Iterable,
              method: str = "predict") -> Dict[str, float]:
    """Record each eligible conv's input absmax over ``batches``.

    Every batch goes through ``getattr(model, method)``; a forward
    pre-hook on each eligible conv keeps the running maximum on the device,
    read back once at the end.  Returns ``{conv_path: absmax}`` for
    :func:`quantized`; a Swin trunk, which has no int8 route, raises.
    """
    _check_trunk(model)
    records: Dict[str, torch.Tensor] = {}

    def hook(path):
        def record(_, args):
            amax = args[0].detach().abs().amax().to(torch.float32)
            prev = records.get(path)
            records[path] = amax if prev is None else torch.maximum(prev, amax)
        return record

    handles = [m.register_forward_pre_hook(hook(path))
               for path, m in eligible_convs(model).items()]
    try:
        for batch in batches:
            getattr(model, method)(batch)
    finally:
        for h in handles:
            h.remove()
    return {path: float(v) for path, v in records.items()}


def filter_scales(scales: Mapping[str, float],
                  prefix: str = "extractor") -> Dict[str, float]:
    """Restrict quantization to a module subtree (e.g. the backbone)."""
    return {k: v for k, v in scales.items() if k.startswith(prefix)}


@contextlib.contextmanager
def quantized(model: nn.Module, scales: Mapping[str, float]):
    """Inside, the eligible convs of ``model`` listed in ``scales`` with a
    positive absmax compute :func:`int8_conv` with ``s_x = absmax / 127``.
    Their ``forward`` is replaced on the instance and restored on exit; a
    model must not be used from another thread while it is quantized.
    A Mask R-CNN (a model with a ``mask_head``) and a Swin trunk have no
    int8 route."""
    if getattr(model, "mask_head", None) is not None:
        raise ValueError("mask_head=True has no int8 route")
    _check_trunk(model)
    swapped = []
    for path, m in eligible_convs(model).items():
        amax = float(scales.get(path, 0.0))
        if amax > 0.0:
            m.forward = functools.partial(int8_conv, m, s_x=amax / 127.0)
            swapped.append(m)
    try:
        yield model
    finally:
        for m in swapped:
            del m.forward
