"""The depth-wise 3x3 conv of HarDNet's folded predict route, stored into
every buffer that reads its output.

A harmonic dense block concatenates its layers' outputs into the inputs of
its later layers and into its own output (``models/hardnet.py:HarDBlock``).
Every part of those concatenations is the output of a depth-wise 3x3 conv,
so on the store route the conv writes each output pixel straight into the
channel slice of each buffer that reads it, in place of a conv into a
tensor of its own and a ``torch.cat`` a buffer.  :func:`depthwise_store`
runs it on CUDA tensors as the hand-written kernel
``csrc/depthwise_store.cu``, and on the CPU as its plain version,
:func:`depthwise_store_reference`: the conv in float32
(:func:`depthwise_conv_reference`), rounded once, then slice copies.  The
two agree bit for bit: both take the nine products in the same order, each
rounded, with no fused multiply-add.  It is no custom op: only the eager
folded route calls it.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from two_stage_object_detection_tpu_torch.ops import _cuda

#: the destinations one launch stores to, at most
MAX_DESTS = 8

Dest = Tuple[torch.Tensor, int]


def out_size(h: int, w: int, stride: int) -> Tuple[int, int]:
    """The output rows and columns of a 3x3 window of ``stride`` and padding
    1 on an ``h x w`` map."""
    return (h - 1) // stride + 1, (w - 1) // stride + 1


def store_vector_width(c: int, dtype: torch.dtype,
                       dests: Sequence[Dest]) -> int:
    """Channels the kernel may store at once: the widest vector of 16, 8, 4
    or 2 bytes (one element at least) that divides ``c`` and every
    destination's offset and width, so that every pixel's slice of every
    buffer starts on a vector (bf16: 8 where all are multiples of 8; 2 at
    HarDNet's 26, 82, 102, 410 or at an offset such as 42)."""
    size = dtype.itemsize
    held = c
    for buf, off in dests:
        held |= off | buf.shape[1]
    return min(16, (held * size) & -(held * size)) // size


def depthwise_conv_reference(x: torch.Tensor, weight: torch.Tensor,
                             stride: int,
                             bias: Optional[torch.Tensor] = None
                             ) -> torch.Tensor:
    """Float32 ``[N, C, Ho, Wo]``: the depth-wise 3x3 conv of ``x [N, C, H,
    W]`` with ``weight [C, 1, 3, 3]``, padding 1, in float32: the nine taps
    in row-major order, each product rounded and added to the sum of the
    ones before it, then ``bias [C]`` (float32) where given."""
    c = x.shape[1]
    ho, wo = out_size(x.shape[2], x.shape[3], stride)
    xp = F.pad(x.to(torch.float32), (1, 1, 1, 1))
    wf = weight.to(torch.float32).reshape(c, 9)
    acc = None
    for tap in range(9):
        ky, kx = divmod(tap, 3)
        tap_rows = xp[:, :, ky:ky + (ho - 1) * stride + 1:stride,
                      kx:kx + (wo - 1) * stride + 1:stride]
        part = tap_rows * wf[:, tap, None, None]
        acc = part if acc is None else acc + part
    if bias is not None:
        acc = acc + bias.to(torch.float32)[:, None, None]
    return acc


def depthwise_store_reference(x: torch.Tensor, weight: torch.Tensor,
                              stride: int, bias: Optional[torch.Tensor],
                              dests: Sequence[Dest]) -> None:
    """Plain version: :func:`depthwise_conv_reference` rounded once to
    ``x``'s dtype, copied into channels ``[offset, offset + C)`` of each
    ``(buffer [N, Cb, Ho, Wo], offset)`` of ``dests``."""
    y = depthwise_conv_reference(x, weight, stride, bias).to(x.dtype)
    c = x.shape[1]
    for buf, off in dests:
        buf[:, off:off + c].copy_(y)


def depthwise_store(x: torch.Tensor, weight: torch.Tensor, stride: int,
                    bias: Optional[torch.Tensor],
                    dests: Sequence[Dest]) -> None:
    """Store the depth-wise 3x3 conv of ``x`` (as
    :func:`depthwise_store_reference`) into each of ``dests``.

    On CUDA tensors it launches the kernel: ``x`` and every buffer
    channels-last in memory, ``weight`` in ``x``'s dtype (f32 or bf16),
    ``bias`` float32 or None, ``stride`` 1 or 2, 1 to :data:`MAX_DESTS`
    destinations; it raises on anything else.  On the CPU it runs the plain
    version.  Each launch is counted in ``launch.depthwise_store``."""
    if not x.is_cuda:
        return depthwise_store_reference(x, weight, stride, bias, dests)
    n, c, h, w = x.shape
    dt = x.dtype
    code = _cuda.dtype_code(dt, "depthwise_store")
    if stride not in (1, 2):
        raise ValueError(f"depthwise_store takes stride 1 or 2, got {stride}")
    if not 1 <= len(dests) <= MAX_DESTS:
        raise ValueError(f"depthwise_store takes 1 to {MAX_DESTS} "
                         f"destinations, got {len(dests)}")
    # x and each buffer: channels-last in memory, the [N, H, W, C] arrays
    # the kernel reads and writes
    cl = torch.channels_last
    if not x.is_contiguous(memory_format=cl) or x.data_ptr() % 16:
        raise ValueError("x must be a 16-byte aligned channels-last tensor")
    _cuda.require(weight, "weight", dt, (c, 1, 3, 3))
    if bias is not None:
        _cuda.require(bias, "bias", torch.float32, (c,))
    ho, wo = out_size(h, w, stride)
    x0 = x.data_ptr()
    x1 = x0 + x.numel() * x.element_size()
    ptrs, offs, pitches = [], [], []
    for buf, off in dests:
        cb, b0 = buf.shape[1], buf.data_ptr()
        if (buf.device != x.device or buf.dtype != dt
                or not buf.is_contiguous(memory_format=cl) or b0 % 16):
            raise ValueError(f"a destination must be a 16-byte aligned "
                             f"channels-last {dt} tensor on {x.device}")
        if buf.shape != (n, cb, ho, wo) or not 0 <= off <= cb - c:
            raise ValueError(f"destination {tuple(buf.shape)} at channel "
                             f"{off} cannot hold [{n}, {c}, {ho}, {wo}]")
        if b0 < x1 and x0 < b0 + buf.numel() * buf.element_size():
            raise ValueError("a destination overlaps x")
        ptrs.append(b0)
        offs.append(off)
        pitches.append(cb)
    table = (ctypes.c_longlong * (3 * len(dests)))(*ptrs, *offs, *pitches)
    _cuda.launch("depthwise_store_launch", x.device, x.data_ptr(),
                 weight.data_ptr(),
                 None if bias is None else bias.data_ptr(),
                 ctypes.addressof(table), len(dests), n, h, w, c, stride,
                 code, store_vector_width(c, dt, dests),
                 count="launch.depthwise_store")
