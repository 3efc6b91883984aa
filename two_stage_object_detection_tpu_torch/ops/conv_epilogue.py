"""The conv epilogue of the backbones' folded predict route.

With eval-mode batch norm folded into a conv's weights and a float32 bias
(``models/layers.py:fold_norm``), what is left after the unbiased conv is
``act(y + bias[c] (+ residual))``: one pass over its output where batch
norm, the residual add and the activation took one each.
:func:`conv_epilogue` runs it on CUDA tensors as the hand-written kernel
``csrc/conv_epilogue.cu``, in place, and on the CPU as its plain version,
:func:`conv_epilogue_reference`.  The two agree bit for bit: both sum in
float32 in the same order and round once.  It is no custom op: only the
eager folded route calls it, and a traced program keeps the unfolded
route (``models/layers.py:fold_route`` says why).
"""

from __future__ import annotations

from typing import Optional

import torch

from two_stage_object_detection_tpu_torch.ops import _cuda

ACTS = {"none": 0, "relu6": 1, "prelu": 2}


def conv_epilogue_reference(y: torch.Tensor, bias: torch.Tensor,
                            residual: Optional[torch.Tensor] = None,
                            act: str = "none",
                            slope: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """Plain version: ``act(y + bias[c] (+ residual))`` of ``y [N, C, H,
    W]`` in float32, rounded once to ``y``'s dtype.  ``bias [C]`` float32;
    ``act`` one of :data:`ACTS`: ``"relu6"`` clamps to [0, 6],
    ``"prelu"`` scales the negatives by the one-element ``slope``, taken in
    ``y``'s dtype as ``F.prelu`` takes its weight."""
    v = y.to(torch.float32) + bias.to(torch.float32)[:, None, None]
    if residual is not None:
        v = v + residual.to(torch.float32)
    if act == "relu6":
        v = torch.clamp(v, 0.0, 6.0)
    elif act == "prelu":
        a = slope.to(y.dtype).to(torch.float32)
        v = torch.where(v >= 0, v, v * a)
    elif act != "none":
        raise ValueError(f"unknown activation {act!r}")
    return v.to(y.dtype)


def conv_epilogue(y: torch.Tensor, bias: torch.Tensor,
                  residual: Optional[torch.Tensor] = None, act: str = "none",
                  slope: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``act(y + bias[c] (+ residual))`` as :func:`conv_epilogue_reference`.

    On a CUDA tensor it launches the kernel, in place on ``y`` once ``y``
    is channels-last in memory (a conv's output on the card is: the port's
    weights are), and returns ``y``; on the CPU it returns the plain
    version's new tensor.  Each launch is counted in
    ``launch.conv_epilogue``."""
    if not y.is_cuda:
        return conv_epilogue_reference(y, bias, residual, act, slope)
    cl = torch.channels_last
    y = y.contiguous(memory_format=cl)
    if residual is not None:
        residual = residual.contiguous(memory_format=cl)
    _launch(y, bias, residual, ACTS[act], slope)
    return y


def _launch(y, bias, residual, act, slope):
    n, c, h, w = y.shape
    dt = y.dtype
    code = _cuda.dtype_code(dt, "conv_epilogue")
    # the channels-last tensors as the [N, H, W, C] arrays the kernel reads
    _cuda.require(y.permute(0, 2, 3, 1), "y", dt)
    if residual is not None:
        _cuda.require(residual.permute(0, 2, 3, 1), "residual", dt,
                      (n, h, w, c))
    _cuda.require(bias, "bias", torch.float32, (c,))
    if act == ACTS["prelu"]:
        _cuda.require(slope, "slope", torch.float32, (1,))
    elif act not in ACTS.values():
        raise ValueError(f"unknown activation code {act}")
    _cuda.launch("conv_epilogue_launch", y.device, y.data_ptr(),
                 None if residual is None else residual.data_ptr(),
                 bias.data_ptr(),
                 slope.data_ptr() if act == ACTS["prelu"] else None,
                 y.numel(), c, act, code, _cuda.align_vector_width(c, dt),
                 count="launch.conv_epilogue")
