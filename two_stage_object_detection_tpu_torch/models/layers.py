"""Parameter layers with flax's numerics: float32 parameters, compute in
the configured dtype.

Each layer keeps its parameters in float32 and casts them, with its input,
to ``compute_dtype`` for the operation, as a flax module with
``dtype=bfloat16`` does.  Parameter names are PyTorch's (``weight``,
``bias``, ``running_mean``, ``running_var``), so the flax-to-torch map
(``utils/jax_weights.py``) is one rule per layer type.  Initialisation
draws from an explicit ``torch.Generator`` (:func:`init_weights`).
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F


def _lecun_normal_(w: torch.Tensor, fan_in: int, generator: torch.Generator):
    """flax's default kernel init: truncated normal (+-2 std) of variance
    ``1 / fan_in``."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=generator)


class Conv(nn.Module):
    """2-D convolution on NCHW tensors (``weight`` OIHW, float32)."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int = 1,
                 padding: int = 0, groups: int = 1, bias: bool = True,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch // groups,
                                               kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(out_ch)) if bias else None
        self.stride, self.padding, self.groups = stride, padding, groups
        self.compute_dtype = compute_dtype

    def reset_parameters(self, generator: torch.Generator):
        _lecun_normal_(self.weight, self.weight[0].numel(), generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.conv2d(x.to(dt), self.weight.to(dt), bias, self.stride,
                        self.padding, 1, self.groups)


class Dense(nn.Module):
    """Affine layer on the last axis (``weight [out, in]``, float32)."""

    def __init__(self, in_features: int, out_features: int,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.zeros(out_features))
        self.compute_dtype = compute_dtype

    def reset_parameters(self, generator: torch.Generator):
        _lecun_normal_(self.weight, self.weight.shape[1], generator)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


class BatchNorm(nn.Module):
    """Inference-mode batch norm over NCHW channels:
    ``(x - mean) / sqrt(var + 1e-5) * weight + bias``, computed in float32
    and returned in the input's dtype, as flax's ``BatchNorm`` with
    ``use_running_average=True`` does."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.batch_norm(x, self.running_mean, self.running_var,
                            self.weight, self.bias, False, 0.0, self.eps)


def init_weights(module: nn.Module, generator: torch.Generator) -> None:
    """Initialise every :class:`Conv` / :class:`Dense` below ``module`` from
    ``generator``, in module order (deterministic for a seed)."""
    for m in module.modules():
        if isinstance(m, (Conv, Dense)):
            m.reset_parameters(generator)
