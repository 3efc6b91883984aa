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

import contextlib
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
    """Batch norm over NCHW channels with flax's numerics:
    ``(x - mean) / sqrt(var + 1e-5) * weight + bias``, statistics in
    float32, the result in the input's dtype.

    In eval mode ``mean`` / ``var`` are the running statistics
    (``use_running_average=True``).  In train mode they are the batch's, the
    variance **biased** (divided by n), and the running statistics move as
    flax's do: ``ra = 0.9 * ra + 0.1 * batch`` with the same biased
    variance.  ``F.batch_norm`` normalises with the biased variance
    but hands back the unbiased one, so it runs here on scratch statistics
    (its ``momentum=1`` returns the batch's own) and the variance is scaled
    back by ``(n - 1) / n`` before it enters the running average.
    """

    EPS, MOMENTUM = 1e-5, 0.9

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))
        self.update_stats = True      # see frozen_running_stats

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.EPS)
        mean = torch.zeros_like(self.running_mean)
        var = torch.zeros_like(self.running_var)
        out = F.batch_norm(x, mean, var, self.weight, self.bias, True, 1.0,
                           self.EPS)
        if not self.update_stats:
            return out
        n = x.numel() // x.shape[1]
        m = self.MOMENTUM
        with torch.no_grad():
            self.running_mean.mul_(m).add_(mean, alpha=1.0 - m)
            self.running_var.mul_(m).add_(var, alpha=(1.0 - m) * (n - 1) / n)
        return out


@contextlib.contextmanager
def frozen_running_stats(module: nn.Module):
    """Train-mode :class:`BatchNorm` layers below ``module`` leave their
    running statistics alone inside: for the second forward of a
    rematerialised block, whose first forward has already moved them."""
    norms = [m for m in module.modules() if isinstance(m, BatchNorm)]
    for m in norms:
        m.update_stats = False
    try:
        yield
    finally:
        for m in norms:
            m.update_stats = True


def init_weights(module: nn.Module, generator: torch.Generator) -> None:
    """Initialise every :class:`Conv` / :class:`Dense` below ``module`` from
    ``generator``, in module order (deterministic for a seed)."""
    for m in module.modules():
        if isinstance(m, (Conv, Dense)):
            m.reset_parameters(generator)
