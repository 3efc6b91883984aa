"""Parameter layers with flax's numerics: float32 parameters, compute in
the layer's dtype.

Frozen from the port's ``models/layers.py`` with the mesh paths (row
shards, split dense layers, the cross-replica batch norm) taken out.  Two
things are the benchmark's own:

* :func:`init_weights` draws every convolution and dense kernel from one
  seeded ``torch.Generator`` on the model's device, in one call: a
  standard normal truncated at +-2 for all of them at once, each slice
  then scaled to its layer's std (flax's ``lecun_normal``).  ``boost``
  multiplies the std of named layers.
* :func:`low_precision` switches the convolutions and dense layers of
  this module to a control's precision, as 8-bit training runs them: the
  forward product's operands (input and weight) rounded with a per-tensor
  scale to float8 e4m3 (their absolute maximum onto 448), and the
  backward products' operand, the output's gradient, to float8 e5m2
  (onto 57344); each rounding straight through.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn as nn
import torch.nn.functional as F

E4M3_MAX = 448.0
E5M2_MAX = 57344.0


class _Precision:
    """The operand rounding of :class:`Conv` and :class:`Dense`: None or
    ``"fp8"`` (:func:`low_precision`)."""
    mode = None


PRECISION = _Precision()


@contextlib.contextmanager
def low_precision(mode: str):
    """Convolutions and dense layers take operands rounded to ``mode``
    (``"fp8"``: float8 e4m3) inside."""
    if mode != "fp8":
        raise ValueError(f"low_precision takes 'fp8', got {mode!r}")
    PRECISION.mode = mode
    try:
        yield
    finally:
        PRECISION.mode = None


class _Round(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _round(x)

    @staticmethod
    def backward(ctx, g):
        return g


def _round(x: torch.Tensor, fp8=torch.float8_e4m3fn,
           fp8_max: float = E4M3_MAX) -> torch.Tensor:
    amax = x.detach().abs().amax().float().clamp(min=1e-12)
    scale = fp8_max / amax
    return ((x.float() * scale).to(fp8).float() / scale).to(x.dtype)


class _RoundGrad(torch.autograd.Function):
    """Identity forward; the gradient rounded to e5m2 backward."""

    @staticmethod
    def forward(ctx, y):
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2, E5M2_MAX)


def _operand(x: torch.Tensor) -> torch.Tensor:
    return x if PRECISION.mode is None else _Round.apply(x)


def _output(y: torch.Tensor) -> torch.Tensor:
    return y if PRECISION.mode is None or not torch.is_grad_enabled() else \
        _RoundGrad.apply(y)


def lecun_std(w: torch.Tensor) -> float:
    """flax's default kernel init std: ``sqrt(1 / fan_in)`` over the
    truncation's variance."""
    return math.sqrt(1.0 / w[0].numel()) / 0.87962566103423978


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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return _output(F.conv2d(_operand(x.to(dt)),
                                _operand(self.weight.to(dt)), bias,
                                self.stride, self.padding, 1, self.groups))


class Dense(nn.Module):
    """Affine layer on the last axis (``weight [out, in]``, float32)."""

    def __init__(self, in_features: int, out_features: int,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.zeros(out_features))
        self.in_features, self.out_features = in_features, out_features
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return _output(F.linear(_operand(x.to(dt)),
                                _operand(self.weight.to(dt)),
                                self.bias.to(dt)))


class BatchNorm(nn.Module):
    """Batch norm over NCHW channels with flax's numerics:
    ``(x - mean) / sqrt(var + 1e-5) * weight + bias``, statistics in
    float32, the result in the input's dtype.

    In eval mode ``mean`` / ``var`` are the running statistics.  In train
    mode they are the batch's, the variance **biased** (divided by n), and
    the running statistics move as flax's do: ``ra = 0.9 * ra + 0.1 *
    batch`` with the same biased variance (``F.batch_norm`` runs on
    scratch statistics and the variance is scaled back by ``(n - 1) /
    n``).
    """

    EPS, MOMENTUM = 1e-5, 0.9

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))
        self.update_stats = True

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
    running statistics alone inside."""
    norms = [m for m in module.modules() if isinstance(m, BatchNorm)]
    for m in norms:
        m.update_stats = False
    try:
        yield
    finally:
        for m in norms:
            m.update_stats = True


def init_weights(module: nn.Module, seed: int, boost=None) -> None:
    """Every :class:`Conv` / :class:`Dense` kernel below ``module`` from
    one standard normal truncated at +-2, drawn in one call from a
    ``torch.Generator`` on the parameters' device seeded with ``seed``,
    each kernel's slice in module order scaled to :func:`lecun_std` (times
    ``boost[name]`` for the named layers); biases zero.  Same seed, same
    weights."""
    boost = boost or {}
    layers = [(n, m) for n, m in module.named_modules()
              if isinstance(m, (Conv, Dense))]
    dev = layers[0][1].weight.device
    total = sum(m.weight.numel() for _, m in layers)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    flat = torch.empty(total, dtype=torch.float32, device=dev)
    nn.init.trunc_normal_(flat, 0.0, 1.0, -2.0, 2.0, generator=gen)
    at = 0
    with torch.no_grad():
        for name, m in layers:
            n = m.weight.numel()
            std = lecun_std(m.weight) * boost.get(name, 1.0)
            m.weight.copy_(flat[at:at + n].view_as(m.weight) * std)
            if m.bias is not None:
                m.bias.zero_()
            at += n
