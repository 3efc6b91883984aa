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
    """Affine layer on the last axis (``weight [out, in]``, float32).

    Split over a mesh's model axis (``parallel.sharding.shard_train_state``
    sets ``tp`` to ``(model group, index, size)``), ``weight`` holds this
    rank's rows of output features and the layer gathers the full output
    over the group (``parallel.sharding.column_parallel_linear``); ``bias``
    stays whole.
    """

    def __init__(self, in_features: int, out_features: int,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.zeros(out_features))
        self.in_features, self.out_features = in_features, out_features
        self.compute_dtype = compute_dtype
        self.tp = None

    def reset_parameters(self, generator: torch.Generator):
        _lecun_normal_(self.weight, self.weight.shape[1], generator)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if self.tp is not None:
            from two_stage_object_detection_tpu_torch.parallel.sharding import (
                column_parallel_linear)
            group, index, _ = self.tp
            return column_parallel_linear(x.to(dt), self.weight.to(dt),
                                          self.bias.to(dt), group, index)
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

    With a data group (:func:`set_data_group`, which
    ``parallel.mesh.place_train_state`` calls over several ranks) the
    train-mode statistics are those of the global batch, every rank's
    images, as in the JAX package's one SPMD program over a data mesh
    (:class:`_CrossReplicaNorm`).  Without one, the layer is the
    ``F.batch_norm`` path above.
    """

    EPS, MOMENTUM = 1e-5, 0.9

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))
        self.update_stats = True      # see frozen_running_stats
        self.group = None             # see set_data_group

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.EPS)
        if self.group is not None:
            return self._cross_replica(x)
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

    def _cross_replica(self, x: torch.Tensor) -> torch.Tensor:
        """Train mode over the global batch of the data group: the
        statistics of every rank's images, as the JAX package's batch norm
        takes them inside one SPMD program over a data mesh."""
        mean, var, count = _global_moments(x, self.group)
        if self.update_stats:
            m = self.MOMENTUM
            with torch.no_grad():
                self.running_mean.mul_(m).add_(mean, alpha=1.0 - m)
                self.running_var.mul_(m).add_(var, alpha=1.0 - m)
        invstd = torch.rsqrt(var + self.EPS)
        return _CrossReplicaNorm.apply(x, self.weight, self.bias, mean,
                                       invstd, count, self.group)


def _global_moments(x: torch.Tensor, group):
    """Per-channel mean, biased variance and count (float32 ``[C]`` each)
    of ``x [N, C, H, W]`` over every rank of ``group``.

    Each rank sends its count, mean and centred sum of squares, gathered,
    then combined in rank order in float64 (Chan et al.'s pairwise update),
    so that every rank computes the same bits and no sum of squares loses
    the variance to cancellation.  A rank's float32 mean is off by up to
    half an ulp of its magnitude, and that error would enter the
    between-rank term of the combine to first order (2e-4 of the variance
    where the mean is 1e4 times the spread: ``tests/test_torch_parallel_tp.py``),
    so the rank refines it in float64 with the sum of its deviations from
    it, and takes its sum of squares about the refined mean."""
    from two_stage_object_detection_tpu_torch.parallel.multiprocess import (
        all_gather)
    with torch.no_grad():
        xf = x.detach().to(torch.float32)
        dims = (0, 2, 3)
        n = float(xf.numel() // xf.shape[1])
        mean = xf.mean(dims)
        d = xf - mean[:, None, None]
        s1 = d.sum(dims).double()
        s2 = (d * d).sum(dims).double()
        local = torch.stack([torch.full_like(s1, n), mean.double() + s1 / n,
                             s2 - s1 * s1 / n])
        count, means, m2s = all_gather(local, group).unbind(1)
        total = count.sum(0)
        g_mean = (count * means).sum(0) / total
        m2 = (m2s + count * (means - g_mean) ** 2).sum(0)
        return g_mean.float(), (m2 / total).float(), total.float()


class _CrossReplicaNorm(torch.autograd.Function):
    """``(x - mean) * invstd * weight + bias`` with statistics over the data
    group.  The backward reduces its two per-channel sums, of ``dy`` and of
    ``dy * x_hat``, over the group: the gradient reaching ``x`` is that of
    every rank's loss through the shared statistics.  The weight and bias
    gradients stay this rank's (the train step's all-reduce sums them)."""

    @staticmethod
    def forward(ctx, x, weight, bias, mean, invstd, count, group):
        xf = x.to(torch.float32)
        xhat = (xf - mean[:, None, None]) * invstd[:, None, None]
        ctx.save_for_backward(xhat, weight, invstd)
        ctx.group, ctx.count = group, count
        out = xhat * weight[:, None, None] + bias[:, None, None]
        return out.to(x.dtype)

    @staticmethod
    def backward(ctx, dy):
        from two_stage_object_detection_tpu_torch.parallel.multiprocess import (
            all_reduce_)
        xhat, weight, invstd = ctx.saved_tensors
        dyf = dy.to(torch.float32)
        sums = torch.stack([dyf.sum((0, 2, 3)), (dyf * xhat).sum((0, 2, 3))])
        d_bias, d_weight = sums[0].clone(), sums[1].clone()
        all_reduce_(sums, "sum", ctx.group)
        mean_dy, mean_dy_xhat = sums / ctx.count
        dx = (dyf - mean_dy[:, None, None]
              - xhat * mean_dy_xhat[:, None, None]) * (
                  weight * invstd)[:, None, None]
        return dx.to(dy.dtype), d_weight, d_bias, None, None, None, None


def set_data_group(module: nn.Module, group) -> None:
    """Every :class:`BatchNorm` below ``module`` takes its train-mode
    statistics over the ranks of ``group`` (None: this process's batch,
    ``F.batch_norm`` as before)."""
    for m in module.modules():
        if isinstance(m, BatchNorm):
            m.group = group


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
