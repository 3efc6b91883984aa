"""Parameter layers with flax's numerics: float32 parameters, compute in
the configured dtype.

Each layer keeps its parameters in float32 and casts them, with its input,
to ``compute_dtype`` for the operation, as a flax module with
``dtype=bfloat16`` does.  Parameter names are PyTorch's (``weight``,
``bias``, ``running_mean``, ``running_var``), so the flax-to-torch map
(``utils/jax_weights.py``) is one rule per layer type.  Initialisation
draws from an explicit ``torch.Generator`` (:func:`init_weights`).

The backbones' predict on the card takes a folded route
(:func:`fold_route`): each eval-mode :class:`BatchNorm` is folded into the
conv before it (:func:`fold_norm`), cached on the module
(:func:`cached_fold`), the conv runs with the folded weight and no bias
(:meth:`Conv.forward`'s ``weight``), and the bias, residual and activation
after it are one pass of ``ops/conv_epilogue.py``'s kernel.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch._subclasses.fake_tensor import FakeTensor

from two_stage_object_detection_tpu_torch.ops.conv_epilogue import (
    conv_epilogue)
from two_stage_object_detection_tpu_torch.parallel import spatial
from two_stage_object_detection_tpu_torch.utils.profiling import counters


def _lecun_normal_(w: torch.Tensor, fan_in: int, generator: torch.Generator):
    """flax's default kernel init: truncated normal (+-2 std) of variance
    ``1 / fan_in``."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=generator)


class Conv(nn.Module):
    """2-D convolution on NCHW tensors (``weight`` OIHW, float32).

    While a row shard is active (``parallel/spatial.py``) it runs on the
    shard's rows: the halo it reads is exchanged with the other shards and
    only the image's real top and bottom are zero-padded."""

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

    def forward(self, x: torch.Tensor, weight: torch.Tensor = None
                ) -> torch.Tensor:
        """``weight``: a folded weight in the compute dtype
        (:func:`fold_norm`) to convolve with in place of ``self.weight``,
        and no bias (the folded route's epilogue adds it)."""
        dt = self.compute_dtype
        if weight is None:
            bias = None if self.bias is None else self.bias.to(dt)
            w = self.weight.to(dt)
        else:
            bias, w = None, weight
        shard = spatial.current()
        if shard is not None:
            return shard.conv(
                x.to(dt), w.shape[2], self.stride, self.padding,
                lambda slab: F.conv2d(slab, w, bias, self.stride,
                                      (0, self.padding), 1, self.groups))
        return F.conv2d(x.to(dt), w, bias, self.stride, self.padding, 1,
                        self.groups)


class ConvTranspose(nn.Module):
    """2-D transposed convolution on NCHW tensors with kernel = stride (no
    overlap: each output pixel takes one input pixel's ``in_ch`` values),
    ``weight [in_ch, out_ch, k, k]`` float32 as ``F.conv_transpose2d``
    takes it; initialised as a :class:`Conv` of fan-in ``in_ch``, the
    inputs one output sums."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int = 2,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(in_ch, out_ch, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(out_ch))
        self.stride = kernel
        self.compute_dtype = compute_dtype

    def reset_parameters(self, generator: torch.Generator):
        _lecun_normal_(self.weight, self.weight.shape[0], generator)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return F.conv_transpose2d(x.to(dt), self.weight.to(dt),
                                  self.bias.to(dt), self.stride)


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


class Linear(nn.Module):
    """Affine layer on the last axis of tokens ``[..., in]`` (``weight
    [out, in]``, float32; ``bias`` optional): the transformer trunk's
    layers, drawn as the published Swin draws them (truncated normal of
    std 0.02, bias zero).  Not a :class:`Dense`: the tensor-parallel rules
    split dense heads, not a trunk."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.zeros(out_features)) if bias else None
        self.compute_dtype = compute_dtype

    def reset_parameters(self, generator: torch.Generator):
        trunc_normal_002_(self.weight, generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), bias)


class LayerNorm(nn.Module):
    """Layer norm over the last axis of tokens, ``eps`` 1e-5 as
    ``nn.LayerNorm``: the statistics in float32 (``F.layer_norm``
    accumulates a bfloat16 input's in float32), the result in
    ``compute_dtype``."""

    EPS = 1e-5

    def __init__(self, channels: int,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.compute_dtype = compute_dtype

    def reset_parameters(self, generator: torch.Generator):
        nn.init.ones_(self.weight)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return F.layer_norm(x.to(dt), self.weight.shape, self.weight.to(dt),
                            self.bias.to(dt), self.EPS)


def trunc_normal_002_(w: torch.Tensor, generator: torch.Generator):
    """The published transformer init: normal of std 0.02, truncated at
    +-2 (absolute, so in effect untruncated), as timm's
    ``trunc_normal_(w, std=.02)``."""
    with torch.no_grad():
        nn.init.trunc_normal_(w, 0.0, 0.02, -2.0, 2.0, generator=generator)


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
    (:class:`_CrossReplicaNorm`); with image rows over the model axis
    (``spatial``) the group is the whole mesh, and each rank holds a block
    of rows of its images, which may be empty.  Without one, the layer is
    the ``F.batch_norm`` path above.
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
    the variance to cancellation.  A rank may hold no element (an empty
    block of rows): it sends a count of 0 and zeros.  A rank's float32 mean is off by up to
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
        mean = xf.mean(dims) if n else xf.new_zeros(xf.shape[1])
        d = xf - mean[:, None, None]
        s1 = d.sum(dims).double()
        s2 = (d * d).sum(dims).double()
        local = torch.stack([torch.full_like(s1, n),
                             mean.double() + s1 / max(n, 1.0),
                             s2 - s1 * s1 / max(n, 1.0)])
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
    """Initialise every layer below ``module`` from ``generator``, in
    module order (deterministic for a seed): each module with a
    ``reset_parameters(generator)``, which the port's layers have
    (:class:`Conv`, :class:`ConvTranspose`, :class:`Dense`,
    :class:`Linear`, :class:`LayerNorm`, the Swin attention's bias table)
    and no other module of the port."""
    for m in module.modules():
        if hasattr(m, "reset_parameters"):
            m.reset_parameters(generator)


# ------------------------------------------------------------ folded route
def fold_route(trunk: nn.Module, x: torch.Tensor) -> bool:
    """Whether a backbone's call on ``x`` takes the folded route: on a CUDA
    tensor, in eval mode, with gradients off (``predict``'s
    ``inference_mode``, never training, not even with ``freeze_bn``),
    outside ``torch.compile`` and ``torch.export``'s tracing, and with no
    conv's ``forward`` replaced (``quantize.quantized``) and no hook on a
    conv or norm (the route calls each conv's ``forward`` and no norm:
    ``quantize.calibrate`` hooks them).  A row shard
    (``parallel/spatial.py``) takes the route too: the folded conv is
    :meth:`Conv.forward`, which runs on the shard's rows, and the epilogue
    is elementwise.  Otherwise it counts ``fold.fallback.<reason>`` in
    ``utils.profiling.counters`` and the caller runs the modules as they
    are.  One check a backbone call; the reasons are tested in the order
    below, so that training returns at the first.

    A traced program (``serving.export_program``) keeps the unfolded
    route: its weights are the program's inputs, so a fold inside it would
    run again on every call, and ``torch.export`` copies an intermediate
    before an op writes it in place, which would cost the pass the
    epilogue saves."""
    reason = _unfolded_reason(trunk, x)
    if reason is None:
        return True
    counters["fold.fallback." + reason] += 1
    return False


def _unfolded_reason(trunk: nn.Module, x: torch.Tensor):
    if trunk.training:
        return "train"
    if torch.is_grad_enabled():
        return "grad"
    if torch.compiler.is_compiling() or isinstance(x, FakeTensor):
        return "compile"
    mods = trunk.__dict__.get("_fold_modules")
    if mods is None:
        mods = [m for m in trunk.modules() if isinstance(m, (Conv, BatchNorm))]
        trunk.__dict__["_fold_modules"] = mods
    for m in mods:
        if m.training:
            return "train"
        if "forward" in m.__dict__:
            return "int8"
        if m._forward_hooks or m._forward_pre_hooks:
            return "hooks"
    if not x.is_cuda:
        return "cpu"
    return None


def fold_norm(conv: Conv, norm: BatchNorm):
    """``norm`` (eval mode) folded into ``conv``: float32 ``(w', b')`` with
    ``w' = w * s`` by output channel and ``b' = beta - mean * s`` (plus the
    conv's own bias), ``s = gamma / sqrt(var + eps)``, so that
    ``conv(x, w') + b' == norm(conv(x))``."""
    scale = norm.weight / torch.sqrt(norm.running_var + norm.EPS)
    w = conv.weight * scale[:, None, None, None]
    b = norm.bias - norm.running_mean * scale
    if conv.bias is not None:
        b = b + conv.bias
    return w, b


def fold_sources(*modules: nn.Module, pending=None):
    """The tensors a fold of ``modules`` reads: their own parameters and
    buffers, and the ``pending`` bias of the input, if any."""
    out = [t for m in modules
           for t in (*m._parameters.values(), *m._buffers.values())
           if t is not None]
    if pending is not None:
        out.append(pending)
    return out


def cached_fold(owner: nn.Module, sources, build):
    """``build()``, cached on ``owner`` and rebuilt when a tensor of
    ``sources`` changes: each is stamped with its identity, storage and
    ``_version``, which ``load_state_dict``, an optimiser step and a
    train-mode batch norm's statistics update all bump (an inference
    tensor, such as a bias another cache built under ``inference_mode``,
    keeps no version and is never written: its identity stamps it).  The
    cache holds its sources, so no identity is reused while it lives.
    Counts each build in ``fold.rebuild``.  The cache is a plain
    attribute: not state, not saved."""
    stamp = [(id(t), t.data_ptr(), 0 if t.is_inference() else t._version)
             for t in sources]
    hit = owner.__dict__.get("_fold_cache")
    if hit is not None and hit[0] == stamp:
        return hit[2]
    value = build()
    owner.__dict__["_fold_cache"] = (stamp, list(sources), value)
    counters["fold.rebuild"] += 1
    return value


def through_1x1(w: torch.Tensor, b: torch.Tensor, pending):
    """The bias of an unpadded 1x1 conv of folded weight ``w`` (f32, ``[O,
    I, 1, 1]``) and bias ``b`` whose input carries a per-channel bias
    ``pending [I]`` not yet added (None: none): ``b + w . pending``, exact,
    since every output pixel is ``w`` times one input pixel."""
    if pending is None:
        return b
    return b + w[:, :, 0, 0] @ pending


def epilogue(y: torch.Tensor, bias: torch.Tensor, residual=None,
             act: str = "none", slope=None) -> torch.Tensor:
    """The folded route's pass after an unbiased conv (the kernel on the
    card, its plain version on the CPU), counted in ``fold.epilogue``."""
    counters["fold.epilogue"] += 1
    return conv_epilogue(y, bias, residual, act, slope)
