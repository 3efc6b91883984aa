"""Swin Transformer trunk for the FPN (Liu et al., arXiv:2103.14030).

Swin-T as the published detection backbone builds it
(Swin-Transformer-Object-Detection, ``mmdet/models/backbones/
swin_transformer.py``): a 4x4 stride-4 patch embedding with LayerNorm, four
stages of shifted-window blocks (depths 2, 2, 6, 2; widths 96 to 768;
heads of 32 channels), a 2x2 patch merging between stages and a LayerNorm
on each stage's output, the FPN's taps ``C2..C5``.  Each block is, as
published::

    x = x + crop(reverse(attn(partition(roll(pad(norm1(x)))))))
    x = x + fc2(gelu(fc1(norm2(x))))

with the tokens padded after ``norm1`` to a multiple of the 7x7 window
(padded tokens stay unmasked keys, as published) and every second block's
windows shifted by 3 under a region mask of -100.  Attention is
``softmax(q k^T * head_dim ** -0.5 + B + M) v`` with ``B`` the block's
learned relative-position bias and ``M`` the shift mask: one call of
``F.scaled_dot_product_attention`` a block (:func:`window_attention`),
whose additive mask ``B + M`` is built once per padded shape and kept on
the module (:meth:`WindowAttention.mask`).

Tokens are ``[B, H, W, C]``, channels-last memory, so a tap's NCHW view
(``permute(0, 3, 1, 2)``) is free.  Parameters are float32 and every
product runs in ``compute_dtype``; LayerNorm statistics and the softmax run
in float32.  Module and parameter names are the published ones
(``patch_embed.proj``, ``layers.{i}.blocks.{j}.attn.qkv``, ``norm{i}``,
...), so a published state dict maps by name
(``utils/torch_import.py:convert_swin_state_dict``).

Counts in ``utils.profiling.counters``: ``swin.windows`` (windows attended,
on the padded grid), ``swin.pad_tokens`` (tokens the blocks and the patch
merging add by padding) and ``swin.mask_build`` (additive masks built: 0 a
call once each block's mask is cached).  Each block's attention, from the
partition to the reverse, is the span ``tsod.window_attention``.

Not in the port: stochastic depth (the published ``drop_path_rate`` 0.2
trains with it) and the absolute position embedding (off in Swin-T).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch._subclasses.fake_tensor import FakeTensor

from two_stage_object_detection_tpu_torch.models.layers import (
    Conv, LayerNorm, Linear, trunc_normal_002_)
from two_stage_object_detection_tpu_torch.utils.profiling import (
    annotate, counters)

SHIFT_MASK = -100.0


def window_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     mask: torch.Tensor, scale: float) -> torch.Tensor:
    """The attention core of one block: ``softmax(q k^T * scale + mask)
    v``.  ``q, k, v [B, nW * heads, N, d]`` (each image's windows and heads
    on one axis), ``mask [nW * heads, N, N]`` additive, the same for every
    image."""
    return F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                          scale=scale)


def relative_position_index(window: int) -> torch.Tensor:
    """``[N, N]`` int64 (``N = window ** 2``): the bias-table row of each
    (query, key) pair of a window, as published."""
    coords = torch.stack(torch.meshgrid(torch.arange(window),
                                        torch.arange(window), indexing="ij"))
    flat = coords.flatten(1)
    rel = (flat[:, :, None] - flat[:, None, :]).permute(1, 2, 0)
    return (rel[..., 0] + window - 1) * (2 * window - 1) + rel[..., 1] + window - 1


def shift_regions(hp: int, wp: int, window: int, shift: int, device
                  ) -> torch.Tensor:
    """``[nW, N, N]`` f32: 0 where a query and a key of a shifted window
    come from the same region of the rolled map, -100 where not (the
    published ``attn_mask``)."""
    img = torch.zeros((hp, wp), device=device)
    cuts = (slice(0, -window), slice(-window, -shift), slice(-shift, None))
    label = 0
    for hs in cuts:
        for ws in cuts:
            img[hs, ws] = label
            label += 1
    win = img.view(hp // window, window, wp // window, window).transpose(1, 2)
    win = win.reshape(-1, window * window)
    diff = win[:, None, :] - win[:, :, None]
    return torch.where(diff != 0, SHIFT_MASK, 0.0)


class WindowAttention(nn.Module):
    """Multi-head self-attention inside 7x7 windows with the learned
    relative-position bias (``relative_position_bias_table [(2w - 1)^2,
    heads]``; ``relative_position_index``, recomputed, is not state).
    ``[B, nW, N, C]`` windows -> ``[B, nW, N, C]``."""

    def __init__(self, dim: int, window: int, num_heads: int,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.window, self.num_heads = window, num_heads
        self.scale = (dim // num_heads) ** -0.5
        self.compute_dtype = compute_dtype
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window - 1) ** 2, num_heads))
        self.register_buffer("relative_position_index",
                             relative_position_index(window), persistent=False)
        self.qkv = Linear(dim, 3 * dim, compute_dtype=compute_dtype)
        self.proj = Linear(dim, dim, compute_dtype=compute_dtype)

    def reset_parameters(self, generator: torch.Generator):
        trunc_normal_002_(self.relative_position_bias_table, generator)

    def bias(self) -> torch.Tensor:
        """``[heads, N, N]`` f32: the table read at each pair's row."""
        n = self.window ** 2
        b = self.relative_position_bias_table[
            self.relative_position_index.reshape(-1)]
        return b.reshape(n, n, self.num_heads).permute(2, 0, 1)

    def _build_mask(self, hp: int, wp: int, shift: int, like: torch.Tensor
                    ) -> torch.Tensor:
        n = self.window ** 2
        nw = (hp // self.window) * (wp // self.window)
        m = self.bias()[None].expand(nw, -1, -1, -1)
        if shift:
            m = m + shift_regions(hp, wp, self.window, shift, like.device)[:, None]
        counters["swin.mask_build"] += 1
        # rows padded to 8 elements: the memory-efficient kernel reads the
        # mask in place, where it copies an unaligned one on every call
        buf = torch.empty((nw * self.num_heads, n, -(-n // 8) * 8),
                          dtype=self.compute_dtype, device=like.device)
        out = buf[..., :n]
        out.copy_(m.reshape(-1, n, n))
        return out

    def mask(self, hp: int, wp: int, shift: int, like: torch.Tensor
             ) -> torch.Tensor:
        """``[nW * heads, N, N]`` in ``compute_dtype``: the bias of each
        window's heads plus, with ``shift``, the region mask, on a
        ``hp x wp`` padded map of ``like``'s device.

        Built once and cached on the module, keyed by the padded shape,
        shift, dtype and device and stamped by the table's identity,
        storage and ``_version`` (``load_state_dict`` and an optimiser step
        bump it), so it is rebuilt only when the table changes.  Under
        autograd (training) it is built every call, inside the graph;
        while tracing (``torch.export``) it is built and not kept."""
        table = self.relative_position_bias_table
        if torch.is_grad_enabled() or isinstance(like, FakeTensor) or (
                torch.compiler.is_compiling()):
            return self._build_mask(hp, wp, shift, like)
        key = (hp, wp, shift, self.compute_dtype, like.device)
        stamp = (id(table), table.data_ptr(), table._version)
        cache = self.__dict__.setdefault("_mask_cache", {})
        hit = cache.get(key)
        if hit is not None and hit[0] == stamp:
            return hit[1]
        m = self._build_mask(hp, wp, shift, like)
        cache[key] = (stamp, m)
        return m

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        b, nw, n, c = x.shape
        h = self.num_heads
        # [3, B, nW * heads, N, d]: one copy, then q, k and v are views
        qkv = self.qkv(x).view(b, nw, n, 3, h, c // h).permute(
            3, 0, 1, 4, 2, 5).reshape(3, b, nw * h, n, c // h)
        out = window_attention(qkv[0], qkv[1], qkv[2], mask, self.scale)
        out = out.unflatten(1, (nw, h)).transpose(2, 3).reshape(b, nw, n, c)
        return self.proj(out)


class Mlp(nn.Module):
    """``fc2(gelu(fc1(x)))``, exact GELU, ``ratio * C`` hidden."""

    def __init__(self, dim: int, ratio: int, compute_dtype: torch.dtype):
        super().__init__()
        self.fc1 = Linear(dim, ratio * dim, compute_dtype=compute_dtype)
        self.fc2 = Linear(ratio * dim, dim, compute_dtype=compute_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))


class SwinBlock(nn.Module):
    """One shifted-window block on ``[B, H, W, C]`` tokens (``shift`` 0:
    plain windows)."""

    def __init__(self, dim: int, num_heads: int, window: int, shift: int,
                 mlp_ratio: int, compute_dtype: torch.dtype):
        super().__init__()
        self.window, self.shift = window, shift
        self.norm1 = LayerNorm(dim, compute_dtype)
        self.attn = WindowAttention(dim, window, num_heads, compute_dtype)
        self.norm2 = LayerNorm(dim, compute_dtype)
        self.mlp = Mlp(dim, mlp_ratio, compute_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        ws, s = self.window, self.shift
        hp, wp = -(-h // ws) * ws, -(-w // ws) * ws
        nh, nw = hp // ws, wp // ws
        y = self.norm1(x)
        with annotate("tsod.window_attention"):
            if hp != h or wp != w:
                y = F.pad(y, (0, 0, 0, wp - w, 0, hp - h))
            if s:
                y = torch.roll(y, (-s, -s), (1, 2))
            win = y.reshape(b, nh, ws, nw, ws, c).transpose(2, 3).reshape(
                b, nh * nw, ws * ws, c)
            y = self.attn(win, self.attn.mask(hp, wp, s, x))
            y = y.view(b, nh, nw, ws, ws, c).transpose(2, 3).reshape(
                b, hp, wp, c)
            if s:
                y = torch.roll(y, (s, s), (1, 2))
        counters["swin.windows"] += b * nh * nw
        counters["swin.pad_tokens"] += b * (hp * wp - h * w)
        x = x + y[:, :h, :w]
        return x + self.mlp(self.norm2(x))


class PatchMerging(nn.Module):
    """2x2 neighbours gathered in the published order ``(0, 0), (1, 0),
    (0, 1), (1, 1)`` (row, column), LayerNorm over the 4C, then a linear
    map to 2C without bias; an odd side is padded with zeros first.
    ``[B, H, W, C] -> [B, ceil(H/2), ceil(W/2), 2C]``."""

    def __init__(self, dim: int, compute_dtype: torch.dtype):
        super().__init__()
        self.norm = LayerNorm(4 * dim, compute_dtype)
        self.reduction = Linear(4 * dim, 2 * dim, bias=False,
                                compute_dtype=compute_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        if h % 2 or w % 2:
            x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2))
            counters["swin.pad_tokens"] += b * ((h + h % 2) * (w + w % 2) - h * w)
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2],
                       x[:, 1::2, 1::2]], -1)
        return self.reduction(self.norm(x))


class PatchEmbed(nn.Module):
    """``patch x patch`` stride-``patch`` convolution of the image (its
    right and bottom padded with zeros to a multiple), then LayerNorm."""

    def __init__(self, patch: int, dim: int, compute_dtype: torch.dtype):
        super().__init__()
        self.patch = patch
        self.proj = Conv(3, dim, patch, patch, compute_dtype=compute_dtype)
        self.norm = LayerNorm(dim, compute_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """``[B, 3, H, W]`` -> ``[B, H / p, W / p, C]`` tokens."""
        h, w = x.shape[2:]
        p = self.patch
        if h % p or w % p:
            x = F.pad(x, (0, -w % p, 0, -h % p))
        return self.norm(self.proj(x).permute(0, 2, 3, 1))


class SwinStage(nn.Module):
    """``depth`` blocks, every second shifted by ``window // 2``, then
    (all but the last stage) the patch merging to the next stage."""

    def __init__(self, dim: int, depth: int, num_heads: int, window: int,
                 mlp_ratio: int, downsample: bool, compute_dtype: torch.dtype):
        super().__init__()
        self.blocks = nn.ModuleList(
            SwinBlock(dim, num_heads, window, 0 if i % 2 == 0 else window // 2,
                      mlp_ratio, compute_dtype) for i in range(depth))
        self.downsample = (PatchMerging(dim, compute_dtype) if downsample
                           else None)


class SwinFeatureExtraction(nn.Module):
    """The trunk: ``[B, 3, H, W]`` normalised images (an NCHW view, as the
    other trunks take them) -> ``(C2, C3, C4, C5)``, NCHW views of
    channels-last tokens at strides 4-32, ``embed_dim * 2^i`` wide.

    ``out_channels``: the taps' widths, for the FPN neck.  A stride-16
    single map does not exist here: the registry builds it for the FPN
    only."""

    def __init__(self, embed_dim: int = 96,
                 depths: Sequence[int] = (2, 2, 6, 2),
                 num_heads: Sequence[int] = (3, 6, 12, 24), window: int = 7,
                 mlp_ratio: int = 4, patch: int = 4,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.patch_embed = PatchEmbed(patch, embed_dim, dtype)
        dims = [embed_dim * 2 ** i for i in range(len(depths))]
        self.layers = nn.ModuleList(
            SwinStage(d, n, h, window, mlp_ratio, i < len(depths) - 1, dtype)
            for i, (d, n, h) in enumerate(zip(dims, depths, num_heads)))
        for i, d in enumerate(dims):
            self.add_module(f"norm{i}", LayerNorm(d, dtype))
        self.out_channels: Tuple[int, ...] = tuple(dims)

    def forward(self, x: torch.Tensor, generator=None
                ) -> Tuple[torch.Tensor, ...]:
        x = self.patch_embed(x)
        taps = []
        for i, stage in enumerate(self.layers):
            for blk in stage.blocks:
                x = blk(x)
            taps.append(getattr(self, f"norm{i}")(x).permute(0, 3, 1, 2))
            if stage.downsample is not None:
                x = stage.downsample(x)
        return tuple(taps)

