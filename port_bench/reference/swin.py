"""Swin Transformer trunk, plain PyTorch, float32: the benchmark's
reference for the program's ``models/swin.py``.

Liu et al., "Swin Transformer" (arXiv:2103.14030), Swin-T as the published
detection backbone builds it (Swin-Transformer-Object-Detection,
``mmdet/models/backbones/swin_transformer.py``), written after that code
in its own layout (tokens ``[B, L, C]`` with ``H, W`` beside them): patch
embedding (4x4 stride-4 convolution, the image padded right and bottom to
a multiple of 4, LayerNorm), four stages of blocks (depths 2, 2, 6, 2,
widths 96-768, 3-24 heads of 32 channels, 7x7 windows, every second block
shifted by 3), patch merging between stages, and a LayerNorm on each
stage's output.  A block pads its normed tokens to a multiple of 7 (the
padded tokens stay unmasked keys), rolls them, and its attention is
written out, not fused::

    attn = softmax(q k^T * head_dim ** -0.5 + B + M)        (float32)
    out  = attn v

with ``B`` the relative-position bias read from the block's table and
``M`` the shift mask (-100 across regions), built on every call as the
published code builds it.  Linear layers and the convolution take the
benchmark's operand rule (``layers._operand``/``_output``: float8 operands
in the control), so the control's precision reaches the trunk;
LayerNorm runs in float32.  Module names are the published ones, and the
program's, so one state dict serves both.

:func:`init_swin` draws the trunk as published: every linear weight and
bias table from a normal of std 0.02 (truncated at +-2, which a std of
0.02 never reaches), biases 0, LayerNorm 1 and 0; the patch convolution
lecun-normal as every convolution of the reference.  It imports nothing of
the program.  Not modelled: stochastic depth (``drop_path_rate`` 0.2 in
training) and the absolute position embedding (off in Swin-T).
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import Conv, _operand, _output, lecun_std


class Linear(nn.Module):
    """``x W^T + b`` on the last axis (``weight [out, in]``, float32)."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.zeros(out_features)) if bias else None
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        b = None if self.bias is None else self.bias.to(dt)
        return _output(F.linear(_operand(x.to(dt)),
                                _operand(self.weight.to(dt)), b))


class LayerNorm(nn.Module):
    """``nn.LayerNorm`` (eps 1e-5) in float32, the result in the layer's
    dtype."""

    def __init__(self, channels: int,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.weight.shape, self.weight,
                            self.bias, 1e-5).to(self.compute_dtype)


def window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    """``[B, H, W, C] -> [B * nW, ws, ws, C]``, windows in row order."""
    b, h, w, c = x.shape
    x = x.view(b, h // ws, ws, w // ws, ws, c)
    return x.permute(0, 1, 3, 2, 4, 5).contiguous().view(-1, ws, ws, c)


def window_reverse(windows: torch.Tensor, ws: int, h: int, w: int
                   ) -> torch.Tensor:
    """The inverse of :func:`window_partition`."""
    b = int(windows.shape[0] / (h * w / ws / ws))
    x = windows.view(b, h // ws, w // ws, ws, ws, -1)
    return x.permute(0, 1, 3, 2, 4, 5).contiguous().view(b, h, w, -1)


class WindowAttention(nn.Module):
    def __init__(self, dim: int, window: int, num_heads: int,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.window, self.num_heads = window, num_heads
        self.scale = (dim // num_heads) ** -0.5
        self.compute_dtype = compute_dtype
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window - 1) * (2 * window - 1), num_heads))
        coords = torch.stack(torch.meshgrid(
            [torch.arange(window), torch.arange(window)], indexing="ij"))
        flat = torch.flatten(coords, 1)
        rel = (flat[:, :, None] - flat[:, None, :]).permute(1, 2, 0).contiguous()
        rel[:, :, 0] += window - 1
        rel[:, :, 1] += window - 1
        rel[:, :, 0] *= 2 * window - 1
        self.register_buffer("relative_position_index", rel.sum(-1),
                             persistent=False)
        self.qkv = Linear(dim, dim * 3, compute_dtype=compute_dtype)
        self.proj = Linear(dim, dim, compute_dtype=compute_dtype)

    def forward(self, x: torch.Tensor, mask=None) -> torch.Tensor:
        """``x [B * nW, N, C]``; ``mask [nW, N, N]`` or None."""
        bn, n, c = x.shape
        qkv = self.qkv(x).reshape(bn, n, 3, self.num_heads,
                                  c // self.num_heads).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0].float(), qkv[1].float(), qkv[2].float()
        attn = (_operand(q) * self.scale) @ _operand(k).transpose(-2, -1)
        bias = self.relative_position_bias_table[
            self.relative_position_index.view(-1)].view(n, n, -1)
        attn = attn + bias.permute(2, 0, 1).contiguous().unsqueeze(0)
        if mask is not None:
            nw = mask.shape[0]
            attn = attn.view(bn // nw, nw, self.num_heads, n, n) + (
                mask.unsqueeze(1).unsqueeze(0))
            attn = attn.view(-1, self.num_heads, n, n)
        attn = torch.softmax(attn, dim=-1)
        out = (_operand(attn) @ _operand(v)).transpose(1, 2).reshape(bn, n, c)
        return self.proj(out)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int, compute_dtype: torch.dtype):
        super().__init__()
        self.fc1 = Linear(dim, hidden, compute_dtype=compute_dtype)
        self.fc2 = Linear(hidden, dim, compute_dtype=compute_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))


class SwinTransformerBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, window: int, shift: int,
                 mlp_ratio: int, compute_dtype: torch.dtype):
        super().__init__()
        self.window, self.shift = window, shift
        self.norm1 = LayerNorm(dim, compute_dtype)
        self.attn = WindowAttention(dim, window, num_heads, compute_dtype)
        self.norm2 = LayerNorm(dim, compute_dtype)
        self.mlp = Mlp(dim, dim * mlp_ratio, compute_dtype)

    def forward(self, x: torch.Tensor, h: int, w: int, mask_matrix):
        b, length, c = x.shape
        ws, s = self.window, self.shift
        shortcut = x
        x = self.norm1(x).view(b, h, w, c)
        pad_r, pad_b = (ws - w % ws) % ws, (ws - h % ws) % ws
        x = F.pad(x, (0, 0, 0, pad_r, 0, pad_b))
        hp, wp = x.shape[1], x.shape[2]
        if s > 0:
            x = torch.roll(x, shifts=(-s, -s), dims=(1, 2))
            mask = mask_matrix
        else:
            mask = None
        windows = window_partition(x, ws).view(-1, ws * ws, c)
        windows = self.attn(windows, mask=mask).view(-1, ws, ws, c)
        x = window_reverse(windows, ws, hp, wp)
        if s > 0:
            x = torch.roll(x, shifts=(s, s), dims=(1, 2))
        x = x[:, :h, :w, :].contiguous().view(b, h * w, c)
        x = shortcut + x.to(shortcut.dtype)
        return x + self.mlp(self.norm2(x)).to(x.dtype)


class PatchMerging(nn.Module):
    def __init__(self, dim: int, compute_dtype: torch.dtype):
        super().__init__()
        self.norm = LayerNorm(4 * dim, compute_dtype)
        self.reduction = Linear(4 * dim, 2 * dim, bias=False,
                                compute_dtype=compute_dtype)

    def forward(self, x: torch.Tensor, h: int, w: int) -> torch.Tensor:
        b, length, c = x.shape
        x = x.view(b, h, w, c)
        if h % 2 == 1 or w % 2 == 1:
            x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2))
        x0 = x[:, 0::2, 0::2, :]
        x1 = x[:, 1::2, 0::2, :]
        x2 = x[:, 0::2, 1::2, :]
        x3 = x[:, 1::2, 1::2, :]
        x = torch.cat([x0, x1, x2, x3], -1).view(b, -1, 4 * c)
        return self.reduction(self.norm(x))


class BasicLayer(nn.Module):
    """A stage: its blocks (the shift mask built once a call for the
    padded map, as published), then the patch merging."""

    def __init__(self, dim: int, depth: int, num_heads: int, window: int,
                 mlp_ratio: int, downsample: bool, compute_dtype: torch.dtype):
        super().__init__()
        self.window, self.shift = window, window // 2
        self.blocks = nn.ModuleList([
            SwinTransformerBlock(dim, num_heads, window,
                                 0 if i % 2 == 0 else window // 2, mlp_ratio,
                                 compute_dtype) for i in range(depth)])
        self.downsample = (PatchMerging(dim, compute_dtype) if downsample
                           else None)

    def attn_mask(self, h: int, w: int, device) -> torch.Tensor:
        """``[nW, N, N]``: -100 between tokens of different regions of the
        rolled, padded ``h x w`` map, 0 within one."""
        ws, s = self.window, self.shift
        hp = int(math.ceil(h / ws)) * ws
        wp = int(math.ceil(w / ws)) * ws
        img_mask = torch.zeros((1, hp, wp, 1), device=device)
        slices = (slice(0, -ws), slice(-ws, -s), slice(-s, None))
        cnt = 0
        for hs in slices:
            for wsl in slices:
                img_mask[:, hs, wsl, :] = cnt
                cnt += 1
        mask_windows = window_partition(img_mask, ws).view(-1, ws * ws)
        attn_mask = mask_windows.unsqueeze(1) - mask_windows.unsqueeze(2)
        return attn_mask.masked_fill(attn_mask != 0, float(-100.0)
                                     ).masked_fill(attn_mask == 0, 0.0)

    def forward(self, x: torch.Tensor, h: int, w: int):
        attn_mask = self.attn_mask(h, w, x.device)
        for blk in self.blocks:
            x = blk(x, h, w, attn_mask)
        if self.downsample is None:
            return x, h, w, x, h, w
        return x, h, w, self.downsample(x, h, w), (h + 1) // 2, (w + 1) // 2


class PatchEmbed(nn.Module):
    def __init__(self, patch: int, dim: int, compute_dtype: torch.dtype):
        super().__init__()
        self.patch = patch
        self.proj = Conv(3, dim, patch, patch, compute_dtype=compute_dtype)
        self.norm = LayerNorm(dim, compute_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        _, _, h, w = x.size()
        p = self.patch
        if w % p != 0:
            x = F.pad(x, (0, p - w % p))
        if h % p != 0:
            x = F.pad(x, (0, 0, 0, p - h % p))
        x = self.proj(x)
        wh, ww = x.size(2), x.size(3)
        x = self.norm(x.flatten(2).transpose(1, 2))
        return x.transpose(1, 2).reshape(-1, x.shape[-1], wh, ww)


class SwinFeatureExtraction(nn.Module):
    """``[B, 3, H, W]`` -> ``(C2, C3, C4, C5)`` NCHW, widths
    ``embed_dim * 2^i`` (``out_channels``)."""

    def __init__(self, embed_dim: int = 96, depths=(2, 2, 6, 2),
                 num_heads=(3, 6, 12, 24), window: int = 7,
                 mlp_ratio: int = 4, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.patch_embed = PatchEmbed(4, embed_dim, dtype)
        dims = [embed_dim * 2 ** i for i in range(len(depths))]
        self.layers = nn.ModuleList([
            BasicLayer(dims[i], depths[i], num_heads[i], window, mlp_ratio,
                       i < len(depths) - 1, dtype)
            for i in range(len(depths))])
        for i, d in enumerate(dims):
            self.add_module(f"norm{i}", LayerNorm(d, dtype))
        self.out_channels = tuple(dims)

    def forward(self, x: torch.Tensor, generator=None):
        x = self.patch_embed(x)
        wh, ww = x.size(2), x.size(3)
        x = x.flatten(2).transpose(1, 2)
        outs = []
        for i, layer in enumerate(self.layers):
            x_out, h, w, x, wh, ww = layer(x, wh, ww)
            out = getattr(self, f"norm{i}")(x_out)
            outs.append(out.view(-1, h, w, self.out_channels[i])
                        .permute(0, 3, 1, 2).contiguous())
        return tuple(outs)


SWIN_T = dict(embed_dim=96, depths=(2, 2, 6, 2), num_heads=(3, 6, 12, 24),
              window=7, mlp_ratio=4)


def init_swin(trunk: nn.Module, seed: int) -> None:
    """The trunk's parameters from one ``torch.Generator`` on their device
    seeded with ``seed``, in module order: linear weights and bias tables
    normal with std 0.02 (truncated at +-2), biases 0, LayerNorm 1 and 0,
    the patch convolution lecun-normal (truncated at +-2 std)."""
    dev = trunk.patch_embed.proj.weight.device
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    with torch.no_grad():
        for m in trunk.modules():
            if isinstance(m, Linear):
                nn.init.trunc_normal_(m.weight, 0.0, 0.02, -2.0, 2.0,
                                      generator=gen)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, WindowAttention):
                nn.init.trunc_normal_(m.relative_position_bias_table, 0.0,
                                      0.02, -2.0, 2.0, generator=gen)
            elif isinstance(m, LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
            elif isinstance(m, Conv):
                std = lecun_std(m.weight)
                nn.init.trunc_normal_(m.weight, 0.0, std, -2 * std, 2 * std,
                                      generator=gen)
                m.bias.zero_()
