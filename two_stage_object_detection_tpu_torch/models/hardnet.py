"""HarDNet feature extractors (NCHW torch modules).

The counterparts of the JAX package's ``models/hardnet.py``: HarDNet-39/68/85
with harmonic dense blocks, the reference layout (a depth-wise "downsample"
at stride 1 and a stride-2+2 tail, which gives a stride-16 512-channel map:
600x600 -> 38x38x512) and the strided ``s`` variants (true stride-2 downs,
a stride-1 tail, and optional FPN taps at strides 4/8/16/32).

Numerics follow flax: explicit symmetric ``k // 2`` padding, batch norm
with ``eps=1e-5`` (batch statistics in train mode, running ones in eval
mode), ReLU6 after each ``ConvLayer``.  The tail is
two depth-wise 3x3 convs **with bias** and no batch norm (a ReLU between
them) and a grouped 1x1 conv (``groups=512``) to 512 channels.  Submodules
carry the flax names (``stem0..2``, ``block{i}.layer{t}.layer1/.layer2``,
``transition{i}``, ``down{i}``, ``tail0..2``, ``pyr_down``; ``conv``,
``dwconv``, ``norm``), so ``utils/jax_weights.py`` maps them by rule.

Train mode is the module's own (``.train()`` / ``.eval()``).  ``remat``
recomputes each ``HarDBlock`` in the backward pass instead of keeping its
layers' activations (``torch.utils.checkpoint``); arch 85 drops 10% of its
last block's output in train mode, from an explicit generator.  Every
operation that reads across rows is a :class:`~.layers.Conv` (the
depth-wise stride-2 downs and the tail included), so the row shards of
``parallel/spatial.py`` need nothing else here but the dropout's mask.  Only the
depth-wise form (``depth_wise=True``) is built: it is the only one the
backbone registry of either package constructs.

Predict on the card takes the folded route (``layers.fold_route``): each
layer's batch norm folded into its conv, one epilogue of bias and ReLU6 a
``ConvLayer``, and each depth-wise layer's bias deferred into the 1x1 convs
that alone read its output (the layers' ``_folded`` methods, which
:meth:`HarDNetFeatureExtraction.forward` calls in place of the layers).
Outside a row shard the folded route is the store route: each depth-wise
layer's conv stores its output into every buffer that reads it, a dense
block's multi-link layer inputs and its output among them
(``ops/depthwise_store.py``), so no concatenation is copied.  A row shard
keeps ``torch.cat``: its depth-wise convs read a halo that
:meth:`~.layers.Conv.forward` exchanges.  ``counters["hardnet.cat"]``
counts the copies a block still makes to build a concatenation: each
``torch.cat``, and on the store route each slice copy of a block input
that a transition, not a depth-wise layer, made (none in HarDNet-39).
"""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from two_stage_object_detection_tpu_torch.models.layers import (
    BatchNorm, Conv, cached_fold, epilogue, fold_norm, fold_route,
    fold_sources, frozen_running_stats, through_1x1)
from two_stage_object_detection_tpu_torch.ops.depthwise_store import (
    depthwise_store, out_size)
from two_stage_object_detection_tpu_torch.parallel import spatial
from two_stage_object_detection_tpu_torch.utils.profiling import counters


def relu6(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x, 0.0, 6.0)


class ConvLayer(nn.Module):
    """Conv (no bias) + BN + ReLU6."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int = 3,
                 stride: int = 1, dtype=torch.float32):
        super().__init__()
        self.conv = Conv(in_ch, out_ch, kernel, stride, kernel // 2, bias=False,
                         compute_dtype=dtype)
        self.norm = BatchNorm(out_ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return relu6(self.norm(self.conv(x)))

    def _fold(self, pending=None):
        """Folded ``(w', b')``: ``w'`` in the compute dtype, ``b'`` float32,
        taking in ``pending``, a per-channel bias the input carries (a
        1x1 layer only: :func:`~.layers.through_1x1`)."""
        w, b = fold_norm(self.conv, self.norm)
        if pending is not None:
            if w.shape[2:] != (1, 1) or self.conv.padding:
                raise ValueError("a pending bias passes through an unpadded "
                                 "1x1 conv only")
            b = through_1x1(w, b, pending)
        return w.to(self.conv.compute_dtype), b

    def _run_folded(self, x, params):
        w, b = params
        counters["fold.folded"] += 1
        return epilogue(self.conv.forward(x, w), b, act="relu6")

    def _folded(self, x, pending=None):
        """The folded route: the conv with the folded weight, then bias and
        ReLU6 in one epilogue; ``pending`` as in :meth:`_fold`."""
        params = cached_fold(
            self, fold_sources(self.conv, self.norm, pending=pending),
            lambda: self._fold(pending))
        return self._run_folded(x, params)


class DWConvLayer(nn.Module):
    """Depth-wise 3x3 conv (no bias) + BN, no activation."""

    def __init__(self, channels: int, stride: int = 1, dtype=torch.float32):
        super().__init__()
        self.dwconv = Conv(channels, channels, 3, stride, 1, groups=channels,
                           bias=False, compute_dtype=dtype)
        self.norm = BatchNorm(channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm(self.dwconv(x))

    def _fold(self):
        w, b = fold_norm(self.dwconv, self.norm)
        return w.to(self.dwconv.compute_dtype), b

    def _run_folded(self, x, params, defer, into=None):
        w, b = params
        counters["fold.folded"] += 1
        if into is not None:
            depthwise_store(x.to(self.dwconv.compute_dtype), w,
                            self.dwconv.stride, None if defer else b, into)
            return None, (b if defer else None)
        y = self.dwconv.forward(x, w)
        return (y, b) if defer else (epilogue(y, b), None)

    def _folded(self, x, defer=False, into=None):
        """The folded route -> ``(y, pending)``.  With ``defer`` the bias is
        not added but returned as ``pending`` (float32 ``[C]``), for the
        unpadded 1x1 convs that alone consume ``y`` to take in
        (:func:`~.layers.through_1x1`), and this layer makes no pass of its
        own; else one epilogue adds it and ``pending`` is None.  With
        ``into``, a list of ``(channels-last buffer, channel offset)``, the
        store route: the conv (and the bias, unless deferred) is stored into
        each (:func:`~..ops.depthwise_store.depthwise_store`), one launch and
        no epilogue, and ``y`` is None."""
        params = cached_fold(self, fold_sources(self.dwconv, self.norm),
                             self._fold)
        return self._run_folded(x, params, defer, into)


class CombConvLayer(nn.Module):
    """1x1 ``ConvLayer`` followed by a depth-wise 3x3."""

    def __init__(self, in_ch: int, out_ch: int, stride: int = 1,
                 dtype=torch.float32):
        super().__init__()
        self.layer1 = ConvLayer(in_ch, out_ch, kernel=1, dtype=dtype)
        self.layer2 = DWConvLayer(out_ch, stride=stride, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.layer2(self.layer1(x))

    def _fold(self, pending=None):
        return self.layer1._fold(pending), self.layer2._fold()

    def _run_folded(self, x, params, into=None):
        """The folded route on :meth:`_fold`'s ``params`` -> ``(y,
        pending)``, the depth-wise layer's bias deferred; ``into`` as
        :meth:`DWConvLayer._folded`'s."""
        return self.layer2._run_folded(
            self.layer1._run_folded(x, params[0]), params[1], defer=True,
            into=into)


def hard_block_links(n_layers: int, base_ch: int, growth_rate: int,
                     grmul: float) -> Tuple[List[int], List[int], List[List[int]], int]:
    """Static link topology of a harmonic dense block.

    Layer ``t`` (1-indexed) consumes the concatenation of layers ``t - 2**i``
    for every ``i`` with ``t % 2**i == 0`` (layer 0 = block input); its width
    is ``growth_rate * grmul**(k-1)`` (``k`` links) rounded up to even.

    Returns ``(out_chs, in_chs, links, block_out_ch)``: ``out_chs[t]`` is the
    width of layer ``t`` (``out_chs[0] = base_ch``), ``links[t-1]`` the
    producers of layer ``t``, and ``block_out_ch`` the width of the block's
    concatenated output (without the base).
    """
    out_chs = [base_ch]
    in_chs = []
    links: List[List[int]] = []
    block_out = 0
    for t in range(1, n_layers + 1):
        link = []
        ch = float(growth_rate)
        for i in range(10):
            dv = 2 ** i
            if t % dv == 0:
                link.append(t - dv)
                if i > 0:
                    ch *= grmul
        ch = int(int(ch + 1) / 2) * 2
        out_chs.append(ch)
        in_chs.append(sum(out_chs[j] for j in link))
        links.append(link)
        if (t - 1) % 2 == 0 or t == n_layers:
            block_out += ch
    return out_chs, in_chs, links, block_out


class HarDBlock(nn.Module):
    """Harmonic dense block of ``CombConvLayer``s (``layer0..``).

    The output concatenates, in order, the base (with ``keep_base``), every
    odd layer and the last layer, along channels.
    """

    def __init__(self, in_channels: int, growth_rate: int, grmul: float,
                 n_layers: int, keep_base: bool = False, dtype=torch.float32):
        super().__init__()
        self.out_chs, in_chs, self.links, block_out = hard_block_links(
            n_layers, in_channels, growth_rate, grmul)
        self.keep_base = keep_base
        self.out_channels = block_out + (in_channels if keep_base else 0)
        for t in range(1, n_layers + 1):
            self.add_module(f"layer{t - 1}", CombConvLayer(
                in_chs[t - 1], self.out_chs[t], dtype=dtype))
        self.stores = self._store_table()

    def _keep(self, n: int) -> List[int]:
        return [i for i in range(n)
                if (i == 0 and self.keep_base) or i == n - 1 or i % 2 == 1]

    def _store_table(self):
        """The store route's static table of where each output goes, the
        outputs numbered as ``links`` numbers them (0 the block's input):
        ``(buffers, dests, alone)``.  ``buffers`` is ``{key: (channels,
        first source)}``: the input of each layer of more than one link
        (key ``t``, its index in ``links``) and the block's output (key
        ``"out"``), each in the channel order ``torch.cat`` builds
        (``links[t]``, then :meth:`_keep`); ``dests[j]`` is output ``j``'s
        ``[(key, channel offset)]``; ``alone[j]`` whether a layer takes
        output ``j`` alone, as a tensor of its own."""
        n = len(self.links) + 1
        parts = {t: link for t, link in enumerate(self.links) if len(link) > 1}
        parts["out"] = self._keep(n)
        buffers, dests = {}, [[] for _ in range(n)]
        for key, idx in parts.items():
            off = 0
            for j in idx:
                dests[j].append((key, off))
                off += self.out_chs[j]
            buffers[key] = (off, min(idx))
        return buffers, dests, [[j] in self.links for j in range(n)]

    def _run(self, x: torch.Tensor, layer) -> torch.Tensor:
        """``layer(t, input)`` gives layer ``t``'s output."""
        outputs = [x]
        for t, link in enumerate(self.links):
            tin = [outputs[j] for j in link]
            inp = _cat(tin) if len(tin) > 1 else tin[0]
            outputs.append(layer(t, inp))
        return _cat([outputs[i] for i in self._keep(len(outputs))])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._run(x, lambda t, inp: getattr(self, f"layer{t}")(inp))

    def _pending(self, pend, idx):
        """The pending bias of the concatenation of outputs ``idx``, zeros
        for those that carry none; None if none does."""
        parts = [pend[j] for j in idx]
        like = next((p for p in parts if p is not None), None)
        if like is None:
            return None
        return torch.cat([like.new_zeros(self.out_chs[j]) if p is None else p
                          for j, p in zip(idx, parts)])

    def _fold(self, pending):
        """Each layer's folded parameters, every depth-wise bias deferred to
        the 1x1 layers and the transition that consume it, and the pending
        bias of the block's output; ``pending`` is the input's."""
        pend, layers = [pending], []
        for t, link in enumerate(self.links):
            params = getattr(self, f"layer{t}")._fold(
                self._pending(pend, link))
            layers.append(params)
            pend.append(params[1][1])
        return layers, self._pending(pend, self._keep(len(pend)))

    def _folded_params(self, pending):
        mods = [m for c in self.children() for m in (
            c.layer1.conv, c.layer1.norm, c.layer2.dwconv, c.layer2.norm)]
        return cached_fold(self, fold_sources(*mods, pending=pending),
                           lambda: self._fold(pending))

    def _folded(self, x, pending=None):
        """The folded route -> ``(y, pending)``: one epilogue a layer (its
        1x1 conv's bias and ReLU6), none for the depth-wise convs, whose
        biases reach the output's ``pending``."""
        layers, out = self._folded_params(pending)
        y = self._run(x, lambda t, inp: getattr(self, f"layer{t}")
                      ._run_folded(inp, layers[t])[0])
        return y, out

    def _assembled(self, asm: "_Assembly", pending=None):
        """The store route -> ``(y, pending)``: the folded route with each
        layer's depth-wise conv storing its output into the buffers of
        ``asm`` that read it, so that each layer's input and the block's
        output are assembled with no copy; ``asm`` holds output 0."""
        layers, out = self._folded_params(pending)
        for t in range(len(self.links)):
            getattr(self, f"layer{t}")._run_folded(asm.take(t), layers[t],
                                                   into=asm.into(t + 1))
        return asm.result(), out


def _cat(parts: List[torch.Tensor]) -> torch.Tensor:
    counters["hardnet.cat"] += 1
    return torch.cat(parts, dim=1)


class _Assembly:
    """One call of a :class:`HarDBlock` on the store route: its buffers
    (:meth:`HarDBlock._store_table`), each allocated channels-last before
    its first producer runs and handed to its consumer once."""

    def __init__(self, block: HarDBlock, n: int, h: int, w: int, dtype,
                 device):
        self.block, self.size, self.dtype, self.device = (
            block, (n, h, w), dtype, device)
        self.bufs = {}

    def _empty(self, c: int) -> torch.Tensor:
        n, h, w = self.size
        return torch.empty((n, c, h, w), dtype=self.dtype, device=self.device,
                           memory_format=torch.channels_last)

    def into(self, j: int, alone: bool = True) -> list:
        """Output ``j``'s destinations ``[(buffer, channel offset)]``: the
        buffers whose first source it is are allocated now, and, with
        ``alone``, the tensor of its own a layer takes."""
        buffers, dests, takers = self.block.stores
        for key, (c, first) in buffers.items():
            if first == j:
                self.bufs[key] = self._empty(c)
        out = [(self.bufs[key], off) for key, off in dests[j]]
        if alone and takers[j]:
            own = self.bufs[("alone", j)] = self._empty(self.block.out_chs[j])
            out.append((own, 0))
        return out

    def put(self, j: int, y: torch.Tensor) -> None:
        """Output ``j`` as a tensor no depth-wise layer stored (a block's
        input that a transition made): copied into the slice of each buffer
        that reads it, each copy counted in ``hardnet.cat``, and taken alone
        as it is."""
        for buf, off in self.into(j, alone=False):
            counters["hardnet.cat"] += 1
            buf[:, off:off + y.shape[1]].copy_(y)
        self.bufs[("alone", j)] = y

    def take(self, t: int) -> torch.Tensor:
        """Layer ``t``'s input (``links[t]``), handed over once."""
        link = self.block.links[t]
        return self.bufs.pop(t if len(link) > 1 else ("alone", link[0]))

    def result(self) -> torch.Tensor:
        """The block's output."""
        return self.bufs.pop("out")


_ARCH = {
    # arch: (first_ch, ch_list, grmul, gr, n_layers, down_samp)
    39: ((24, 48), (96, 320, 640, 1024), 1.6, (16, 20, 64, 160),
         (4, 16, 8, 4), (1, 1, 1, 0)),
    68: ((32, 64), (128, 256, 320, 640, 1024), 1.7, (14, 16, 20, 40, 160),
         (8, 16, 16, 16, 4), (1, 0, 1, 1, 0)),
    85: ((48, 96), (192, 256, 320, 480, 720, 1024), 1.7, (24, 24, 28, 36, 48, 256),
         (8, 16, 16, 16, 16, 4), (1, 0, 1, 0, 1, 0)),
}


class HarDNetFeatureExtraction(nn.Module):
    """HarDNet backbone ending in a 512-channel stride-16 map.

    stem (3x3 conv s2, 1x1 conv, depth-wise s2) -> HarDBlocks, each followed
    by a 1x1 transition and, where the arch says so, a depth-wise "down"
    layer -> tail (two depth-wise 3x3 convs with bias, a grouped 1x1 conv
    to 512 channels).

    ``strided=True`` makes the first two downs stride 2 and the tail stride
    1; ``pyramid=True`` (strided only) returns the taps ``(C2, C3, C4, C5)``
    at strides 4/8/16/32, C5 being one more depth-wise stride-2 step
    (``pyr_down``).  ``remat=True`` rematerialises every block in the
    backward pass.  Input and outputs are NCHW.
    """

    DROPOUT = 0.1       # arch 85, after its last block, train mode only

    def __init__(self, arch: int = 39, dtype=torch.float32,
                 strided: bool = False, pyramid: bool = False,
                 remat: bool = False):
        super().__init__()
        if pyramid and not strided:
            raise ValueError("pyramid taps require the strided variant")
        first_ch, ch_list, grmul, gr, n_layers, down_samp = _ARCH[arch]
        self.arch, self.strided, self.pyramid = arch, strided, pyramid
        self.remat = remat
        self.stem0 = ConvLayer(3, first_ch[0], 3, 2, dtype)
        self.stem1 = ConvLayer(first_ch[0], first_ch[1], 1, dtype=dtype)
        self.stem2 = DWConvLayer(first_ch[1], 2, dtype)

        ch = first_ch[1]
        self.n_blocks = len(n_layers)
        self.tap_after = []          # block indices whose output is a tap
        for i in range(self.n_blocks):
            blk = HarDBlock(ch, gr[i], grmul, n_layers[i], dtype=dtype)
            self.add_module(f"block{i}", blk)
            self.add_module(f"transition{i}", ConvLayer(
                blk.out_channels, ch_list[i], 1, dtype=dtype))
            ch = ch_list[i]
            if down_samp[i] == 1:
                stride = 1
                if strided and len(self.tap_after) < 2:
                    self.tap_after.append(i)
                    stride = 2
                self.add_module(f"down{i}", DWConvLayer(ch, stride, dtype))

        c_last = ch_list[-1]
        s = 1 if strided else 2
        self.tail0 = Conv(c_last, c_last, 3, s, 1, groups=c_last,
                          compute_dtype=dtype)
        self.tail1 = Conv(c_last, c_last, 3, s, 1, groups=c_last,
                          compute_dtype=dtype)
        self.tail2 = Conv(c_last, 512, 1, groups=512, compute_dtype=dtype)
        if pyramid:
            self.pyr_down = DWConvLayer(512, 2, dtype)
            self.out_channels = (*(ch_list[i] for i in self.tap_after), 512, 512)
        else:
            self.out_channels = 512
        # built in eval mode, as the flax module defaults to ``train=False``
        self.eval()

    def _block(self, i: int, x: torch.Tensor) -> torch.Tensor:
        blk = getattr(self, f"block{i}")
        if not (self.remat and torch.is_grad_enabled()):
            return blk(x)
        calls = []
        shard = spatial.current()

        def run(inp):
            # the backward pass calls this a second time: same values, and
            # the running statistics have already moved; on a row shard the
            # second call runs on the shard too (its halo exchanges again)
            calls.append(None)
            with spatial.sharded(shard):
                if len(calls) == 1:
                    return blk(inp)
                with frozen_running_stats(blk):
                    return blk(inp)

        return checkpoint(run, x, use_reentrant=False)

    def _dropout(self, x: torch.Tensor, generator) -> torch.Tensor:
        """Arch 85's train-mode dropout.  On a row shard the mask is drawn
        from ``generator`` for the whole map and the shard keeps its rows
        of it, so the shards of one image (whose train steps draw from
        equal generators) apply the unsharded mask; without a generator
        the shards could not agree on one, and it raises."""
        shard = spatial.current()
        if shard is None and generator is None:
            u = torch.rand_like(x, dtype=torch.float32)
        elif generator is None:
            raise ValueError("HarDNet-85's train-mode dropout on row shards "
                             "needs a generator: each shard keeps its rows "
                             "of one mask drawn for the whole image")
        else:
            shape = x.shape if shard is None else (
                *x.shape[:2], shard.edges(x)[-1], x.shape[3])
            u = torch.rand(shape, generator=generator,
                           device=generator.device).to(x.device)
            if shard is not None:
                u = shard.own_rows(u, x)
        return x * (u >= self.DROPOUT).to(x.dtype) / (1.0 - self.DROPOUT)

    def _feed(self, layer: DWConvLayer, x: torch.Tensor, block, store):
        """A depth-wise layer on the folded route -> ``(y, pending, asm)``.
        If its output is ``block``'s input (None: no block's), it leaves its
        bias ``pending`` for the block's 1x1 convs to take in; else it adds
        it.  On the store route (``store``) it stores its output into
        ``asm``, the block's buffers, and ``y`` is None; or, feeding no
        block, into ``y``, a tensor of its own."""
        if not store:
            return (*layer._folded(x, defer=block is not None), None)
        n, _, h, w = x.shape
        conv = layer.dwconv
        ho, wo = out_size(h, w, conv.stride)
        if block is None:
            y = torch.empty((n, conv.weight.shape[0], ho, wo),
                            dtype=conv.compute_dtype, device=x.device,
                            memory_format=torch.channels_last)
            return y, layer._folded(x, into=[(y, 0)])[1], None
        asm = _Assembly(block, n, ho, wo, conv.compute_dtype, x.device)
        return None, layer._folded(x, defer=True, into=asm.into(0))[1], asm

    def forward(self, x: torch.Tensor, generator: torch.Generator = None):
        """On the folded route (``layers.fold_route``) each layer runs its
        ``_folded``: a depth-wise layer whose output feeds only 1x1 convs
        (the stem's, the blocks', and each down followed by a block) leaves
        its bias ``pending`` for them to take in; a down before the tail
        and ``pyr_down`` add theirs.  Outside a row shard it is the store
        route (:meth:`_feed`, :meth:`HarDBlock._assembled`)."""
        fold = fold_route(self, x)
        store = fold and spatial.current() is None
        asm = None
        if fold:
            x = self.stem1._folded(self.stem0._folded(x))
            x, pending, asm = self._feed(self.stem2, x, self.block0, store)
        else:
            x, pending = self.stem2(self.stem1(self.stem0(x))), None
        taps = []
        for i in range(self.n_blocks):
            blk = getattr(self, f"block{i}")
            if store:
                if asm is None:             # the block's input: a transition
                    asm = _Assembly(blk, x.shape[0], x.shape[2], x.shape[3],
                                    x.dtype, x.device)
                    asm.put(0, x)
                x, pending = blk._assembled(asm, pending)
            elif fold:
                x, pending = blk._folded(x, pending)
            else:
                x = self._block(i, x)
            if i == self.n_blocks - 1 and self.arch == 85 and self.training:
                x = self._dropout(x, generator)
            transition = getattr(self, f"transition{i}")
            x = transition._folded(x, pending) if fold else transition(x)
            pending = None                      # the transition took it in
            if i in self.tap_after:
                taps.append(x)
            asm = None
            if hasattr(self, f"down{i}"):
                down = getattr(self, f"down{i}")
                x, pending, asm = (
                    self._feed(down, x, getattr(self, f"block{i + 1}", None),
                               store)
                    if fold else (down(x), None, None))
        x = self.tail2(self.tail1(F.relu(self.tail0(x))))
        if self.pyramid:
            c5 = (self._feed(self.pyr_down, x, None, store)[0] if fold
                  else self.pyr_down(x))
            return (*taps, x, c5)
        return x


class GlobalAvgPoolClassifier(nn.Module):
    """Global average pool + flatten (reference ``HarNetClassifier``,
    ``models/hardnet.py:203-212``): ``[N, P, P, C] -> [N, C]``, the JAX
    package's channels-last layout."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x.mean(dim=(-3, -2))
