"""Image rows over the mesh's model axis: halo exchanges and the row gather.

The JAX package shards image height over ``model`` with a
``PartitionSpec("data", "model")`` and lets XLA's SPMD partitioner insert
the halo exchanges (``parallel/mesh.py:shard_batch_spatial``).  The port
has no partitioner, so this module does that job by hand, for the layers
that read rows across a shard edge:

* **Row ownership.**  The input image's rows are split in equal blocks,
  one a shard (:func:`split_rows`).  Every layer of the backbone and neck
  is a window of odd size ``k`` with padding ``k // 2`` and stride 1 or 2,
  so output row ``i`` is centred on input row ``i * s``, and the shard
  that owns that input row owns the output row.  At cumulative stride
  ``S`` a shard whose image rows are ``[a, b)`` then owns ``[ceil(a / S),
  ceil(b / S))`` of a map ``ceil(H / S)`` rows high: uneven from the first
  odd height on (600 rows over 4 shards are 38, 37, 38 and 37 rows at
  stride 4), and empty where a shard's block holds no centre (a 64-pixel
  image's 2-row C5 over 4 shards).  A :class:`Shard` keeps that table for
  every stride up to :data:`MAX_STRIDE` and finds a tensor's level by its
  width, which is never split.
* **The halo exchange** (:class:`_Halo`).  Before a window that reads rows
  across an edge, every shard sends its first and its last ``T`` rows
  (``T`` the deepest halo any shard of the layer needs, zero-padded) and
  gathers everyone's; each shard picks the rows it needs from their
  owners, from the neighbour's neighbour where a neighbour is thinner than
  the halo.  Only the image's real top and bottom are padded, with zeros
  for a convolution and -inf for the max pool.  The backward is the
  adjoint: each shard scatters the gradient of the rows it received into a
  buffer laid out as the gathered one, the buffers are summed over the
  shards, and each owner adds its own block.
* **The gather** (:meth:`Shard.gather`).  After the neck (or the
  single-scale backbone) the rows of each map come together, so the RPN,
  the proposals and the box head run on the whole maps.  Over a process
  group every shard all-gathers them (:class:`_GatherRows`) and runs the
  heads, as a model rank in training must; the backward sums the full
  gradient over the shards (a reduce-scatter through an all-reduce, which
  gloo has) and keeps its own rows.  Over a :class:`ThreadGroup` the
  lead shard (index 0) alone concatenates them and the others get None:
  one process serves one answer a data index, and its threads share one
  interpreter, so running the heads on every thread would only repeat
  them.

Two transports carry the collectives: :class:`GroupTransport`, a process
group (the model group of a :class:`~.mesh.Mesh` over processes, through
:mod:`.multiprocess`, for ``train``), and :class:`ThreadGroup`, the worker
threads of one process, one a device of a mesh within the process (for
``Predictor(spatial=True)``; its backward runs on the CPU, where each
thread's backward runs on that thread).

A layer takes the sharded route while a shard is active on its thread
(:func:`sharded`); :func:`current` is None otherwise and every layer runs
as before.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

# the deepest stride of a map the backbone and neck produce (the FPN's P6)
MAX_STRIDE = 64
# seconds a ThreadGroup worker waits at the barrier for the others
BARRIER_TIMEOUT = 300.0

_local = threading.local()


def current() -> Optional["Shard"]:
    """The shard active on this thread, or None."""
    return getattr(_local, "shard", None)


@contextlib.contextmanager
def sharded(shard: Optional["Shard"]):
    """Run the layers called inside on ``shard``'s rows (None: unsharded)."""
    prev = current()
    _local.shard = shard
    try:
        yield shard
    finally:
        _local.shard = prev


def split_rows(height: int, n: int) -> Tuple[int, ...]:
    """The row edges of ``height`` image rows over ``n`` shards: equal
    blocks, as the JAX package's ``P("data", "model")`` splits them (its
    placement needs the height to divide)."""
    if height % n:
        raise ValueError(f"{height} image rows do not divide over a model "
                         f"axis of {n}")
    return tuple(i * height // n for i in range(n + 1))


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


# ---------------------------------------------------------------- transports
class GroupTransport:
    """The shards are the ranks of a process group (one device each)."""

    def __init__(self, group):
        from two_stage_object_detection_tpu_torch.parallel.multiprocess import (
            rank, world_size)
        self.group = group
        self.size, self.index = world_size(group), rank(group)

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        from two_stage_object_detection_tpu_torch.parallel.multiprocess import (
            all_gather)
        return all_gather(t, self.group)

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        from two_stage_object_detection_tpu_torch.parallel.multiprocess import (
            all_reduce_)
        return all_reduce_(t, "sum", self.group)

    def gather_rows(self, shard: "Shard", maps) -> Tuple[torch.Tensor, ...]:
        """The whole maps on every rank (:class:`_GatherRows`)."""
        return _GatherRows.apply(shard, *maps)


class ThreadGroup:
    """``size`` worker threads of one process, one shard each: a board of
    slots behind a barrier.  Each thread talks through its own
    :meth:`transport`.  A thread that waits longer than
    :data:`BARRIER_TIMEOUT` seconds for the others breaks the barrier
    (``threading.BrokenBarrierError`` in every thread) instead of hanging."""

    def __init__(self, size: int):
        self.size = size
        self._slots: List = [None] * size
        self._done: List = [None] * size
        self._barrier = threading.Barrier(size, timeout=BARRIER_TIMEOUT)

    def transport(self, index: int) -> "ThreadTransport":
        return ThreadTransport(self, index)

    def abort(self) -> None:
        """Release the threads waiting at the barrier (a worker failed)."""
        self._barrier.abort()


class ThreadTransport:
    """One worker's end of a :class:`ThreadGroup`."""

    def __init__(self, group: ThreadGroup, index: int):
        self.group, self.size, self.index = group, group.size, index

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every worker's ``t``, stacked in index order on ``t``'s device.
        A CUDA producer records an event after ``t``; the consumer's stream
        waits for it before the copy, and the producer's stream waits for
        every consumer's copies before it goes on, so no tensor's memory is
        reused while another stream still reads it."""
        g, i = self.group, self.index
        stream = torch.cuda.current_stream(t.device) if t.is_cuda else None
        g._slots[i] = (t, None if stream is None else stream.record_event())
        g._barrier.wait()
        parts = []
        for j, (u, ev) in enumerate(g._slots):
            if j == i:
                parts.append(u)
                continue
            if ev is not None and stream is not None:
                stream.wait_event(ev)
            parts.append(u.to(t.device, copy=True))
        out = torch.stack(parts)
        g._done[i] = None if stream is None else stream.record_event()
        g._barrier.wait()
        if stream is not None:
            for j, ev in enumerate(g._done):
                if j != i and ev is not None:
                    stream.wait_event(ev)
        return out

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """The sum over the workers in index order (the same bits on
        each), into ``t``."""
        return t.copy_(self.all_gather(t).sum(0))

    def gather_rows(self, shard: "Shard",
                    maps) -> Optional[Tuple[torch.Tensor, ...]]:
        """Every worker's rows of each of ``maps`` concatenated on the lead
        worker (index 0), which gets the whole maps; the others get None.
        It serves inference: no gradient flows through it.  As in
        :meth:`all_gather`, the lead waits for each producer's event before
        it copies, and the producers wait for the lead's copies before they
        go on."""
        g, i = self.group, self.index
        dev = maps[0].device
        stream = torch.cuda.current_stream(dev) if maps[0].is_cuda else None
        g._slots[i] = (tuple(m.detach() for m in maps),
                       None if stream is None else stream.record_event())
        g._barrier.wait()
        out = None
        if i == 0:
            for j, (_, ev) in enumerate(g._slots):
                if j and ev is not None and stream is not None:
                    stream.wait_event(ev)
            out = tuple(torch.cat([p[l].to(dev) for p, _ in g._slots], 2)
                        .contiguous(memory_format=_memory_format(maps[l]))
                        for l in range(len(maps)))
            g._done[0] = None if stream is None else stream.record_event()
        g._barrier.wait()
        if i and stream is not None and g._done[0] is not None:
            stream.wait_event(g._done[0])
        return out


# --------------------------------------------------------------------- shard
@dataclasses.dataclass(frozen=True)
class _Plan:
    """One shard's halo exchange for one layer: the halo depth ``T``, the
    rows it keeps of its own map (``own``), and where in the gathered
    ``[shards * 2T]`` rows the rows above and below it come from (index
    lists, as tensors on each device they were asked on)."""

    depth: int
    own: Tuple[int, int]
    above: Tuple[int, ...]
    below: Tuple[int, ...]
    _on: Dict = dataclasses.field(default_factory=dict, compare=False)

    def index(self, which: str, device) -> torch.Tensor:
        key = (which, device)
        if key not in self._on:
            self._on[key] = torch.tensor(getattr(self, which),
                                         dtype=torch.int64, device=device)
        return self._on[key]


def _need(key: tuple, lo: int, hi: int) -> Tuple[int, int]:
    """The input rows ``[lo', hi')`` a layer reads for its output rows
    ``[lo, hi)``: a window (``("conv", k, s, p)``) or the 2x upsample
    (``("up", ...)``)."""
    if key[0] == "up":
        return lo // 2, (hi - 1) // 2 + 1
    _, k, s, p = key
    return lo * s - p, (hi - 1) * s - p + k


@functools.lru_cache(maxsize=None)
def _plan(index: int, e_in: Tuple[int, ...], e_out: Tuple[int, ...],
          key: tuple) -> Optional[_Plan]:
    """Shard ``index``'s exchange for one layer, from the row edges of its
    input and output maps; None when it needs none (its output is empty
    and no shard's window crosses an edge)."""
    n = len(e_in) - 1
    spans = []
    for q in range(n):
        if e_out[q + 1] == e_out[q]:
            spans.append(None)
            continue
        lo, hi = _need(key, e_out[q], e_out[q + 1])
        spans.append((max(lo, 0), min(hi, e_in[-1])))
    depth = max([0] + [max(e_in[q] - sp[0], sp[1] - e_in[q + 1], 0)
                       for q, sp in enumerate(spans) if sp is not None])
    if spans[index] is None:
        return _Plan(depth, (0, 0), (), ()) if depth else None
    lo, hi = spans[index]
    a, b = e_in[index], e_in[index + 1]
    above, below = [], []
    for j in range(lo, hi):
        if a <= j < b:
            continue
        o = next(q for q in range(n) if e_in[q] <= j < e_in[q + 1])
        if j < a:       # the owner's last rows: its bottom block
            above.append(o * 2 * depth + depth + j - (e_in[o + 1] - depth))
        else:           # the owner's first rows: its top block
            below.append(o * 2 * depth + j - e_in[o])
    own = (min(max(lo, a), b) - a, max(min(hi, b), a) - a)
    return _Plan(depth, own, tuple(above), tuple(below))


class Shard:
    """One shard's rows of a ``height`` x ``width`` image.

    ``transport`` joins the shards (:class:`GroupTransport` or a
    :class:`ThreadTransport`); the image's rows split over them as
    :func:`split_rows` splits them.  ``stats`` counts what
    the exchanges move: ``halo`` and ``gather``, each ``[calls, bytes sent
    by this shard, seconds]`` (seconds only with ``timed``, which
    synchronises the device around each collective).
    """

    def __init__(self, transport, height: int, width: int,
                 timed: bool = False):
        edges = split_rows(height, transport.size)
        self.transport, self.index = transport, transport.index
        self.height, self.width, self.timed = height, width, timed
        self._levels: Dict[int, Tuple[int, ...]] = {}
        s = 1
        while s <= MAX_STRIDE:
            w, e = _ceil_div(width, s), tuple(_ceil_div(x, s) for x in edges)
            if self._levels.setdefault(w, e) != e:
                raise ValueError(
                    f"a {height}x{width} image has two maps {w} wide with "
                    "different rows: spatial sharding finds a map's level "
                    "by its width")
            s *= 2
        self.stats = {"halo": [0, 0, 0.0], "gather": [0, 0, 0.0]}

    # ------------------------------------------------------------- levels
    def edges(self, x: torch.Tensor) -> Tuple[int, ...]:
        """The row edges of the map ``x`` belongs to (by its width)."""
        e = self._levels.get(x.shape[-1])
        if e is None:
            raise ValueError(f"no map of a {self.height}x{self.width} image "
                             f"is {x.shape[-1]} wide")
        return e

    def rows(self, x: torch.Tensor) -> Tuple[int, int]:
        """This shard's global rows ``[a, b)`` of ``x``'s map; ``x`` must
        hold exactly them."""
        e = self.edges(x)
        a, b = e[self.index], e[self.index + 1]
        if x.shape[2] != b - a:
            raise ValueError(f"shard {self.index} holds rows [{a}, {b}) of "
                             f"a {e[-1]}-row map, got {x.shape[2]} rows")
        return a, b

    def own_rows(self, full: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        """This shard's rows of ``full``, a whole map of ``like``'s level."""
        e = self.edges(like)
        return full[:, :, e[self.index]:e[self.index + 1]]

    def own_image_rows(self, images: torch.Tensor) -> torch.Tensor:
        """This shard's rows of ``[B, H, W, C]`` images."""
        a, b = self._levels[self.width][self.index:self.index + 2]
        return images[:, a:b]

    # ------------------------------------------------------------ windows
    def conv(self, x: torch.Tensor, k: int, s: int, p: int,
             fn: Callable[[torch.Tensor], torch.Tensor],
             fill: float = 0.0) -> torch.Tensor:
        """A ``k x k`` window of stride ``s`` and padding ``p = k // 2`` on
        this shard's rows of ``x``: ``fn`` computes it on the rows it reads
        (the halo included, the image's edges padded with ``fill``) with
        no padding along the height."""
        if p != k // 2 or k % 2 == 0:
            raise ValueError(f"a row-sharded window needs an odd size and "
                             f"padding size // 2, got {k} and {p}")
        e = self.edges(x)
        out = tuple(_ceil_div(v, s) for v in e)
        return self._window(x, e, out, ("conv", k, s, p),
                            lambda slab, lo, m: fn(slab), k, fill)

    def upsample2x_to(self, coarse: torch.Tensor,
                      like: torch.Tensor) -> torch.Tensor:
        """The nearest 2x upsample of ``coarse`` cropped to the map of
        ``like`` (the FPN's top-down step), on this shard's rows of
        ``like``: fine row ``r`` reads coarse row ``r // 2``, which may be
        a neighbour's."""
        e_in, e_out = self.edges(coarse), self.edges(like)
        w = like.shape[-1]

        def fn(slab, lo, m):
            # the slab starts at coarse row lo // 2, fine row lo - lo % 2
            up = F.interpolate(slab, scale_factor=2, mode="nearest")
            return up[:, :, lo % 2:lo % 2 + m, :w]

        return self._window(coarse, e_in, e_out, ("up", w), fn, 1, 0.0)

    def subsample2x(self, x: torch.Tensor) -> torch.Tensor:
        """``x[:, :, ::2, ::2]`` by global rows (the FPN's P6): the even
        rows of the whole map, which are always this shard's own."""
        return self.conv(x, 1, 2, 0, lambda slab: slab[:, :, ::2, ::2])

    def _window(self, x, e_in, e_out, key, fn, one_row, fill):
        """``fn(rows, first output row, output rows)`` on the input rows
        this shard's output of ``x``'s layer ``key`` reads; ``one_row``
        input rows make one output row (the empty shard's stand-in)."""
        r = self.index
        self.rows(x)
        plan = _plan(r, e_in, e_out, key)
        m = e_out[r + 1] - e_out[r]
        if plan is None:
            slab = x[:, :, :0]
        elif plan.depth:
            slab = self._timed("halo", x.device, 2 * plan.depth
                               * x[:, :, :1].numel() * x.element_size(),
                               _Halo.apply, x, self, plan)
        else:
            slab = x[:, :, plan.own[0]:plan.own[1]]
        if m == 0:
            # nothing to compute; keep the graph (and so the backward's
            # collectives) the same on every shard
            rows = F.pad(slab, (0, 0, 0, one_row - slab.shape[2]), value=fill)
            return fn(rows, 0, 1)[:, :, :0]
        lo, hi = _need(key, e_out[r], e_out[r + 1])
        h = e_in[-1]
        if lo < 0 or hi > h:
            slab = F.pad(slab, (0, 0, max(-lo, 0), max(hi - h, 0)),
                         value=fill)
        return fn(slab, e_out[r], m)

    # -------------------------------------------------------------- gather
    def gather(self, maps: Sequence[torch.Tensor]
               ) -> Optional[Tuple[torch.Tensor, ...]]:
        """Every shard's rows of each of ``maps``: the whole maps, a
        collective.  Over a process group every shard gets them (its
        backward keeps this shard's rows of the gradient summed over the
        shards); over a :class:`ThreadGroup` the lead shard gets them and
        the others None (inference only)."""
        nbytes = sum(m.numel() * m.element_size() for m in maps)
        return self._timed("gather", maps[0].device, nbytes,
                           self.transport.gather_rows, self, maps)

    def _timed(self, name, device, nbytes, fn, *args):
        """``fn(*args)``, counted in ``stats[name]`` (and timed between two
        synchronisations of ``device`` with ``timed``)."""
        st = self.stats[name]
        st[0] += 1
        st[1] += nbytes
        if not self.timed:
            return fn(*args)
        sync = (lambda: torch.cuda.synchronize(device)) \
            if device.type == "cuda" else (lambda: None)
        sync()
        t0 = time.perf_counter()
        out = fn(*args)
        sync()
        st[2] += time.perf_counter() - t0
        return out


def _blocks(x: torch.Tensor, depth: int) -> torch.Tensor:
    """``x``'s first and last ``depth`` rows, zero-padded where it has
    fewer: ``[N, C, 2 * depth, W]``."""
    h = x.shape[2]
    m = min(depth, h)
    top, bottom = x[:, :, :m], x[:, :, h - m:]
    if m < depth:
        top = F.pad(top, (0, 0, 0, depth - m))
        bottom = F.pad(bottom, (0, 0, depth - m, 0))
    return torch.cat([top, bottom], 2)


class _Halo(torch.autograd.Function):
    """The rows a shard's window reads: the halo above (from the owners'
    last rows), its own rows and the halo below (from their first rows)."""

    @staticmethod
    def forward(ctx, x, shard, plan):
        n, c, _, w = x.shape
        t = plan.depth
        got = shard.transport.all_gather(_blocks(x, t).contiguous())
        flat = got.permute(1, 2, 0, 3, 4).reshape(n, c, -1, w)
        above = flat.index_select(2, plan.index("above", x.device))
        below = flat.index_select(2, plan.index("below", x.device))
        ctx.shard, ctx.plan, ctx.shape = shard, plan, x.shape
        own = x[:, :, plan.own[0]:plan.own[1]]
        return torch.cat([above, own, below], 2)

    @staticmethod
    def backward(ctx, g):
        plan, shard = ctx.plan, ctx.shard
        n, c, h, w = ctx.shape
        t, size = plan.depth, shard.transport.size
        na, no = len(plan.above), plan.own[1] - plan.own[0]
        dx = g.new_zeros((n, c, h, w))
        dx[:, :, plan.own[0]:plan.own[1]] += g[:, :, na:na + no]
        buf = g.new_zeros((n, c, size * 2 * t, w))
        buf.index_add_(2, plan.index("above", g.device), g[:, :, :na])
        buf.index_add_(2, plan.index("below", g.device), g[:, :, na + no:])
        buf = buf.reshape(n, c, size, 2 * t, w).permute(2, 0, 1, 3, 4)
        mine = shard.transport.all_reduce(buf.contiguous())[shard.index]
        m = min(t, h)
        dx[:, :, :m] += mine[:, :, :m]
        dx[:, :, h - m:] += mine[:, :, 2 * t - m:]
        return dx, None, None


def _memory_format(t: torch.Tensor):
    # the port's maps are channels-last in memory on the card
    return torch.channels_last if t.is_cuda else torch.contiguous_format


class _GatherRows(torch.autograd.Function):
    """All-gather each map's rows over the shards (rows laid out NHWC, one
    flat buffer, each shard's block padded to the most rows any shard
    holds)."""

    @staticmethod
    def forward(ctx, shard, *maps):
        size = shard.transport.size
        layout, pieces = [], []
        for x in maps:
            e = shard.edges(x)
            most = max(b - a for a, b in zip(e, e[1:]))
            nhwc = x.permute(0, 2, 3, 1)
            pieces.append(F.pad(nhwc, (0, 0, 0, 0, 0, most - x.shape[2]))
                          .reshape(-1))
            layout.append((e, most, nhwc.shape))
        got = shard.transport.all_gather(torch.cat(pieces))    # [size, L]
        out, at = [], 0
        for x, (e, most, (n, _, w, c)) in zip(maps, layout):
            span = n * most * w * c
            blocks = got[:, at:at + span].reshape(size, n, most, w, c)
            full = torch.cat([blocks[q, :, :e[q + 1] - e[q]]
                              for q in range(size)], 1)
            out.append(full.permute(0, 3, 1, 2).contiguous(
                memory_format=_memory_format(x)))
            at += span
        ctx.shard, ctx.edges = shard, [e for e, _, _ in layout]
        return tuple(out)

    @staticmethod
    def backward(ctx, *grads):
        shard, r = ctx.shard, ctx.shard.index
        flat = shard.transport.all_reduce(
            torch.cat([g.permute(0, 2, 3, 1).reshape(-1) for g in grads]))
        out, at = [], 0
        for g, e in zip(grads, ctx.edges):
            n, c, hh, w = g.shape
            full = flat[at:at + g.numel()].reshape(n, hh, w, c)
            out.append(full[:, e[r]:e[r + 1]].permute(0, 3, 1, 2))
            at += g.numel()
        return (None, *out)


# ------------------------------------------------------------ layer routes
def max_pool(x: torch.Tensor, k: int, s: int, p: int) -> torch.Tensor:
    """``F.max_pool2d(x, k, s, p)``, by rows on the active shard (its image
    edges padded with -inf)."""
    shard = current()
    if shard is None:
        return F.max_pool2d(x, k, s, p)
    return shard.conv(x, k, s, p,
                      lambda slab: F.max_pool2d(slab, k, s, (0, p)),
                      fill=float("-inf"))


class SpatialAxis:
    """The model axis of a :class:`~.mesh.Mesh` over processes carrying
    image rows: what ``FasterRCNN.features`` needs to run its backbone and
    neck on this rank's rows (``parallel.mesh.place_train_state(...,
    spatial=True)`` sets it on the model).  ``shard(h, w)`` is this rank's
    :class:`Shard` of an ``h x w`` image (cached)."""

    def __init__(self, transport):
        self.transport = transport
        self.size, self.index = transport.size, transport.index
        self._shards: Dict[tuple, Shard] = {}

    def shard(self, height: int, width: int) -> Shard:
        key = (height, width)
        if key not in self._shards:
            self._shards[key] = Shard(self.transport, height, width)
        return self._shards[key]
