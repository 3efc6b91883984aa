"""The program's own spans in a profiler slice, and what they read.

The port enters a ``tsod.<layer>`` range at each of its layer boundaries
(``utils/profiling.annotate``: ``Predictor``'s request, wire, enqueue and
fetch, the detector's stages, the trainer's phases) whenever a profiler
records, so a ``--trace 1`` slice holds them beside the benchmark's own
``bench.*`` ranges, on the same clock as CUPTI's kernel and runtime records.

:class:`SpanTimeline` is a :class:`port_bench.trace.Timeline` that also
keeps those ranges (:attr:`SpanTimeline.spans`) and the synchronising CUDA
runtime calls (:attr:`SpanTimeline.syncs`); what a ``Timeline`` reads, it
reads the same.  The readers below take a metric's layer context
(``ctx.timeline``) and return None where the slice holds no such span (a
``Timeline`` of a slice of a program without spans).  A bucket is a
``tsod.enqueue`` range, a micro-step a ``tsod.micro_step`` range.

The idle readers count the device's idle time inside the host interval of
their span, its children included, in the profiled slice itself: unlike
``idle_share.*`` they are not rescaled by the unprofiled rate, so they
include what the profiler costs the host (CUPTI's launch records).
"""

from __future__ import annotations

import bisect
import collections
import json
from typing import List, Optional

from port_bench.trace import _LAUNCH_CATS, Timeline

SPAN_PREFIX = "tsod."
# runtime calls that block the host until the device has caught up
SYNC_CALLS = frozenset({"cudaStreamSynchronize", "cudaDeviceSynchronize",
                        "cudaEventSynchronize", "cudaMemcpy"})


def _depth(r):
    return r[0], -r[1]


def _innermost(ranges, points) -> List[Optional[tuple]]:
    """For each of the sorted ``points``, the range ``(start, end, name)``
    with the latest start among those holding it, of two with one start the
    one that ends first (None where none holds it)."""
    todo, active, out, i = sorted(ranges), [], [], 0
    for p in points:
        while i < len(todo) and todo[i][0] <= p:
            active.append(todo[i])
            i += 1
        active = [r for r in active if r[1] >= p]
        out.append(max(active, key=_depth) if active else None)
    return out


class SpanTimeline(Timeline):
    """A :class:`Timeline` that also keeps the ``tsod.*`` ranges and the
    host times of the synchronising runtime calls."""

    def __init__(self, path: str):
        super().__init__(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        self.spans, self.syncs = [], []
        for e in events:
            if e.get("ph") != "X":
                continue
            name, cat = e.get("name", ""), e.get("cat", "")
            ts = float(e["ts"])
            if cat == "user_annotation" and name.startswith(SPAN_PREFIX):
                self.spans.append((ts, ts + float(e.get("dur", 0.0)), name))
            elif cat in _LAUNCH_CATS and name in SYNC_CALLS:
                self.syncs.append((ts, name))
        self.spans.sort()
        self.syncs.sort()
        self._sync_ts = [t for t, _ in self.syncs]
        self._busy = self.busy_intervals()
        self._busy_starts = [s for s, _ in self._busy]

    def spans_named(self, layer: str) -> List[tuple]:
        """``(start, end, name)`` of the ``tsod.<layer>`` ranges."""
        return [r for r in self.spans if r[2] == SPAN_PREFIX + layer]

    def syncs_in(self, rng) -> int:
        """Synchronising runtime calls made inside the host interval of
        ``rng``."""
        return (bisect.bisect_right(self._sync_ts, rng[1])
                - bisect.bisect_left(self._sync_ts, rng[0]))

    def idle_us(self, rng) -> float:
        """Microseconds of the host interval of ``rng`` with no operation
        running on the device."""
        a, b = rng[0], rng[1]
        busy = 0.0
        i = max(bisect.bisect_right(self._busy_starts, a) - 1, 0)
        for s, e in self._busy[i:]:
            if s >= b:
                break
            busy += max(0.0, min(e, b) - max(s, a))
        return (b - a) - busy

    def idle_gaps_by_span(self, top: int = 10) -> List[list]:
        """As :meth:`Timeline.idle_gaps_by_range`, each gap put down to the
        innermost range of either prefix (``bench.*`` or ``tsod.*``) open
        on the host at its middle."""
        busy = self._busy
        gaps = [(self.start, busy[0][0])] if busy else []
        gaps += [(a[1], b[0]) for a, b in zip(busy, busy[1:])]
        if busy:
            gaps.append((busy[-1][1], self.end))
        gaps = sorted((s, e) for s, e in gaps if e > s)
        inner = _innermost(self.ranges + self.spans,
                           [0.5 * (s + e) for s, e in gaps])
        total = collections.Counter()
        for (s, e), r in zip(gaps, inner):
            total[r[2].split("#")[0] if r else "host_outside_ranges"] += (
                (e - s) * 1e-6)
        return [[n, t] for n, t in total.most_common(top)]


def _spans(ctx, layer: str) -> List[tuple]:
    tl = getattr(ctx, "timeline", None)
    return tl.spans_named(layer) if isinstance(tl, SpanTimeline) else []


def _per(ctx, unit: str, total) -> Optional[float]:
    """``total(timeline)`` over the slice's ``tsod.<unit>`` ranges' count,
    None without one."""
    n = len(_spans(ctx, unit))
    return total(ctx.timeline) / n if n else None


def host_syncs(ctx):
    """Synchronising runtime calls (``SYNC_CALLS``) made inside
    ``tsod.post_process``, a bucket; None without a post-process span."""
    pp = _spans(ctx, "post_process")
    if not pp:
        return None
    return _per(ctx, "enqueue", lambda tl: sum(tl.syncs_in(r) for r in pp))


def post_process_idle_ms(ctx):
    """Milliseconds of device idle inside the host interval of
    ``tsod.post_process``, a bucket, in the profiled slice (the profiler's
    host cost included)."""
    pp = _spans(ctx, "post_process")
    if not pp:
        return None
    return _per(ctx, "enqueue",
                lambda tl: sum(tl.idle_us(r) for r in pp) * 1e-3)


def fetch_wait_ms(ctx):
    """Host milliseconds inside ``tsod.fetch`` (the wait for a bucket's
    outputs and their host concat), a bucket."""
    fetch = _spans(ctx, "fetch")
    if not fetch:
        return None
    return _per(ctx, "enqueue",
                lambda tl: sum(e - s for s, e, _ in fetch) * 1e-3)


def _launches(ctx, unit: str):
    rs = _spans(ctx, unit)
    return _per(ctx, unit, lambda tl: sum(len(tl.kernels_in(r)) for r in rs))


def launches_rate(ctx):
    """Kernels launched inside ``tsod.enqueue``, a bucket."""
    return _launches(ctx, "enqueue")


def launches_train(ctx):
    """Kernels launched inside ``tsod.micro_step``, a micro-step over the
    slice's whole cycles."""
    return _launches(ctx, "micro_step")


def _idle_per_step(ctx, layer: str):
    rs = _spans(ctx, layer)
    if not rs:
        return None
    return _per(ctx, "micro_step",
                lambda tl: sum(tl.idle_us(r) for r in rs) * 1e-3)


def forward_idle_ms(ctx):
    """Milliseconds of device idle inside the host interval of
    ``tsod.train_forward``, a micro-step, in the profiled slice (the
    profiler's host cost included)."""
    return _idle_per_step(ctx, "train_forward")


def backward_idle_ms(ctx):
    """Milliseconds of device idle inside the host interval of
    ``tsod.backward`` (autograd launches the backward's kernels from its own
    thread meanwhile), a micro-step, in the profiled slice (the profiler's
    host cost included)."""
    return _idle_per_step(ctx, "backward")


# the per-layer metrics these readers give, by name
READERS = {
    "host_syncs.rate": host_syncs,
    "post_process_idle_ms.rate": post_process_idle_ms,
    "fetch_wait_ms.rate": fetch_wait_ms,
    "launches.rate": launches_rate,
    "launches.train": launches_train,
    "forward_idle_ms.train": forward_idle_ms,
    "backward_idle_ms.train": backward_idle_ms,
}
