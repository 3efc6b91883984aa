"""Spans around the program's layers, and the reading of a profiler slice.

:class:`Spans` installs, from the benchmark's side, the ranges the
per-layer metrics read: ``torch.profiler.record_function`` ranges entered
from forward pre-hooks and left in forward hooks on named submodules,
wrappers on a model instance's methods and on names in a module's
namespace, and kernel-call captures (a numbered range around each call of
a hand kernel's wrapper, with its arguments and outputs kept for the
first few calls while :attr:`Spans.capturing` is set).  :meth:`Spans.close`
takes everything out again.

:class:`Timeline` reads a profiler slice exported as a Chrome trace: the
device operations (kernels, copies, sets), each kernel's launch time on
the host through its correlation id, and the ``bench.*`` ranges.  A kernel
belongs to a range when its launch call lies inside the range's host
interval, whatever the thread (the backward pass launches from autograd's
thread while the step's range is open on the main one).
"""

from __future__ import annotations

import bisect
import collections
import functools
import inspect
import json
import re
from typing import Dict, List, Optional

import torch
from torch.profiler import record_function

PREFIX = "bench."
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


class _ModuleRange:
    def __init__(self, name: str):
        self.name, self.stack = name, []

    def enter(self, module, args):
        rf = record_function(self.name)
        rf.__enter__()
        self.stack.append(rf)

    def leave(self, module, args, out):
        if self.stack:
            self.stack.pop().__exit__(None, None, None)


class Spans:
    """Ranges and captures installed around the program's calls."""

    def __init__(self, max_captures: int = 6):
        self._undo: List = []
        self.max_captures = max_captures
        self.capturing = False
        self.captures: Dict[str, list] = collections.defaultdict(list)

    def modules(self, model, names):
        """A range ``bench.<name>`` around each forward of ``model.<name>``
        (names the model lacks are skipped)."""
        for name in names:
            sub = getattr(model, name, None)
            if sub is None:
                continue
            r = _ModuleRange(PREFIX + name)
            self._undo.append(sub.register_forward_pre_hook(r.enter).remove)
            self._undo.append(sub.register_forward_hook(r.leave).remove)

    def method(self, obj, attr: str, name: Optional[str] = None):
        """A range around each call of ``obj.attr`` (an instance's bound
        method, shadowed by an instance attribute)."""
        fn = getattr(obj, attr)

        def wrapped(*a, **k):
            with record_function(PREFIX + (name or attr)):
                return fn(*a, **k)

        functools.update_wrapper(wrapped, fn)
        setattr(obj, attr, wrapped)
        self._undo.append(lambda: delattr(obj, attr))

    def name(self, module, attr: str, name: Optional[str] = None,
             capture: Optional[str] = None):
        """A range around each call of the function ``module.attr`` that
        goes through that name.  With ``capture``, the calls made while
        :attr:`capturing` is set get numbered ranges
        ``bench.kernel.<capture>#<i>``, and the first :attr:`max_captures`
        keep their bound arguments and outputs in
        ``captures[capture]``."""
        fn = getattr(module, attr)
        sig = inspect.signature(fn)
        label = PREFIX + (name or attr)

        def wrapped(*a, **k):
            if capture is None or not self.capturing:
                with record_function(label):
                    return fn(*a, **k)
            kept = self.captures[capture]
            i = len(kept)
            with record_function(f"{PREFIX}kernel.{capture}#{i}"):
                out = fn(*a, **k)
            if i < self.max_captures:
                bound = sig.bind(*a, **k)
                bound.apply_defaults()
                kept.append((dict(bound.arguments), out))
            else:
                kept.append(None)
            return out

        # the wrapped function's attributes (a launch counter) stay readable
        # and writable through the name
        functools.update_wrapper(wrapped, fn)
        setattr(module, attr, wrapped)
        self._undo.append(lambda: setattr(module, attr, fn))

    def close(self):
        while self._undo:
            self._undo.pop()()


class PredictorProxy:
    """What the caller holds in place of the ``Predictor``: every call runs
    in a range ``bench.predict:<images>`` and is logged as ``(start, end,
    images)`` on the host clock; everything else is the predictor's."""

    def __init__(self, predictor, clock):
        self._pred, self._clock = predictor, clock
        self.calls: List[tuple] = []

    def __getattr__(self, name):
        return getattr(self._pred, name)

    def __call__(self, images):
        n = len(images)
        t = self._clock()
        with record_function(f"{PREFIX}predict:{n}"):
            out = self._pred(images)
        self.calls.append((t, self._clock(), n))
        return out


def _union(intervals) -> List[list]:
    merged: List[list] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


class Timeline:
    """A profiler slice: device operations, kernel launches and ``bench.*``
    ranges, times in microseconds on the trace's clock."""

    def __init__(self, path: str):
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        launch = {}
        self.ops, self.ranges = [], []
        lo, hi = float("inf"), float("-inf")
        for e in events:
            if e.get("ph") != "X":
                continue
            ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
            lo, hi = min(lo, ts), max(hi, ts + dur)
            cat = e.get("cat", "")
            args = e.get("args") or {}
            if cat in _DEVICE_CATS:
                self.ops.append((ts, ts + dur, e.get("name", ""), cat,
                                 args.get("correlation")))
            elif cat in _LAUNCH_CATS and "correlation" in args:
                launch[args["correlation"]] = ts
            elif cat == "user_annotation" and e.get("name", "").startswith(PREFIX):
                self.ranges.append((ts, ts + dur, e["name"]))
        self.start, self.end = lo, hi
        # kernels by launch time, for the joins
        self.kernels = sorted(
            (launch[c], s, e, n) for s, e, n, cat, c in self.ops
            if cat == "kernel" and c in launch)
        self._launch_ts = [k[0] for k in self.kernels]

    @property
    def window_s(self) -> float:
        return (self.end - self.start) * 1e-6

    def busy_intervals(self) -> List[list]:
        return _union((s, e) for s, e, *_ in self.ops)

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) * 1e-6

    def ranges_named(self, pattern: str) -> List[tuple]:
        """``(start, end, name)`` of the ranges whose name matches the
        regular expression ``pattern`` (from its start)."""
        rx = re.compile(pattern)
        return sorted(r for r in self.ranges if rx.match(r[2]))

    def kernels_in(self, rng) -> List[tuple]:
        """``(launch, start, end, name)`` of the kernels launched inside the
        host interval of ``rng``."""
        i = bisect.bisect_left(self._launch_ts, rng[0])
        j = bisect.bisect_right(self._launch_ts, rng[1])
        return self.kernels[i:j]

    def kernel_ms(self, rng, names=None) -> float:
        """Device time (ms) of the kernels launched inside ``rng``; with
        ``names``, only kernels whose name holds one of them."""
        return sum(e - s for _, s, e, n in self.kernels_in(rng)
                   if names is None or any(x in n for x in names)) * 1e-3

    def inside(self, rng, outer) -> bool:
        return outer[0] <= rng[0] and rng[1] <= outer[1]

    def device_ops_by_name(self, top: int = 10) -> List[list]:
        total = collections.Counter()
        for s, e, n, *_ in self.ops:
            total[n] += (e - s) * 1e-6
        return [[n, t] for n, t in total.most_common(top)]

    def idle_gaps_by_range(self, top: int = 10) -> List[list]:
        """The idle gaps of the device, summed by the innermost ``bench.*``
        range open on the host at each gap's middle (``host_outside_ranges``
        where none is)."""
        busy = self.busy_intervals()
        gaps = [(self.start, busy[0][0])] if busy else []
        gaps += [(a[1], b[0]) for a, b in zip(busy, busy[1:])]
        if busy:
            gaps.append((busy[-1][1], self.end))
        total = collections.Counter()
        for s, e in gaps:
            if e <= s:
                continue
            mid = 0.5 * (s + e)
            inner = [r for r in self.ranges if r[0] <= mid <= r[1]]
            name = (max(inner)[2].split("#")[0] if inner
                    else "host_outside_ranges")
            total[name] += (e - s) * 1e-6
        return [[n, t] for n, t in total.most_common(top)]


class _Slice:
    """``torch.profiler`` over the card's operations and, on the host, the
    ``record_function`` ranges alone (``RecordScope.USER_SCOPE``): no
    event a PyTorch operator, which doubled a training cycle's host time
    when recorded, while the kernel launches still come from CUPTI."""

    def __init__(self):
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        self.prof = torch.profiler.profile(activities=acts)

    def start(self):
        from torch._C._profiler import RecordScope
        from torch.autograd import profiler as autograd_profiler
        enable = autograd_profiler._enable_profiler

        def user_scope(config, activities, *rest):
            return enable(config, activities, {RecordScope.USER_SCOPE})

        autograd_profiler._enable_profiler = user_scope
        try:
            self.prof.start()
        finally:
            autograd_profiler._enable_profiler = enable

    def stop(self):
        self.prof.stop()

    def export_chrome_trace(self, path: str):
        self.prof.export_chrome_trace(path)


def profile() -> _Slice:
    """A profiler slice, not yet started (:class:`_Slice`)."""
    return _Slice()
