"""Tracing, profiling and debugging hooks.

The port's counterpart of the JAX package's ``utils/profiling.py``:

* :func:`trace`: a context manager around ``torch.profiler`` (host and, on
  the card, CUDA activity) writing a Chrome / Perfetto trace file;
* :func:`annotate`: a named region inside a trace
  (``torch.profiler.record_function``) while a profiler records, one shared
  no-op context otherwise.  The program's own spans (``tsod.<layer>``, at
  the layer boundaries of ``Predictor``, ``FasterRCNN`` and
  ``nets/trainer.py``) all go through it, so while nothing records each
  costs one check and no ``record_function``;
* :func:`enable_nan_checks`: ``torch.autograd.set_detect_anomaly``;
* :func:`device_memory_stats`: ``torch.cuda.memory_stats`` per device;
* :data:`counters`: the program's event counts, by name.
"""

from __future__ import annotations

import collections
import contextlib
import os
from typing import Dict, Optional

import torch


@contextlib.contextmanager
def trace(log_dir: str = "torch-trace"):
    """Profile everything inside the block; on exit the trace is written to
    ``log_dir/trace.json`` (Chrome trace format, which Perfetto opens).
    Yields the profiler (``key_averages()`` and the like).  CUDA activity is
    recorded where a GPU is present."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


_OFF = contextlib.nullcontext()

#: Event counts, by name, kept whether or not a profiler records (a
#: ``Counter`` increment each).  The backbones' folded predict route
#: (``models/layers.py:fold_route``) counts ``fold.folded``, the conv +
#: batch-norm pairs it ran folded; ``fold.epilogue``, its epilogue calls;
#: ``fold.rebuild``, rebuilds of a module's folded weights;
#: ``fold.fallback.<reason>``, trunk calls that took the unfolded route;
#: ``hardnet.cat``, the copies HarDNet's dense blocks still make to build a
#: concatenation (``models/hardnet.py``); ``launch.<wrapper>``, the hand
#: kernels' launches (``ops/_cuda.py:launch``); ``swin.windows``,
#: ``swin.pad_tokens`` and ``swin.mask_build``, the Swin trunk's windows
#: attended, tokens added by padding and attention masks built
#: (``models/swin.py``).  Readers reset it with ``counters.clear()``.
counters: collections.Counter = collections.Counter()


def annotate(name: str):
    """Named region inside a trace: ``with annotate("tsod.backward"):``.

    A ``torch.profiler.record_function(name)`` when a profiler records on
    this thread (:func:`trace`, a benchmark's profiled slice or an
    operator's own ``torch.profiler.profile``), else one module-level
    ``contextlib.nullcontext``: a ``record_function`` does its work even
    with no profiler on, the check costs a fraction of it.  The name is
    recorded as given."""
    if torch._C._autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF


def enable_nan_checks(enable: bool = True) -> None:
    """Toggle autograd's anomaly mode: a backward that produces NaN raises,
    naming the forward operation it came from.  Narrower than the JAX
    package's ``jax_debug_nans``, which checks every jitted computation's
    outputs, forward included: here only the backward is checked, and a
    NaN that the forward produces and no gradient touches passes."""
    torch.autograd.set_detect_anomaly(enable)


def device_memory_stats() -> Dict[str, Optional[dict]]:
    """``torch.cuda.memory_stats`` for each CUDA device, by device name
    (``"cuda:0"``...); ``{"cpu": None}`` without a GPU (the CPU allocator
    keeps no such statistics)."""
    if not torch.cuda.is_available():
        return {"cpu": None}
    return {f"cuda:{i}": torch.cuda.memory_stats(i)
            for i in range(torch.cuda.device_count())}
