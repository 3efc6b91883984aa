"""Tracing, profiling and debugging hooks.

The port's counterpart of the JAX package's ``utils/profiling.py``:

* :func:`trace`: a context manager around ``torch.profiler`` (host and, on
  the card, CUDA activity) writing a Chrome / Perfetto trace file;
* :func:`annotate`: a named region inside a trace
  (``torch.profiler.record_function``);
* :func:`enable_nan_checks`: ``torch.autograd.set_detect_anomaly``;
* :func:`device_memory_stats`: ``torch.cuda.memory_stats`` per device.
"""

from __future__ import annotations

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


def annotate(name: str):
    """Named region inside an active trace: ``with annotate("train_step"):``."""
    return torch.profiler.record_function(name)


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
