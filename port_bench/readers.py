"""What the per-layer metric files read, one function a quantity.

Each takes the run's layer context (``ctx``: the profiled slice as
``ctx.timeline``, the captured kernel bounds,
the model's FLOPs an image, the card's peaks, the images a second outside
the slice as ``ctx.rate``) and returns the metric, or
None where the run has nothing to read: a reader never returns 0 for a
share of a roofline or a peak.  The files under ``metrics/`` bind a name
to one of these.
"""

from __future__ import annotations

import re


def _ranges(ctx, name: str):
    return [] if ctx.timeline is None else ctx.timeline.ranges_named(
        re.escape("bench." + name) + "$")


def post_process_ms(ctx):
    """Per bucket, on the device timeline: from the end of the last kernel
    ``roi_head`` launched to the end of the last kernel ``detect``
    launched."""
    tl, gaps = ctx.timeline, []
    heads = _ranges(ctx, "roi_head")
    for det in _ranges(ctx, "detect"):
        ks = tl.kernels_in(det)
        inner = [h for h in heads if tl.inside(h, det)]
        hk = [k for h in inner for k in tl.kernels_in(h)]
        if ks and hk:
            gaps.append((max(k[2] for k in ks) - max(k[2] for k in hk)) * 1e-3)
    return sum(gaps) / len(gaps) if gaps else None


def features_ms(ctx):
    """Device kernel milliseconds launched inside ``features``, per call."""
    rs = _ranges(ctx, "features")
    return (sum(ctx.timeline.kernel_ms(r) for r in rs) / len(rs)) if rs else None


def _micro_steps(ctx):
    return _ranges(ctx, "micro_step")


def _targets_ms(ctx) -> float:
    return sum(ctx.timeline.kernel_ms(r) for name in
               ("anchor_target", "proposal_target") for r in _ranges(ctx, name))


def forward_ms(ctx):
    """Device kernel milliseconds inside ``train_forward``, without the
    targets' ranges, per micro-step."""
    steps = _micro_steps(ctx)
    if not steps:
        return None
    fwd = sum(ctx.timeline.kernel_ms(r) for r in _ranges(ctx, "train_forward"))
    return (fwd - _targets_ms(ctx)) / len(steps)


def backward_update_ms(ctx):
    """Device kernel milliseconds of the micro-step outside
    ``train_forward`` (backward, accumulation, AdamW on update steps), per
    micro-step over whole cycles."""
    steps = _micro_steps(ctx)
    if not steps:
        return None
    tl = ctx.timeline
    total = sum(tl.kernel_ms(r) for r in steps)
    fwd = sum(tl.kernel_ms(r) for r in _ranges(ctx, "train_forward"))
    return (total - fwd) / len(steps)


def targets_ms(ctx):
    """Device kernel milliseconds inside ``anchor_target`` and
    ``proposal_target``, per micro-step."""
    steps = _micro_steps(ctx)
    return _targets_ms(ctx) / len(steps) if steps else None


def kernel_roofline(ctx):
    """Percent: the captured hand-kernel launches' bounds over their device
    time."""
    if not ctx.bounds:
        return None
    return 100.0 * sum(b for b, _ in ctx.bounds) / sum(t for _, t in ctx.bounds)


def _images(ctx) -> int:
    """Real images of the slice's whole predictor calls or micro-steps."""
    calls = ([] if ctx.timeline is None else
             ctx.timeline.ranges_named(r"bench\.predict:\d+$"))
    if calls:
        return sum(int(r[2].split(":")[1]) for r in calls)
    return len(_micro_steps(ctx)) * getattr(ctx, "batch", 0)


def mfu(ctx):
    """Percent of the card's dense bf16 peak: the model FLOPs of the images
    served or trained per second outside the profiled slice
    (``ctx.rate``), which the profiler's own cost does not slow."""
    if ctx.peaks is None or not getattr(ctx, "rate", None):
        return None
    return 100.0 * ctx.rate * ctx.flops_per_image / ctx.peaks["bf16_flops"]


def idle_share(ctx):
    """Percent of the time with no operation running on the device: one
    less the device's busy time an image in the profiled slice times the
    images an unprofiled second serves or trains (``ctx.rate``).  The
    slice's own idle share is longer by the profiler's cost on the host."""
    tl = ctx.timeline
    if tl is None or not tl.ops or not getattr(ctx, "rate", None):
        return None
    n = _images(ctx)
    if not n:
        return None
    return 100.0 * (1.0 - tl.busy_s / n * ctx.rate)
