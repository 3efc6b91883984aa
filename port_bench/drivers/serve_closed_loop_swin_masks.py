"""One caller sending many-image requests back to back to a Swin-T Mask
R-CNN ``Predictor``: ``serve_closed_loop_masks``'s loop and checks, on the
Swin reference.

Traffic file: as ``serve_closed_loop_masks``'s.

The loop is ``serve_closed_loop_masks.drive``, run from a module object
this driver loads for itself, whose reference and FLOP count are the
Swin ones: ``mask_reference`` builds
``reference/swin_mask_rcnn.py:swin_detector`` with the mask head, and
``counts_mask`` is :mod:`port_bench.counts_swin` (``mfu.rate``).  The run's
``reference_model``, which ``served.detection_checks`` and the mask
reference call, is bound to the Swin box detector: the neck, heads and
logit scales drawn as ``Run.reference_model`` draws them, the trunk from
``sub_seed(seed, 0, 2)`` with the published init.

With ``--trace 1`` the run also opens, beside the mask driver's ranges,
``bench.window_attn`` around each block's attention module (the qkv and
output projections and the attention core) and
``bench.window_attn_core:<images>`` around each call of the program's
``models.swin.window_attention`` (the core alone, whatever computes it),
and hands the readers the attention calls of the configuration's padded
shapes (``ctx.window_attn_calls``, :func:`port_bench.counts_swin.
attention_calls`).  A program without ``models/swin.py`` cannot run the
cell: the run ends at once, before anything is built.
"""

from __future__ import annotations

import importlib
import importlib.util
import os

import torch
from torch.profiler import record_function

from port_bench import counts_swin, inputs
from port_bench.harness import BenchError, load_module
from port_bench.runner import Run, _logit_scales, clock
from port_bench.trace import PREFIX, _ModuleRange

HERE = os.path.dirname(os.path.abspath(__file__))
SWIN = "two_stage_object_detection_tpu_torch.models.swin"
MASK_KEYS = ("mask_roi_size", "mask_dim", "mask_convs")


def _mask_driver():
    """``serve_closed_loop_masks`` as a module object of this driver's own,
    its reference and FLOP count the Swin ones."""
    base = load_module(os.path.join(HERE, "serve_closed_loop_masks.py"),
                       "port_bench_driver_swin_masks_loop")
    base.mask_reference = mask_reference
    base.counts_mask = counts_swin
    base.clock = clock          # the loop reads this driver's clock
    return base


def _scale(run, ref, rcfg, target: dict, key: str):
    """Scale ``ref``'s named layers to the logit spreads ``target``: found
    once a run (kept in ``run.memo[key]``) and reused."""
    if not target:
        return
    if key not in run.memo:
        run.memo[key] = _logit_scales(ref, rcfg, target, run.seed)
        return
    with torch.no_grad():
        for name, k in run.memo[key].items():
            ref.get_submodule(name).weight.mul_(k)


def box_reference(run, rcfg):
    """The Swin box detector, float32 on the device: the neck and heads
    from ``sub_seed(seed, 0)`` as ``Run.reference_model`` draws them, the
    trunk from ``sub_seed(seed, 0, 2)``, then the configuration's
    ``init_logit_std``."""
    from port_bench.reference.swin_mask_rcnn import (
        init_swin_detector, swin_detector)
    ref = swin_detector(rcfg, run.device)
    init_swin_detector(ref, inputs.sub_seed(run.seed, 0),
                       inputs.sub_seed(run.seed, 0, 2))
    _scale(run, ref, rcfg, run.cell.config.get("init_logit_std") or {},
           "init_scales")
    return ref


def mask_reference(run, rcfg):
    """The Swin Mask R-CNN reference: :func:`box_reference`'s weights, the
    mask head from ``sub_seed(seed, 0, 1)`` scaled to the configuration's
    ``mask_init_logit_std``, as ``serve_closed_loop_masks.mask_reference``
    draws it."""
    from port_bench.reference.mask_rcnn import init_mask_head
    from port_bench.reference.swin_mask_rcnn import swin_detector
    box = run.reference_model(rcfg)
    ref = swin_detector(rcfg, run.device,
                        {k: run.model_kw[k] for k in MASK_KEYS})
    missing = ref.load_state_dict(box.state_dict(), strict=False).missing_keys
    del box
    if any(not k.startswith("mask_head.") for k in missing):
        raise BenchError(f"the box reference lacks {missing}")
    init_mask_head(ref.mask_head, inputs.sub_seed(run.seed, 0, 1))
    _scale(run, ref, rcfg, run.cell.config.get("mask_init_logit_std") or {},
           "mask_scales")
    return ref


def install_window_ranges(run, model) -> None:
    """``bench.window_attn`` on each block's attention module and
    ``bench.window_attn_core:<images>`` around the program's attention
    core, on ``run.spans`` (undone by its ``close``)."""
    swin = importlib.import_module(SWIN)
    for m in model.modules():
        if isinstance(m, swin.WindowAttention):
            r = _ModuleRange(PREFIX + "window_attn")
            run.spans._undo.append(m.register_forward_pre_hook(r.enter).remove)
            run.spans._undo.append(m.register_forward_hook(r.leave).remove)
    core = swin.window_attention

    def traced(q, k, v, mask, scale):
        with record_function(f"{PREFIX}window_attn_core:{q.shape[0]}"):
            return core(q, k, v, mask, scale)

    swin.window_attention = traced
    run.spans._undo.append(lambda: setattr(swin, "window_attention", core))


def drive(run) -> dict:
    if importlib.util.find_spec(SWIN) is None:
        raise BenchError("the program has no Swin trunk (models/swin.py)")
    base = _mask_driver()
    rcfg = run.reference_config()
    calls = counts_swin.attention_calls(rcfg.input_size)

    def install_spans(model):
        spans = Run.install_spans(run, model)
        install_window_ranges(run, model)
        return spans

    def per_layer(ctx):
        ctx.window_attn_calls = calls
        return Run.per_layer(run, ctx)

    run.reference_model = lambda cfg: box_reference(run, cfg)
    run.install_spans = install_spans
    run.per_layer = per_layer
    return base.drive(run)
