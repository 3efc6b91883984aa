"""The hand kernels as the per-layer metrics see them: their names, the
wrappers whose calls are captured, and each capture's bound.

The names are the ``__global__`` functions of the program's ``csrc/*.cu``,
read from the sources at run time, so a kernel a later change adds is
found by its name.  A capture is ``(arguments, outputs)`` of one call of
a wrapper (:class:`~port_bench.trace.Spans`); its bound, in milliseconds,
comes from :mod:`port_bench.counts` on those tensors.
"""

from __future__ import annotations

import glob
import importlib
import os
import re

from port_bench import counts

PROGRAM = "two_stage_object_detection_tpu_torch"

# (module of the program, name in its namespace, capture kind)
WRAPPED = (
    ("ops.proposals", "greedy_nms", "nms"),
    ("ops.proposals", "fused_proposals_batched", "fused"),
    ("nets.fpn", "windowed_roi_align_batched", "align"),
    ("nets.fpn", "multilevel_roi_align_hybrid_batched", "align"),
    ("ops.roi_pool_bwd", "roi_pool_max", "pool"),
    ("nets.roi_head", "roi_pool_max", "pool"),
)


def hand_kernel_names(root: str) -> list:
    """The ``__global__`` function names of ``<program>/csrc/*.cu``."""
    names = set()
    rx = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\s*\([^)]*\)\s*)?"
                    r"(\w+)\s*\(")
    for path in glob.glob(os.path.join(root, PROGRAM, "csrc", "*.cu")):
        with open(path) as f:
            names.update(rx.findall(f.read()))
    return sorted(names)


def install(spans) -> None:
    """Capture wrappers on every entry of :data:`WRAPPED` the program has."""
    for mod, attr, kind in WRAPPED:
        m = importlib.import_module(f"{PROGRAM}.{mod}")
        if hasattr(m, attr):
            spans.name(m, attr, capture=kind)


def bound_ms(kind: str, args: dict, out, pk) -> float:
    """The least time of one captured call on the card."""
    if kind == "nms":
        return counts.nms_bound_ms(args["boxes"], out[0], out[2],
                                   args["n_post"], pk)
    if kind == "fused":
        return counts.fused_bound_ms(
            args["rpn_locs"], args["rpn_fg_scores"], args["anchors"],
            args["img_size"], args["n_post_nms"], args["min_size"],
            args["nms_iou"], pk)
    if kind == "align":
        return counts.align_bound_ms(
            list(args["pyramid"]), args["rois"], args["levels"],
            args["scales"], args["output_size"], args["window"], pk)
    if kind == "pool":
        rois = args["rois"] * float(args["spatial_scale"])
        return counts.roi_pool_bound_ms(
            args["feats"], rois, args["output_size"],
            8 if args.get("with_argmax") else 4, pk)
    raise KeyError(kind)
