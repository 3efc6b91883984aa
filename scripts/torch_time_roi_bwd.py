#!/usr/bin/env python3
"""Time kernel 6 and kernel 5b of the checkout in the working directory.

    cd CHECKOUT && python3 /path/to/scripts/torch_time_roi_bwd.py

Builds the checkout's kernels and times, with CUDA events (20 launches,
three times each), ``roi_pool_bwd_recompute`` (kernel 6) from a bf16 and
from an f32 map and ``roi_pool_bwd_scatter`` (kernel 5b) at B=16, R=128,
38x38x512, P=7, on the inputs of the checkout's own ``chip_smoke.py``
(``roi_pool_bwd_inputs``, seed 6), with each one's largest difference from
its plain version.  It is the quick way to compare variants of
``csrc/roi_pool_bwd.cu``: unpack each into its own copy of the tree and
run this in each, in turns, in one call on one card.

If the checkout's ``libroi_pool_bwd.so`` exports ``dbg_read`` (a variant
built with per-block ``%globaltimer`` stamps: start, map slice in, rois
done, slice written, into a ``[8192][4]`` u64 array), it also prints each
phase's mean and largest time over the blocks of one kernel-6 launch.

Prints one line: the checkout's name and a JSON object.
"""

from __future__ import annotations

import ctypes
import importlib.util
import json
import os
import sys


def main() -> int:
    sys.path.insert(0, os.getcwd())
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("torch_time_roi_bwd: no CUDA device available", file=sys.stderr)
        return 1
    from two_stage_object_detection_tpu_torch.ops import _cuda
    from two_stage_object_detection_tpu_torch.ops.roi_pool import (
        roi_pool_grad_first_argmax, scatter_argmax_grad)
    from two_stage_object_detection_tpu_torch.ops.roi_pool_bwd import (
        roi_pool_bwd_recompute)
    from two_stage_object_detection_tpu_torch.ops.roi_pool_max import (
        roi_pool_bwd_scatter, roi_pool_max)

    spec = importlib.util.spec_from_file_location(
        "cs", os.path.join(os.getcwd(), "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    _cuda.build_all()
    dev = torch.device("cuda")
    feats32, rois, g = cs.roi_pool_bwd_inputs(np.random.RandomState(6), dev)
    feats = feats32.to(torch.bfloat16)
    h, w = feats.shape[1:3]
    argmax = roi_pool_max(feats32, rois, with_argmax=True)[1]
    out = {}
    got = roi_pool_bwd_recompute(feats, rois, g)
    want = roi_pool_grad_first_argmax(feats, rois, g)
    out["k6_err"] = float((got.float() - want.float()).abs().max())
    out["k6_ms"] = [cs.cuda_time_ms(
        lambda: roi_pool_bwd_recompute(feats, rois, g), 20) for _ in range(3)]
    out["k6_f32_ms"] = cs.cuda_time_ms(
        lambda: roi_pool_bwd_recompute(feats32, rois, g), 20)
    got = roi_pool_bwd_scatter(argmax, g, h, w)
    want = scatter_argmax_grad(argmax, g, h, w)
    out["k5b_err"] = float((got - want).abs().max())
    out["k5b_ms"] = [cs.cuda_time_ms(
        lambda: roi_pool_bwd_scatter(argmax, g, h, w), 20) for _ in range(3)]

    lib = _cuda.library("roi_pool_bwd")
    if hasattr(lib, "dbg_read"):
        stamps = np.zeros(8192 * 4, dtype=np.uint64)
        roi_pool_bwd_recompute(feats, rois, g)
        torch.cuda.synchronize()
        lib.dbg_read.argtypes = [ctypes.c_void_p]
        _cuda.check(lib.dbg_read(stamps.ctypes.data), "dbg_read")
        n_blocks = roi_pool_bwd_recompute_blocks(feats, rois)
        phases = np.diff(stamps.reshape(-1, 4)[:n_blocks].astype(np.int64),
                         axis=1) / 1e3
        out["k6_phase_us"] = {
            "mean": dict(zip(("copy_in", "rois", "write_out"),
                             phases.mean(0).tolist())),
            "max": dict(zip(("copy_in", "rois", "write_out"),
                            phases.max(0).tolist()))}
    print(os.path.basename(os.getcwd()), json.dumps(out), flush=True)
    return 0


def roi_pool_bwd_recompute_blocks(feats, rois) -> int:
    """Blocks of one kernel-6 launch on the slice route."""
    from two_stage_object_detection_tpu_torch.ops.roi_pool_max import (
        roi_pool_bwd_plan)
    b, h, w, c = feats.shape
    plan = roi_pool_bwd_plan("recompute", b, h, w, c, rois.shape[1],
                             feats.element_size())
    return b * plan["n_slices"]


if __name__ == "__main__":
    sys.exit(main())
