#!/usr/bin/env python3
"""Time kernels 1, 2, 3, 5, 6 and 5b of the PyTorch port in two checkouts of the
repository on the same GPU, in turns within one call, so that two designs
are compared under the same card, power limit and host load.

    python3 scripts/torch_ab_kernels.py DIR_A DIR_B [--turns ABBA] [--json PATH]

Each turn is a fresh Python process whose working directory is the
checkout: it builds that checkout's kernels and times, with CUDA events,

* ``greedy_nms`` (kernel 1) at B=16, K=3000 -> 300 (predict) and
  K=12,000 -> 600 (train), 50 and 20 launches, and at the post-process's
  K=400 -> 100 (its IoU threshold), 50 launches, each also as the
  kernel's own time in ``torch.profiler``'s device records (``kernel_ms``:
  a launch this small is paced by the host);
* ``windowed_roi_align_batched`` (kernel 2) at B=16, R=300 (predict) and
  R=128 (train), C=256 bf16 over P2..P5 of a 600x600 image, 20 launches;
* ``fused_proposals_batched`` (kernel 3) at B=16 over the 12,996 anchors
  of ``Config()``, n_post 300 (predict) and 600 (train), 20 launches;
* ``roi_pool_max`` (kernel 5) at B=16, 38x38x512 bf16, P=7: R=300 with and
  without the index store, and R=128 with it, 20 launches;
* ``roi_pool_bwd_recompute`` (kernel 6, from a bf16 map) and
  ``roi_pool_bwd_scatter`` (kernel 5b) at B=16, R=128, 38x38x512, P=7,
  f32 cotangent, 20 launches.

The inputs come from this script's own ``chip_smoke.py`` (``nms_inputs``,
``align_inputs``, ``fused_inputs``, ``roi_pool_inputs``,
``roi_pool_bwd_inputs``) with a fixed seed per shape, so both checkouts get
the same data; a checksum of each output shows that they compute the same
thing (kernels 2, 6 and 5b up to the rounding of their sums).
The last line is one JSON object with every turn.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def worker() -> None:
    sys.path.insert(0, os.getcwd())
    import numpy as np
    import torch
    from two_stage_object_detection_tpu_torch.config import Config
    from two_stage_object_detection_tpu_torch.ops import _cuda
    from two_stage_object_detection_tpu_torch.ops.proposals import (
        fused_proposals_batched, greedy_nms)
    from two_stage_object_detection_tpu_torch.ops.roi_pool_bwd import (
        roi_pool_bwd_recompute)
    from two_stage_object_detection_tpu_torch.ops.roi_pool_max import (
        roi_pool_bwd_scatter, roi_pool_max)
    from two_stage_object_detection_tpu_torch.ops.windowed_align import (
        windowed_roi_align_batched)

    spec = importlib.util.spec_from_file_location(
        "ab_inputs", os.path.join(HERE, "..", "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    _cuda.build_all()
    dev = torch.device("cuda")
    out = {}
    for k, n_post in cs.NMS_SHAPES:
        boxes, scores = cs.nms_inputs(np.random.RandomState(k), 16, k, dev)
        run = lambda: greedy_nms(boxes, scores, n_post=n_post,  # noqa: E731
                                 iou_threshold=0.7)
        got = run()
        out[f"greedy_nms_K{k}"] = {
            "ms": cs.cuda_time_ms(run, 50 if k <= 3000 else 20),
            "kernel_ms": cs.kernel_ms(run, "nms_cluster_kernel",
                                      50 if k <= 3000 else 20),
            "kept": int(got[2].sum()),
            "checksum": float(got[0].double().sum())}
    k, n_post = cs.POST_NMS_SHAPE
    boxes, scores = cs.nms_inputs(np.random.RandomState(k), 16, k, dev)
    run = lambda: greedy_nms(boxes, scores, n_post=n_post,  # noqa: E731
                             iou_threshold=Config().predict_nms_iou)
    got = run()
    out[f"greedy_nms_K{k}_post"] = {
        "ms": cs.cuda_time_ms(run, 50),
        "kernel_ms": cs.kernel_ms(run, "nms_cluster_kernel", 50),
        "kept": int(got[2].sum()),
        "checksum": float(got[0].double().sum())}
    for r in cs.ALIGN_ROIS:
        pyr, rois, levels, scales = cs.align_inputs(
            np.random.RandomState(r), dev, torch.bfloat16, r=r)
        run = lambda: windowed_roi_align_batched(  # noqa: E731
            pyr, rois, levels, scales)
        got = run()
        out[f"windowed_align_R{r}"] = {
            "ms": cs.cuda_time_ms(run, 20),
            "checksum": float(got.double().sum())}
        del pyr, got
        torch.cuda.empty_cache()
    cfg = Config()
    locs, fg, anchors = cs.fused_inputs(np.random.RandomState(3), 16, dev, cfg)
    for n_post in (300, 600):
        run = lambda: fused_proposals_batched(  # noqa: E731
            locs, fg, anchors, cfg.input_size, nms_iou=0.7,
            n_post_nms=n_post, min_size=16.0)
        got = run()
        out[f"fused_proposals_N{locs.shape[1]}_post{n_post}"] = {
            "ms": cs.cuda_time_ms(run, 20), "kept": int(got[2].sum()),
            "checksum": float(got[0].double().sum())}
    for r, with_argmax in ((300, True), (300, False), (128, True)):
        feats, rois = cs.roi_pool_inputs(np.random.RandomState(r), dev, r=r)
        run = lambda: roi_pool_max(  # noqa: E731
            feats, rois, with_argmax=with_argmax)
        got = run()
        out[f"roi_pool_max_R{r}{'' if with_argmax else '_values_only'}"] = {
            "ms": cs.cuda_time_ms(run, 20),
            "checksum": float(got[0].double().sum())
            + (float(got[1].double().sum()) if with_argmax else 0.0)}
        del feats, got
        torch.cuda.empty_cache()
    feats32, rois, g = cs.roi_pool_bwd_inputs(np.random.RandomState(6), dev)
    feats = feats32.to(torch.bfloat16)
    argmax = roi_pool_max(feats32, rois, with_argmax=True)[1]
    h, w = feats.shape[1:3]
    for name, run in (
            ("roi_pool_bwd_recompute_R128",
             lambda: roi_pool_bwd_recompute(feats, rois, g)),
            ("roi_pool_bwd_scatter_R128",
             lambda: roi_pool_bwd_scatter(argmax, g, h, w))):
        got = run()
        out[name] = {"ms": cs.cuda_time_ms(run, 20),
                     "checksum": float(got.double().sum())}
        del got
    print("AB_RESULT " + json.dumps(out), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("dir_a")
    ap.add_argument("dir_b")
    ap.add_argument("--turns", default="ABBA")
    ap.add_argument("--json", help="also write the turns here")
    args = ap.parse_args()
    dirs = {"A": os.path.abspath(args.dir_a), "B": os.path.abspath(args.dir_b)}
    me = os.path.abspath(__file__)
    turns = []
    for which in args.turns:
        run = subprocess.run([sys.executable, me, "--worker"], cwd=dirs[which],
                             capture_output=True, text=True)
        lines = [ln for ln in run.stdout.splitlines()
                 if ln.startswith("AB_RESULT ")]
        if run.returncode or not lines:
            print(run.stdout[-2000:], run.stderr[-4000:], file=sys.stderr)
            return 1
        res = json.loads(lines[-1][len("AB_RESULT "):])
        turns.append({"tree": which, "dir": dirs[which], **res})
        print(f"{which}: " + ", ".join(
            f"{name} {r['ms']:.4f} ms" + (
                f" (kernel {r['kernel_ms']:.4f} ms)" if r.get("kernel_ms")
                else "") for name, r in res.items()), flush=True)
    for name in turns[0]:
        if name in ("tree", "dir"):
            continue
        sums = [t[name]["checksum"] for t in turns]
        spread = (max(sums) - min(sums)) / max(max(map(abs, sums)), 1e-30)
        print(f"{name}: output checksums {sums} (relative spread "
              f"{spread:.2e}; kernel 2 rounds its f32 sums to bf16 and "
              "kernels 6 and 5b add in no fixed order, so two designs may "
              "differ by their rounding; kernels 1, 3 and 5 must agree "
              "exactly)")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    result = {"card": smi, "turns": turns}
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(result, f, indent=1)
    print(smi)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    if sys.argv[1:] == ["--worker"]:
        worker()
        sys.exit(0)
    sys.exit(main())
