#!/usr/bin/env python3
"""Where the box head's time goes on each RoI route of the PyTorch port, on
one NVIDIA GPU, at full width (600x600, b=16, bfloat16, seeded random
weights):

    python3 scripts/torch_profile_roi_routes.py [--json PATH]

For the flagship on its kernel route (windowed, kernel 2) and dense route
(``fpn_roi_window=0``), and the single-scale ``Config()`` with
``roi_pool_mode`` ``pool`` (kernel 5), ``align`` and ``mean``: the predict
``roi_head`` over the model's own 300 proposals an image, and the train
route's forward + backward over 128 rois an image, each timed with CUDA
events (10 calls) and traced with ``torch.profiler`` (3 calls): the device
time of the ten costliest operations by name.  The card's name and power
limit come first; the last line is one JSON object with every number.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def top_ops(fn, calls: int = 3, n: int = 10):
    """The ``n`` operations with the most device time over ``calls`` calls of
    ``fn``, as ``[(name, ms a call, count a call)]``, and the total."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    # the device's own events (kernels, copies), not the host operations
    # whose device time sums their kernels'
    kernels = [(e.key, e.device_time_total / 1e3 / calls, e.count // calls)
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.device_time_total > 0]
    kernels.sort(key=lambda r: -r[1])
    return kernels[:n], sum(r[1] for r in kernels)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", help="also write the numbers here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device available", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from two_stage_object_detection_tpu_torch.config import Config
    from two_stage_object_detection_tpu_torch.nets.detector import FasterRCNN
    from two_stage_object_detection_tpu_torch.nets.targets import (
        proposal_target)
    from two_stage_object_detection_tpu_torch.ops import _cuda

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}; torch {torch.__version__}", flush=True)
    _cuda.build_all()
    flagship = Config(fpn=True, backbone="resnet50", loc_normalize=True)
    routes = {"flagship windowed (kernel 2)": flagship,
              "flagship dense": flagship.replace(fpn_roi_window=0),
              "single-scale pool (kernel 5)": Config(roi_bwd="pallas"),
              "single-scale align": Config(roi_pool_mode="align"),
              "single-scale mean": Config(roi_pool_mode="mean")}
    rng = np.random.RandomState(0)
    out = {"card": smi}
    for label, cfg in routes.items():
        model = FasterRCNN(cfg, seed=0)
        h, w = cfg.input_size
        x = torch.from_numpy(rng.rand(16, h, w, 3).astype(np.float32)).cuda()
        batch = cs.train_batch(rng, cfg, 16)
        b = {k: torch.from_numpy(v).cuda() for k, v in batch.items()}
        img = (h, w)
        with torch.no_grad():
            feats = model.features(x)
            rois = model.proposals(*model.rpn_head(feats), img)[0]
            rois_t, _, valid_t = model.proposals(*model.rpn_head(feats), img,
                                                 1.0, True)
            sample = proposal_target(rois_t, valid_t, b["boxes"], b["valid"],
                                     b["labels"],
                                     n_sample=cfg.roi_n_sample)[0]
        feats = (tuple(f.detach().requires_grad_(True) for f in feats)
                 if cfg.fpn else feats.detach().requires_grad_(True))

        def predict():
            with torch.inference_mode():
                model.roi_head(feats, rois, img)

        def train():
            kw = {"use_window": False} if cfg.fpn else {}
            locs, scores = model.roi_head(feats, sample, img, **kw)
            (locs.float().sum() + scores.float().sum()).backward()

        model.set_mode(True)
        row = {}
        for name, fn in (("predict", predict), ("train_fwd_bwd", train)):
            ms = cs.cuda_time_ms(fn, 10)
            ops, total = top_ops(fn)
            row[name] = {"ms": ms, "traced_kernel_ms": total,
                         "top": [{"name": k, "ms": t, "count": c}
                                 for k, t, c in ops]}
            print(f"{label} {name}: {ms:.3f} ms (CUDA events); traced kernels "
                  f"{total:.3f} ms a call; costliest:", flush=True)
            for k, t, c in ops:
                print(f"    {t:8.3f} ms  x{c:<4d} {k[:110]}", flush=True)
        out[label] = row
        del model, feats
        torch.cuda.empty_cache()
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
