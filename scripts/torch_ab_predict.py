#!/usr/bin/env python3
"""Time the PyTorch port's b=16 predict in two checkouts of the repository
on the same GPU, in turns within one call, so that two versions are compared
under the same card, power limit and host load.

    python3 scripts/torch_ab_predict.py DIR_A DIR_B [--turns ABBA] [--json PATH]

Each turn is a fresh Python process whose working directory is the checkout:
it imports that checkout's package and ``chip_smoke`` helpers, builds that
checkout's kernels, and for both served models (the FPN flagship and the
single-scale ``Config()``, full width, bfloat16, seeded random weights) prints

* ``device_ms``: CUDA events around 20 back-to-back ``predict`` calls;
* ``host_ms``: host time until ``predict`` returns, the device left to run
  (where this is close to ``device_ms`` the host, not the card, sets the
  time: it cannot make the launches any faster);
* ``stages_ms``: the checkout's own ``chip_smoke.stage_times``;
* ``roi_head_ms``: the box head alone over 100 calls.

The last line is one JSON object with every turn.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time


def worker() -> None:
    sys.path.insert(0, os.getcwd())
    import numpy as np
    import torch
    import chip_smoke as cs
    from two_stage_object_detection_tpu_torch.config import Config
    from two_stage_object_detection_tpu_torch.nets.detector import FasterRCNN

    out = {}
    for label, cfg in (("flagship", Config(fpn=True, backbone="resnet50",
                                           loc_normalize=True)),
                       ("single-scale", Config())):
        model = FasterRCNN(cfg, seed=0)
        h, w = cfg.input_size
        x = torch.from_numpy(np.random.RandomState(0).rand(16, h, w, 3).astype(
            np.float32)).to(model.device)
        device_ms = cs.cuda_time_ms(lambda: model.predict(x), 20, warmup=3)
        host = []
        for _ in range(20):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model.predict(x)
            host.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        with torch.inference_mode():
            feats = model.features(x)
            rois = model.proposals(*model.rpn_head(feats), (h, w))[0]
            head_ms = cs.cuda_time_ms(
                lambda: model.roi_head(feats, rois, (h, w)), 100)
        out[label] = {"device_ms": device_ms,
                      "host_ms": sum(host) / len(host),
                      "roi_head_ms": head_ms,
                      "stages_ms": cs.stage_times(model, x)}
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
        for label, r in res.items():
            print(f"{which} {label}: device {r['device_ms']:.2f} ms, host "
                  f"{r['host_ms']:.2f} ms, roi_head {r['roi_head_ms']:.4f} ms, "
                  "stages " + ", ".join(f"{k} {v:.2f}" for k, v
                                        in r["stages_ms"].items()), flush=True)
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
