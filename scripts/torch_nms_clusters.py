#!/usr/bin/env python3
"""Time kernel 1 (``csrc/nms.cu``) of the PyTorch port at each cluster size
it can take, beside the one its launcher picks, on one GPU.

    python3 scripts/torch_nms_clusters.py [--json PATH]

For B in 1, 4 and 16 images and the flagship's predict (K=3000 -> 300) and
train (K=12,000 -> 600) shapes, on ``chip_smoke.py``'s rows: the cluster
size ``nms_pick_cluster`` chooses (the largest of 8, 4, 2, 1 of which the
card holds all B clusters at once), and for each size the kernel's device
time (CUDA events around 20 launches queued behind a sleep, so that the
host's launch cost is not timed) and whether its outputs equal the plain
version's bit for bit.  The last line is one JSON object.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def device_ms(fn, iters: int = 20) -> float:
    """Mean device time of ``fn()``: the launches are queued behind a
    ``torch.cuda._sleep`` long enough to cover the host's launch time."""
    import torch
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(int(2e8))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", help="also write the table here")
    args = ap.parse_args()
    import numpy as np
    import torch
    import chip_smoke as cs
    from two_stage_object_detection_tpu_torch.ops import _cuda
    from two_stage_object_detection_tpu_torch.ops import proposals as P

    if not torch.cuda.is_available():
        print("torch_nms_clusters: no CUDA device available", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    rows = []
    for b in (1, 4, 16):
        for k, n_post in cs.NMS_SHAPES:
            boxes, scores = cs.nms_inputs(np.random.RandomState(k), b, k, dev)
            want = P.greedy_nms_rows_reference(boxes, scores, n_post=n_post,
                                               iou_threshold=0.7)

            def run(cluster):
                out = (torch.empty((b, n_post, 4), device=dev),
                       torch.empty((b, n_post), device=dev),
                       torch.empty((b, n_post), dtype=torch.bool, device=dev),
                       torch.empty((b, n_post), dtype=torch.int32, device=dev))
                _cuda.launch("nms_launch", dev, boxes.data_ptr(),
                             scores.data_ptr(), b, k, k, n_post, 0.7, cluster,
                             *[t.data_ptr() for t in out], 0, None)
                return out

            picked = P._nms_cluster(dev.index, b, k)
            most = P.nms_cluster_size(k)
            sizes = sorted({most, *(c for c in (1, 2, 4, 8) if c <= most)})
            times = {}
            for c in sizes:
                equal = all(torch.equal(g, w) for g, w in zip(run(c), want))
                times[c] = {"ms": device_ms(lambda: run(c)), "bitwise": equal}
            rows.append({"B": b, "K": k, "n_post": n_post, "picked": picked,
                         "clusters": times})
            print(f"B={b} K={k} n_post={n_post}: picked {picked}; " + ", ".join(
                f"{c} blocks {t['ms']:.4f} ms{'' if t['bitwise'] else ' DIFFERS'}"
                for c, t in times.items()), flush=True)
            if not all(t["bitwise"] for t in times.values()):
                return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    result = {"card": smi, "rows": rows}
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(result, f, indent=1)
    print(smi)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
