#!/usr/bin/env python3
"""Time the PyTorch port's ``Predictor(spatial=True)`` in two checkouts of
the repository on the same GPU, in turns within one call, so that two
versions are compared under the same card, power limit and host load.

    python3 scripts/torch_ab_spatial_predict.py DIR_A DIR_B [--turns ABBA] [--json PATH]

Each turn is a fresh Python process whose working directory is the checkout:
it imports that checkout's package and ``chip_smoke`` helpers, builds that
checkout's kernels and, as ``chip_smoke.py``'s spatial phase does (float32,
TF32 off, seeded random weights, one 600x600 request; here every detection
kept, ``score_thresh=0``), prints the host time of a request (median of 7
after one to warm up, outputs on the host) of

* the plain ``Predictor``;
* ``Predictor(spatial=True)`` over ``(1, 2)`` and ``(1, 4)`` meshes of the
  card's one device for the flagship, ``(1, 2)`` for the single scale.

Every shard shares the one card, so no time is a multi-card speed.  The
last line is one JSON object with every turn.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

SHARDS = {"flagship": (2, 4), "single-scale": (2,)}


def worker() -> None:
    sys.path.insert(0, os.getcwd())
    import numpy as np
    import torch
    import chip_smoke as cs
    from two_stage_object_detection_tpu_torch.config import Config
    from two_stage_object_detection_tpu_torch.nets.trainer import (
        create_train_state)
    from two_stage_object_detection_tpu_torch.ops._cuda import build_all
    from two_stage_object_detection_tpu_torch.parallel.mesh import make_mesh
    from two_stage_object_detection_tpu_torch.serving import Predictor

    build_all()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    out = {}
    for label, cfg in (("flagship", Config(fpn=True, backbone="resnet50",
                                           loc_normalize=True)),
                       ("single-scale", Config())):
        c32 = cfg.replace(compute_dtype="float32", score_thresh=0.0)
        model, _ = create_train_state(c32, seed=0)
        x = cs.train_batch(np.random.RandomState(12), c32, 1,
                           wire="f32")["image"]
        plain = Predictor(c32, model, batch_sizes=(1,))
        want = plain(x)
        res = {"plain_ms": cs.host_ms(lambda: plain(x), 7)}
        for n in SHARDS[label]:
            sp = Predictor(c32, model, batch_sizes=(1,), spatial=True,
                           mesh=make_mesh(1, n, devices=["cuda:0"] * n))
            got = sp(x)
            assert np.array_equal(got["valid"], want["valid"]), (label, n)
            res[f"1x{n}_ms"] = cs.host_ms(lambda: sp(x), 7)
            del sp
        out[label] = res
        del model, plain
        torch.cuda.empty_cache()
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
            print(f"{which} {label}: " + ", ".join(
                f"{k} {v:.1f}" for k, v in r.items()), flush=True)
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
