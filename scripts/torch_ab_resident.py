#!/usr/bin/env python3
"""Time the PyTorch port's resident train loop in two checkouts of the
repository on the same GPU, in turns within one call, so that two versions
are compared under the same card, power limit and host load.

    python3 scripts/torch_ab_resident.py DIR_A DIR_B [--turns ABBA] [--json PATH]

Each turn is a fresh Python process whose working directory is the checkout:
it imports that checkout's package and ``chip_smoke`` helpers and, on the
128-image root of ``chip_smoke.py``'s drivers phase (the three committed
JPEGs listed again and again), prints

* ``epoch_ms``: the time a micro-step of each epoch after the first of
  ``train --flagship`` through the CLI with ``cache_device``,
  ``device_augment``, ``transfer_uint8`` and ``fused_accum`` on (b=16,
  ``grad_accum_steps=2``, 8 micro-steps an epoch, 5 epochs, an eval after
  the first), from the epoch records;
* ``bare_ms``: one ``train_step`` at a time on a batch gathered from the
  same cache, augmented on the card, the host waiting for the card after
  each (8 steps after 2 to warm up).

The last line is one JSON object with every turn.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

EPOCHS = 5


def worker() -> None:
    sys.path.insert(0, os.getcwd())
    import logging

    import torch
    import chip_smoke as cs
    from two_stage_object_detection_tpu_torch.__main__ import _load_cfg
    from two_stage_object_detection_tpu_torch.data.coco import load_coco
    from two_stage_object_detection_tpu_torch.data.device_cache import (
        DeviceDatasetCache)
    from two_stage_object_detection_tpu_torch.data.pipeline import (
        DetectionDataset)
    from two_stage_object_detection_tpu_torch.nets.trainer import (
        create_train_state, train_step)

    sets = [kv for kv in cs.DRIVER_SETS if not kv.startswith("num_epochs=")]
    sets += [f"num_epochs={EPOCHS}", *cs.RESIDENT_SETS]
    records = cs.Records()
    logging.getLogger("two_stage_object_detection_tpu_torch").addHandler(
        records)
    with tempfile.TemporaryDirectory() as tmp:
        root = cs.driver_data_root(os.path.join(tmp, "long"), cs.LONG_IMAGES)
        cs.run_cli(["train", "--flagship", "--data-root", root, "--weights",
                    os.path.join(tmp, "weights"),
                    *[a for kv in sets for a in ("--set", kv)],
                    "--eval-period", "100", "--no-viz"])
        epochs = [r for r in records.records if hasattr(r, "epoch")]
        cs.require(len(epochs) == EPOCHS
                   and all(r.loop == "resident" for r in epochs),
                   f"not {EPOCHS} resident epochs: {[r.loop for r in epochs]}")

        cfg = _load_cfg(argparse.Namespace(config=None, flagship=True,
                                           set=sets))
        idx = load_coco(os.path.join(root, "annotations",
                                     "instances_train2017.json"),
                        os.path.join(root, "train2017"), seed=None)
        ds = DetectionDataset(idx, cfg.input_size, cfg.max_gt_boxes,
                              decode_only=True, uint8_images=True)
        cache = DeviceDatasetCache(ds, cfg.batch_size, device=cfg.device)
        _, state = create_train_state(cfg, seed=0)
        batch = next(iter(cache))
        gen = torch.Generator(device=cache.device)
        times = []
        for i in range(10):
            gen.manual_seed(i)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            train_step(state, batch, gen, True)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
    out = {"epoch_ms": [r.seconds / r.micro_steps * 1e3 for r in epochs[1:]],
           "bare_ms": sum(times[2:]) / len(times[2:])}
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
        ms = res["epoch_ms"]
        print(f"{which}: resident loop " + ", ".join(f"{m:.1f}" for m in ms)
              + f" ms a micro-step (epochs 2-{EPOCHS}; mean "
              f"{sum(ms) / len(ms):.1f}, {16e3 * len(ms) / sum(ms):.1f} "
              f"img/s); bare micro-step {res['bare_ms']:.1f} ms", flush=True)
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
