#!/usr/bin/env python3
"""The port's data-parallel train step over several GPUs, one process each.

    torchrun --nproc-per-node 4 scripts/torch_dp_nccl.py [--json PATH]
    torchrun --nproc-per-node 4 scripts/torch_dp_nccl.py --device cpu --tiny

Each rank (``nccl`` on ``cuda:LOCAL_RANK``; ``gloo`` with ``--device cpu``)
builds the flagship at full width in float32 (TF32 off, cuDNN
deterministic), takes rank 0's weights (``place_train_state``), and:

* evaluates two global batches of ``8 x world`` images through the train
  graph, each split over the ranks and gathered;
* runs two micro-steps and one update (``grad_accum_steps=2``) on its 8
  rows of two global batches, timed, kernels 1 and 2 counted, then holds
  the ranks' states equal bit for bit;
* times the gradient all-reduce on its bytes, and polls
  ``should_stop(sync=True)`` with the last rank asking at poll 3.

Then rank 0 alone runs the same update in one process at ``b = 8 x world``
on the same batches, and once more on each batch's images in reverse order
(the same mathematical gradient, rounded another way: the control), and
holds the ranks against it with ``chip_smoke.py``'s data-parallel
tolerances; its eval of the same blocks of 8 must equal the ranks' bit for
bit.  ``--tiny`` shrinks the model for a rehearsal on the CPU.  Prints the
card's name and power limit beside every number; exits nonzero if a check
fails.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402

PER_RANK = 8
TINY = dict(input_size=(64, 64), num_classes=3, max_gt_boxes=8,
            n_train_pre_nms=128, n_train_post_nms=32, n_test_pre_nms=64,
            n_test_post_nms=16, roi_n_sample=8, rpn_n_sample=32,
            max_detections=8, fpn_channels=32, fpn_fc_dim=64,
            backbone="resnet10")


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--json")
    args = ap.parse_args()

    from two_stage_object_detection_tpu_torch.eval.evaluator import (
        collect_predictions)
    from two_stage_object_detection_tpu_torch.nets.trainer import (
        create_train_state, train_step)
    from two_stage_object_detection_tpu_torch.parallel.mesh import (
        assert_replicated, make_mesh, place_train_state, state_tensors)
    from two_stage_object_detection_tpu_torch.parallel.multiprocess import (
        all_reduce_, barrier, init_distributed, rank, world_size)
    from two_stage_object_detection_tpu_torch.utils.preemption import (
        PreemptionGuard)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    if args.device == "cpu":
        torch.set_num_threads(1)
    init_distributed(device=args.device)
    r, world = rank(), world_size()
    mesh = make_mesh(devices=[args.device])
    dev = mesh.device
    backend = torch.distributed.get_backend()
    card = "cpu"
    if dev.type == "cuda":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", f"--id={dev.index}"],
            capture_output=True, text=True, check=True).stdout.strip()
    cfg = cs.dp_config().replace(device=str(dev), **(TINY if args.tiny
                                                     else {}))
    n = PER_RANK * world
    rng = np.random.RandomState(20)          # the same batches on every rank
    train_b = [cs.train_batch(rng, cfg, n) for _ in range(2)]
    eval_b = [cs.train_batch(rng, cfg, n) for _ in range(2)]
    rows = slice(r * PER_RANK, (r + 1) * PER_RANK)

    model, state = create_train_state(cfg, seed=r)       # rank 0's wins
    place_train_state(state, mesh, debug=True)
    t0 = time.perf_counter()
    preds, _, eval_loss = collect_predictions(state, eval_b, cfg)
    eval_s = time.perf_counter() - t0

    grads = {}
    state.optimizer.register_step_pre_hook(cs._grad_hook(model, grads))
    cs.reset_launches()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    step_ms, losses = [], []
    for g in train_b:
        _sync(dev)
        t0 = time.perf_counter()
        _, out = train_step(state, {k: v[rows] for k, v in g.items()})
        _sync(dev)
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append({k: float(v) for k, v in out.items()})
    launches = cs.launch_counts()
    peak = (torch.cuda.max_memory_allocated(dev) / 1e9
            if dev.type == "cuda" else None)
    cs.require(state.updates == 1, "one update")
    assert_replicated(state_tensors(state), mesh.group)
    if not args.tiny:
        for name in ("greedy_nms", "windowed_align"):
            cs.require(launches[name] > 0, f"rank {r} never launched {name}")

    n_params = sum(p.numel() for p in model.parameters())
    flat = torch.ones(n_params, device=dev)
    all_reduce_(flat, "sum", mesh.group)
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(5):
        all_reduce_(flat, "sum", mesh.group)
    _sync(dev)
    allreduce_ms = (time.perf_counter() - t0) * 1e3 / 5

    guard = PreemptionGuard(sync_every=2)
    stopped = None
    for poll in range(1, 20):
        if r == world - 1 and poll == 3:
            guard.request()
        if guard.should_stop(sync=True):
            stopped = poll
            break
    cs.require(stopped == 4, f"rank {r} stopped at poll {stopped}")
    mine = {"rank": r, "device": str(dev), "card": card,
            "step_ms": step_ms, "allreduce_ms": allreduce_ms,
            "allreduce_bytes": n_params * 4, "peak_gb": peak,
            "launches": launches, "eval_s": eval_s}
    print(json.dumps(mine), flush=True)
    total = torch.tensor([ls["total"] for ls in losses], dtype=torch.float64,
                         device=dev)
    dp_losses = (all_reduce_(total, "sum", mesh.group) / world).tolist()
    dp_grads = {k: v.cpu() for k, v in grads.items()}
    dp_params = {k: v.cpu() for k, v in model.state_dict().items()}
    del model, state, flat
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    barrier(mesh.group)
    torch.distributed.destroy_process_group()
    if r != 0:
        return 0

    # rank 0 alone: one process over the global batches, and the control
    one = cfg.replace(batch_size=n)
    blocks = [{k: v[i:i + PER_RANK] for k, v in b.items()}
              for b in eval_b for i in range(0, n, PER_RANK)]
    model, state = create_train_state(one, seed=0)
    ref_preds, _, ref_eval_loss = collect_predictions(state, blocks, one)
    results = []
    for order in (1, -1):
        model, state = create_train_state(one, seed=0)
        g_ref, ms = {}, []
        state.optimizer.register_step_pre_hook(cs._grad_hook(model, g_ref))
        ls = []
        for b in train_b:
            _sync(dev)
            t0 = time.perf_counter()
            _, o = train_step(state, {k: v[::order].copy()
                                      for k, v in b.items()})
            _sync(dev)
            ms.append((time.perf_counter() - t0) * 1e3)
            ls.append(float(o["total"]))
        results.append({"grads": {k: v.cpu() for k, v in g_ref.items()},
                        "params": {k: v.cpu() for k, v
                                   in model.state_dict().items()},
                        "ms": ms, "losses": ls})
        del model, state
    ref, ctl = results
    names = sorted(ref["grads"])
    cs.require(sorted(dp_grads) == names, "another set of gradients")
    dp_err = cs._rel_by_module(dp_grads, ref["grads"], names)
    ctl_err = cs._rel_by_module(ctl["grads"], ref["grads"], names)
    p_dp, p_1 = cs._flat(dp_params, names), cs._flat(ref["params"], names)
    close = float(((p_dp - p_1).abs() <= 1e-5 + 1e-5 * p_1.abs())
                  .double().mean())
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(dp_losses,
                                                       ref["losses"]))
    stat_err = max(float((dp_params[k] - ref["params"][k]).abs().max())
                   for k in ref["params"]
                   if k.endswith(("running_mean", "running_var")))
    same_eval = len(preds) == len(ref_preds) and all(
        all(np.array_equal(x, y) for x, y in zip(a, b))
        for a, b in zip(preds, ref_preds))
    summary = {"world": world, "backend": backend, "card": card,
               "per_rank": PER_RANK, "grad_rel_by_module": dp_err,
               "control_rel_by_module": ctl_err, "param_close_share": close,
               "loss_rel_err": loss_rel, "stat_err": stat_err,
               "eval_equal": same_eval,
               "eval_loss_diff": abs(eval_loss - ref_eval_loss),
               "one_process_step_ms": ref["ms"], "rank0": mine}
    print(f"{world} ranks ({backend}, {card}): gradient against one process "
          f"at b={n}, relative error by module (control): " + ", ".join(
              f"{k} {dp_err[k]:.2e} ({ctl_err[k]:.2e})" for k in dp_err)
          + f"; {close:.6f} of parameters within 1e-5 + 1e-5 |p|; loss "
          f"{loss_rel:.2e} relative; statistics within {stat_err:.2e}; "
          f"eval split equal bit for bit: {same_eval}; one process "
          f"micro-step ms {[round(t, 1) for t in ref['ms']]}", flush=True)
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)),
                    exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(summary, f, indent=1)
    cs.require(dp_err["all"] <= 2e-2, "the gradient differs")
    cs.require(close >= 0.99, "the update differs")
    cs.require(loss_rel <= 1e-3, "the losses differ")
    cs.require(stat_err <= 1e-5, "the statistics differ")
    cs.require(same_eval, "the eval split differs from one process")
    cs.require(abs(eval_loss - ref_eval_loss)
               <= 1e-6 * max(1.0, abs(ref_eval_loss)), "the eval loss")
    return 0


if __name__ == "__main__":
    sys.exit(main())
