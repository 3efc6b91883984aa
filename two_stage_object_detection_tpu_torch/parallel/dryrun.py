"""Multi-rank dry run on the CPU: the data and model axes, in N processes.

    python -m two_stage_object_detection_tpu_torch.parallel.dryrun N

The port's counterpart of the JAX package's ``parallel/dryrun.py``, for its
data-axis sections.  It spawns N ranks, each a gloo process on the CPU
joined over a file store in a temporary directory, and runs in each, on a
tiny config:

* ``dp``: one data-parallel ``train_step`` (the rank's rows of a global
  batch, cross-replica batch norm, the gradient all-reduce), then checks
  that the ranks hold the same parameters;
* ``resident``: one data-parallel ``train_macro_step_resident`` cycle over
  a dataset every rank holds, each gathering its shard of the epoch;
* ``predict``: each rank predicts its rows of a batch, and the detections
  are gathered (``fetch_global``);
* ``dp+tp``: one ``train_step`` on the JAX dryrun's ``(data, model)`` mesh
  (a model axis of 2 when N is even, else 1): each data index's rows of
  the global batch, the dense heads split over each model group; then
  checks that each data group holds the same state and each model group
  the same replicated parameters;
* ``fpn``: the same on the FPN variant of the JAX dryrun (ResNet-10, a
  16-channel pyramid, a 32-wide box head);
* ``spatial``: the data + spatial mesh of the JAX dryrun (a model axis of
  up to 4 ranks that divides N and the 64-row images): one ``train_step``
  on each rank's rows (``shard_batch_spatial``, halo exchanges over the
  model group, batch norm over the whole mesh, replicated parameters),
  then a true predict on the same rows; prints the loss and the
  detections, and checks that every rank holds the same state.

Rank 0 prints each section's seconds.
"""

from __future__ import annotations

import os
import sys
import tempfile
import time


def _rank(rank: int, world: int, store: str) -> None:
    import numpy as np
    import torch

    from two_stage_object_detection_tpu_torch.config import Config
    from two_stage_object_detection_tpu_torch.data.pipeline import epoch_order
    from two_stage_object_detection_tpu_torch.nets.trainer import (
        create_train_state, predict_step, train_macro_step_resident,
        train_step)
    from two_stage_object_detection_tpu_torch.parallel.mesh import (
        assert_replicated, make_mesh, place_train_state, shard_batch,
        shard_batch_spatial, state_tensors)
    from two_stage_object_detection_tpu_torch.parallel.multiprocess import (
        fetch_global, init_distributed)
    from two_stage_object_detection_tpu_torch.train import step_generator

    torch.set_num_threads(1)
    init_distributed(f"file://{store}", world, rank, device="cpu")
    t_last = [time.monotonic()]

    def section_done(name: str, note: str) -> None:
        now = time.monotonic()
        if rank == 0:
            print(f"dryrun {name}: ranks={world} {note} OK", flush=True)
            print(f"[dryrun timing] {name}: {now - t_last[0]:.1f}s",
                  flush=True)
        t_last[0] = now

    b = 2                                            # a rank's batch
    cfg = Config(input_size=(64, 64), num_classes=3, batch_size=b,
                 max_gt_boxes=4, n_train_pre_nms=64, n_train_post_nms=16,
                 n_test_pre_nms=32, n_test_post_nms=8, roi_n_sample=8,
                 rpn_n_sample=16, grad_accum_steps=1,
                 compute_dtype="float32", device="cpu")
    mesh = make_mesh(devices=["cpu"])
    _, state = create_train_state(cfg, seed=0)
    place_train_state(state, mesh, debug=True)

    rng = np.random.RandomState(0)
    n, g = 2 * b * world, cfg.max_gt_boxes
    data = {"image": rng.rand(n, 64, 64, 3).astype(np.float32),
            "boxes": np.tile(np.array([[8.0, 8.0, 40.0, 40.0]], np.float32),
                             (n, g, 1)),
            "labels": np.zeros((n, g), np.int32),
            "valid": np.tile(np.array([True] + [False] * (g - 1)), (n, 1))}
    full = {k: v[:b * world] for k, v in data.items()}
    _, losses = train_step(state, shard_batch(full, mesh, local=False))
    assert np.isfinite(float(losses["total"])), losses
    assert_replicated(state_tensors(state), mesh.group)
    section_done("dp", f"loss={float(losses['total']):.4f}")

    # every rank holds the whole dataset and gathers its strided shard
    resident = {k: torch.from_numpy(v) for k, v in data.items()}
    order = epoch_order(n, 0, 0, True, world, rank)
    idx = order[:len(order) // b * b].reshape(-1, b)[:1]
    gens = [step_generator(0, 0, 0, "cpu", rank)]
    _, totals = train_macro_step_resident(state, resident, idx, gens,
                                          device_augment=True)
    assert bool(torch.isfinite(totals).all()), totals
    assert_replicated(state_tensors(state), mesh.group)
    section_done("resident", f"losses={totals.tolist()}")

    mine = shard_batch({"image": full["image"]}, mesh, local=False)
    boxes, scores, labels, valid = fetch_global(
        predict_step(state, mine["image"]))
    assert boxes.shape == (b * world, cfg.max_detections, 4)
    assert np.isfinite(boxes).all() and np.isfinite(scores).all()
    section_done("predict", f"detections={int(valid.sum())}")

    n_model = 2 if world % 2 == 0 else 1
    tp_mesh = make_mesh(world // n_model, n_model, devices=["cpu"])
    rows = slice(tp_mesh.data_index * b, (tp_mesh.data_index + 1) * b)
    for name, c in (("dp+tp", cfg),
                    ("fpn", cfg.replace(fpn=True, fpn_channels=16,
                                        fpn_fc_dim=32, backbone="resnet10"))):
        _, st = create_train_state(c, seed=0)
        place_train_state(st, tp_mesh, debug=True)
        _, losses = train_step(st, {k: v[rows] for k, v in full.items()})
        assert np.isfinite(float(losses["total"])), losses
        assert_replicated(state_tensors(st), tp_mesh.group)
        if tp_mesh.model_group is not None:
            assert_replicated(state_tensors(st, replicated_only=True),
                              tp_mesh.model_group)
        section_done(name, f"mesh={tp_mesh.shape} "
                     f"loss={float(losses['total']):.4f}")

    # image rows over 'model': 64-row images, so at most 4 row shards
    n_model_s = max(m for m in (1, 2, 4) if world % m == 0)
    s_mesh = make_mesh(world // n_model_s, n_model_s, devices=["cpu"])
    _, st = create_train_state(cfg, seed=0)
    place_train_state(st, s_mesh, debug=True, spatial=True)
    batch_sp = shard_batch_spatial(
        {k: v[:b * s_mesh.shape["data"]] for k, v in full.items()}, s_mesh,
        local=False)
    _, losses = train_step(st, batch_sp)
    assert np.isfinite(float(losses["total"])), losses
    assert_replicated(state_tensors(st))
    preds = fetch_global(predict_step(st, batch_sp["image"]), s_mesh.group)
    section_done("spatial", f"mesh={s_mesh.shape} "
                 f"loss={float(losses['total']):.4f} "
                 f"predict_dets={int(preds[3].sum())}")


def run_dryrun(world: int) -> None:
    """Spawn ``world`` gloo ranks on the CPU and run the sections; raises
    if a rank fails."""
    import torch.multiprocessing as mp
    t0 = time.monotonic()
    with tempfile.TemporaryDirectory() as tmp:
        mp.start_processes(_rank, args=(world, os.path.join(tmp, "store")),
                           nprocs=world, start_method="spawn")
    print(f"dryrun({world}): data, model and spatial axes OK in "
          f"{time.monotonic() - t0:.1f}s", flush=True)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    run_dryrun(int(argv[0]) if argv else 2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
