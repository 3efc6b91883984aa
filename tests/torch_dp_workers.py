"""Ranks for the port's parallel tests (``tests/test_torch_parallel*.py``).

:func:`spawn` starts ``world`` processes (the ``spawn`` start method), each
joining a gloo group over a file store under the test's temporary
directory (no TCP port to race for between test workers), runs one of the
functions below with one torch thread, and hands back each rank's result.
This module imports no JAX: the ranks run the port alone, and the tests
hold what they return against the JAX package.
"""

from __future__ import annotations

import os
import traceback

import numpy as np
import torch


def spawn(fn, world: int, tmp: str, *args, timeout: float = 240.0) -> list:
    """Run ``fn(rank, world, tmp, *args)`` in ``world`` gloo ranks; returns
    their results in rank order.  Fails on a rank's exception (its
    traceback in the message), a nonzero exit or the timeout."""
    import multiprocessing
    ctx = multiprocessing.get_context("spawn")
    os.makedirs(tmp, exist_ok=True)
    procs = [ctx.Process(target=_entry, args=(fn.__name__, r, world, tmp,
                                              args)) for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout)
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
        p.join(10)
    errors = []
    for r in range(world):
        err = os.path.join(tmp, f"error{r}.txt")
        if os.path.exists(err):
            with open(err) as f:
                errors.append(f"rank {r}:\n{f.read()}")
    assert not alive, f"{len(alive)} rank(s) still running after {timeout} s"
    assert not errors, "\n".join(errors)
    assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
    return [torch.load(os.path.join(tmp, f"out{r}.pt"), weights_only=False)
            for r in range(world)]


def _entry(name, rank, world, tmp, args):
    from two_stage_object_detection_tpu_torch.parallel.multiprocess import (
        init_distributed)
    torch.set_num_threads(1)
    try:
        init_distributed(f"file://{tmp}/store", world, rank, device="cpu")
        out = globals()[name](rank, world, tmp, *args)
        torch.save(out, os.path.join(tmp, f"out{rank}.pt"))
    except BaseException:
        with open(os.path.join(tmp, f"error{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        import torch.distributed as dist
        if dist.is_initialized():
            dist.destroy_process_group()


# ------------------------------------------------------------- the ranks
def batch_norm_rank(rank, world, tmp, x, dy, weight, bias):
    """The cross-replica layer on this rank's rows of ``x`` (global
    ``[N, C, H, W]``), backward from ``dy``'s rows: output, input gradient,
    the weight and bias gradients summed over the ranks, the running
    statistics."""
    from two_stage_object_detection_tpu_torch.models.layers import (
        BatchNorm, set_data_group)
    from two_stage_object_detection_tpu_torch.parallel.multiprocess import (
        all_reduce_)
    import torch.distributed as dist
    b = x.shape[0] // world
    rows = slice(rank * b, (rank + 1) * b)
    bn = BatchNorm(x.shape[1]).train()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(weight))
        bn.bias.copy_(torch.from_numpy(bias))
    set_data_group(bn, dist.group.WORLD)
    xr = torch.from_numpy(x[rows]).requires_grad_()
    y = bn(xr)
    (y * torch.from_numpy(dy[rows])).sum().backward()
    return {"y": y.detach(), "dx": xr.grad,
            "dweight": all_reduce_(bn.weight.grad.clone()),
            "dbias": all_reduce_(bn.bias.grad.clone()),
            "running_mean": bn.running_mean, "running_var": bn.running_var}


def collectives_rank(rank, world, tmp):
    """``fetch_global``, ``put_global``, ``shard_batch`` both ways and the
    booleans of ``all_gather`` on this rank."""
    from two_stage_object_detection_tpu_torch.parallel.mesh import (
        make_mesh, shard_batch)
    from two_stage_object_detection_tpu_torch.parallel.multiprocess import (
        all_gather, fetch_global)
    mesh = make_mesh(devices=["cpu"])
    full = {"x": np.arange(4 * 3, dtype=np.float32).reshape(4, 3),
            "v": np.array([True, False, True, True])}
    mine = shard_batch(full, mesh, local=False)
    local = shard_batch({"x": full["x"][:2] + 100 * rank}, mesh)
    return {"shape": dict(mesh.shape), "index": mesh.data_index,
            "mine": {k: v.numpy() for k, v in mine.items()},
            "local": local["x"].numpy(),
            "fetched": fetch_global({"t": (mine["x"], torch.tensor(rank))}),
            "bools": all_gather(mine["v"]).numpy()}


def should_stop_rank(rank, world, tmp, request_at, sync_every):
    """Polls a guard once a step; rank 1 requests a stop at poll
    ``request_at``.  Returns the poll at which this rank stopped and the
    polls seen before it."""
    from two_stage_object_detection_tpu_torch.utils.preemption import (
        PreemptionGuard)
    guard = PreemptionGuard(sync_every=sync_every)
    for poll in range(1, 100):
        if rank == 1 and poll == request_at:
            guard.request()
        if guard.should_stop():
            return {"stopped_at": poll, "local": guard.requested,
                    "after": [guard.should_stop() for _ in range(3)]}
    return {"stopped_at": None}


def train_step_rank(rank, world, tmp, cfg_kw, state_dict, batch, steps):
    """``steps`` micro-steps of ``train_step`` on a data mesh from
    ``state_dict``: this rank's rows of each global batch in ``batch``
    (a list).  Returns the losses, parameters and running statistics, and
    the gradient of the last update."""
    from two_stage_object_detection_tpu_torch.config import Config
    from two_stage_object_detection_tpu_torch.nets.trainer import (
        create_train_state, train_step)
    from two_stage_object_detection_tpu_torch.parallel.mesh import (
        make_mesh, place_train_state)
    cfg = Config(**cfg_kw, device="cpu")
    model, state = create_train_state(cfg, seed=rank + 1)  # rank 0's wins
    if rank == 0:
        model.load_state_dict(state_dict)
    place_train_state(state, make_mesh(devices=["cpu"]), debug=True)
    grads = {}

    def keep_grads(*_):          # the all-reduced mean the update consumes
        grads.update({n: p.grad.clone() for n, p in model.named_parameters()
                      if p.grad is not None})

    state.optimizer.register_step_pre_hook(keep_grads)
    losses = []
    for g in batch[:steps]:
        b = g["image"].shape[0] // world
        mine = {k: v[rank * b:(rank + 1) * b] for k, v in g.items()}
        _, out = train_step(state, mine)
        losses.append({k: float(v) for k, v in out.items()})
    return {"losses": losses, "state": {k: v.clone() for k, v in
                                        model.state_dict().items()},
            "grads": grads, "step": state.step, "updates": state.updates,
            "bn_groups": sum(getattr(m, "group", None) is not None
                             for m in model.modules())}


def train_rank(rank, world, tmp, cfg_kw, root, runs, n_model=1):
    """``train()`` over the data mesh (with ``n_model`` above 1, over a
    ``(world / n_model, n_model)`` mesh), one call for each entry of
    ``runs`` (``(name, weights dir, options)``; option ``stop_at`` preempts
    at that poll).  Returns each run's final state (in the full layout),
    the sidecar and, on the data mesh, what ``build_loaders`` yields this
    rank in its first epoch beside a ``Loader(shard_count=world,
    shard_index=rank)`` over the same set."""
    import dataclasses
    import json

    from two_stage_object_detection_tpu_torch.config import Config
    from two_stage_object_detection_tpu_torch.data.coco import load_coco
    from two_stage_object_detection_tpu_torch.data.pipeline import (
        DetectionDataset, Loader)
    from two_stage_object_detection_tpu_torch.parallel.mesh import make_mesh
    from two_stage_object_detection_tpu_torch.parallel.sharding import (
        gather_optimizer_state, gather_state_dict)
    from two_stage_object_detection_tpu_torch.train import (
        build_loaders, train)
    from two_stage_object_detection_tpu_torch.utils.preemption import (
        PreemptionGuard)

    class StopAt(PreemptionGuard):
        def __init__(self, n):
            super().__init__(sync_every=1)
            self.n, self.polls = n, 0

        def should_stop(self, sync=None):
            self.polls += 1
            if self.polls == self.n and rank == world - 1:
                self.request()         # one rank asks; the ranks agree
            return super().should_stop(sync)

    out = {}
    for name, weights, opts in runs:
        cfg = Config(**{**cfg_kw, **opts.get("cfg", {})}, device="cpu")
        guard = StopAt(opts["stop_at"]) if "stop_at" in opts else None
        mesh = ("auto" if n_model == 1 else
                make_mesh(world // n_model, n_model, devices=["cpu"]))
        state = train(False, cfg, root, weights, eval_period=2, seed=3,
                      resume=opts.get("resume", False), guard=guard,
                      mesh=mesh)
        meta = os.path.join(weights, "train_meta.json")
        out[name] = {
            "state": {k: v.clone() for k, v in
                      gather_state_dict(state.model).items()},
            "opt": [{k: v.clone() for k, v in s.items()} for s in
                    gather_optimizer_state(state)["state"].values()],
            "step": state.step, "updates": state.updates,
            "dirs": sorted(os.listdir(weights)),
            "meta": json.load(open(meta)) if os.path.exists(meta) else None}
    if n_model > 1:
        return out
    # the shard each loader gives this rank, against the streaming Loader
    mesh = make_mesh(devices=["cpu"])
    shards = {}
    for label, opts in (("stream", {}), ("cache", {"cache_device": True,
                                                   "device_augment": True})):
        cfg = Config(**{**cfg_kw, **opts}, device="cpu")
        tl, el, _ = build_loaders(cfg, root, mesh)
        idx = load_coco(os.path.join(root, "annotations",
                                     "instances_train2017.json"),
                        os.path.join(root, "train2017"))
        ds = DetectionDataset(idx, cfg.input_size, cfg.max_gt_boxes,
                              train=cfg.augment,
                              decode_only=cfg.device_augment,
                              uint8_images=cfg.transfer_uint8)
        ref = Loader(ds, cfg.batch_size, shuffle=True, num_workers=1,
                     shard_count=world, shard_index=rank)
        shards[label] = {"got": [np.asarray(b["image"]) for b in tl],
                         "want": [b["image"] for b in ref],
                         "eval_batches": len(el), "len": len(tl)}
        for loader in (tl, el, ref):
            loader.close()
    out["shards"] = shards
    out["fields"] = [f.name for f in dataclasses.fields(Config)]
    return out


def eval_rank(rank, world, tmp, cfg_kw, state_dict, batches, kw):
    """``collect_predictions`` and ``evaluate`` over a data mesh on every
    rank, from ``state_dict``, on the full eval ``batches``."""
    from two_stage_object_detection_tpu_torch.config import Config
    from two_stage_object_detection_tpu_torch.eval.evaluator import (
        collect_predictions, evaluate)
    from two_stage_object_detection_tpu_torch.nets.trainer import (
        create_train_state)
    from two_stage_object_detection_tpu_torch.parallel.mesh import (
        make_mesh, place_train_state)
    cfg = Config(**cfg_kw, device="cpu")
    model, state = create_train_state(cfg)
    model.load_state_dict(state_dict)
    place_train_state(state, make_mesh(devices=["cpu"]))
    out = {}
    for use_predict in (False, True):
        out[use_predict] = {
            "collect": collect_predictions(state, batches, cfg,
                                           use_predict=use_predict, **kw),
            "evaluate": evaluate(state, batches, cfg,
                                 use_predict=use_predict, **kw)}
    return out


# ------------------------------------------------------------ model axis
def _gathered_grads_hook(model, into: dict):
    """An optimiser pre-hook keeping the gradient each update consumes (the
    all-reduced mean), split ones gathered into the full layout (a
    collective: every rank's optimiser runs it at the same update)."""
    from two_stage_object_detection_tpu_torch.parallel.sharding import (
        gather_full, split_parameters)

    def keep(*_):
        split = split_parameters(model)
        into.update({n: (gather_full(p.grad, split[n][0], split[n][1])
                         if n in split else p.grad).clone()
                     for n, p in model.named_parameters()
                     if p.grad is not None})
    return keep


def tp_step_rank(rank, world, tmp, cfg_kw, state_dict, batches, n_model,
                 ckpt=None):
    """Micro-steps of ``train_step`` on a ``(world / n_model, n_model)``
    mesh from ``state_dict``, each data index on its rows of every global
    batch of ``batches``; then ``ckpt``'s ``_last`` saved (every rank
    calls).  Checks after placement and after the steps that each data
    group holds the same state and each model group the same replicated
    tensors.  Returns the losses, the gathered state and the gradient of
    the last update in the full layout, this rank's optimiser state and
    the split parameters."""
    from two_stage_object_detection_tpu_torch.config import Config
    from two_stage_object_detection_tpu_torch.nets.trainer import (
        create_train_state, train_step)
    from two_stage_object_detection_tpu_torch.parallel.mesh import (
        assert_replicated, make_mesh, place_train_state, state_tensors)
    from two_stage_object_detection_tpu_torch.parallel.sharding import (
        gather_state_dict, split_parameters)
    from two_stage_object_detection_tpu_torch.utils import checkpoint
    cfg = Config(**cfg_kw, device="cpu")
    model, state = create_train_state(cfg, seed=rank + 1)  # rank 0's wins
    if rank == 0:
        model.load_state_dict(state_dict)
    mesh = make_mesh(world // n_model, n_model, devices=["cpu"])
    place_train_state(state, mesh, debug=True)
    grads = {}
    state.optimizer.register_step_pre_hook(_gathered_grads_hook(model, grads))
    losses = []
    for g in batches:
        b = g["image"].shape[0] // mesh.shape["data"]
        d = mesh.data_index
        _, out = train_step(state, {k: v[d * b:(d + 1) * b]
                                    for k, v in g.items()})
        losses.append({k: float(v) for k, v in out.items()})
    assert_replicated(state_tensors(state), mesh.group)
    assert_replicated(state_tensors(state, replicated_only=True),
                      mesh.model_group)
    if ckpt is not None:
        checkpoint.save_checkpoint(ckpt, state, checkpoint.LAST)
    return {"losses": losses, "grads": grads,
            "state": {k: v.clone() for k, v in
                      gather_state_dict(model).items()},
            "opt": state.optimizer.state_dict(),
            "split": {n: s[0] for n, s in split_parameters(model).items()},
            "index": (mesh.data_index, mesh.model_index),
            "step": state.step, "updates": state.updates}


def moments_and_restore_rank(rank, world, tmp, x, cfg_kw, ckpt):
    """Two checks in one spawn.  The cross-replica batch norm's statistics
    of this rank's rows of ``x`` (``models/layers.py:_global_moments``, in
    float32, Chan's combine in rank order), to be held against float64.
    Then a ``(1, world)`` mesh (the model axis over every rank) restores
    ``ckpt``'s ``_last``, written by one process mid-cycle, and saves it
    back under ``ckpt/mesh``; returns what the ranks hold, gathered."""
    import torch.distributed as dist

    from two_stage_object_detection_tpu_torch.config import Config
    from two_stage_object_detection_tpu_torch.models.layers import (
        _global_moments)
    from two_stage_object_detection_tpu_torch.nets.trainer import (
        create_train_state)
    from two_stage_object_detection_tpu_torch.parallel.mesh import (
        make_mesh, place_train_state)
    from two_stage_object_detection_tpu_torch.parallel.sharding import (
        gather_optimizer_state, gather_state_dict)
    from two_stage_object_detection_tpu_torch.utils import checkpoint
    b = x.shape[0] // world
    mean, var, count = _global_moments(
        torch.from_numpy(x[rank * b:(rank + 1) * b]), dist.group.WORLD)
    cfg = Config(**cfg_kw, device="cpu")
    model, state = create_train_state(cfg, seed=rank + 7)
    place_train_state(state, make_mesh(1, world, devices=["cpu"]))
    assert checkpoint.restore_checkpoint(ckpt, state, checkpoint.LAST)
    held = {"state": gather_state_dict(model),
            "opt": gather_optimizer_state(state),
            "local_shapes": {n: tuple(p.shape)
                             for n, p in model.named_parameters()},
            "step": state.step, "updates": state.updates}
    checkpoint.save_checkpoint(os.path.join(ckpt, "mesh"), state,
                               checkpoint.LAST)
    return {"mean": mean, "var": var, "count": float(count[0]),
            "held": held}
