"""``train_macro_step_resident`` over a training set held on the device,
one accumulation cycle a call: images trained per second
(``train_img_per_s``).

Traffic file: ``batch_size``, ``grad_accum_steps``, ``cache_bytes`` (the
set's size on the device), ``ground_truth`` (:func:`inputs.gt_boxes`),
``reference_updates`` (the set-up cycles the reference follows),
``trace_slice`` (``after_cycles``: the window cycle profiled).
"""

from __future__ import annotations

import contextlib
import statistics
from types import SimpleNamespace

import numpy as np
import torch

from port_bench import compare, counts, inputs
from port_bench.harness import BenchError
from port_bench.runner import clock


class _Feed:
    """The resident training set and the cycles drawn from it: cycle ``c``
    takes the next ``K * B`` rows of a stream of seeded permutations (all
    rows differ within one pass) and micro-step ``k`` of it draws from its
    own seeded generator."""

    def __init__(self, run, pcfg):
        tr = run.traffic
        self.run, self.k, self.b = run, pcfg.grad_accum_steps, pcfg.batch_size
        h, w = pcfg.input_size
        n = int(tr["cache_bytes"]) // (h * w * 3)
        self.n = n
        gen = inputs.device_generator(run.seed, run.device, 10)
        boxes, labels, valid = inputs.gt_boxes(
            n, tr["ground_truth"], h, w, pcfg.num_classes, pcfg.max_gt_boxes,
            run.seed)
        dev = run.device
        self.data = {"image": inputs.images_u8(n, h, w, gen),
                     "boxes": torch.from_numpy(boxes).to(dev),
                     "labels": torch.from_numpy(labels).to(dev),
                     "valid": torch.from_numpy(valid).to(dev)}
        self._stream = np.zeros(0, np.int64)
        self._passes = 0

    def idx(self, c: int) -> np.ndarray:
        need = (c + 1) * self.k * self.b
        while len(self._stream) < need:
            perm = inputs.rng(self.run.seed, 20, self._passes).permutation(self.n)
            self._stream = np.concatenate([self._stream, perm])
            self._passes += 1
        return self._stream[c * self.k * self.b:need].reshape(self.k, self.b)

    def generators(self, c: int):
        return [inputs.device_generator(self.run.seed, self.run.device, 30, c, k)
                for k in range(self.k)]


def _host(named) -> dict:
    """``{name: tensor}`` copied to the host in float32."""
    return {n: t.detach().float().cpu() for n, t in named}


def drive(run) -> dict:
    from two_stage_object_detection_tpu_torch.nets.trainer import (
        TrainState, make_optimizer, train_macro_step_resident)
    tr = run.traffic
    kw = dict(batch_size=int(tr["batch_size"]),
              grad_accum_steps=int(tr["grad_accum_steps"]),
              device_augment=True)
    pcfg, rcfg = run.program_config(**kw), run.reference_config(**kw)
    feed = _Feed(run, pcfg)
    steps_per_epoch = feed.n // pcfg.batch_size
    n_ref = int(tr["reference_updates"])

    def reference():
        key = ("reference", run.seed, n_ref)
        if key not in run.memo:
            run.memo.clear()
            run.memo[key] = reference_cycles(run, rcfg, feed,
                                             steps_per_epoch, n_ref)
        return run.memo[key]

    if run.control in ("fp8", "half"):
        return train_gaps(run, reference_cycles(
            run, rcfg, feed, steps_per_epoch, n_ref,
            "fp8" if run.control == "fp8" else None,
            half=run.control == "half"), reference())
    model = run.program_model(pcfg, rcfg)
    opt, lr_of = make_optimizer(pcfg, model.parameters(), steps_per_epoch)
    state = TrainState(pcfg, model, opt, lr_of)
    beta1 = opt.param_groups[0]["betas"][0]

    def cycle(c):
        nonlocal state
        state, totals = train_macro_step_resident(
            state, feed.data, feed.idx(c), feed.generators(c),
            device_augment=True)
        return totals.cpu()

    # the first cycles, through the window's own call: the reference
    # follows them after the window.  The first gradient as the optimizer
    # got it is its first moment over (1 - beta1) after one update; the
    # first cycle's RPN losses are read from train_forward's outputs.
    losses_p, grad_p, rpn_p = [], {}, []
    forward = model.train_forward

    def keep_rpn_loss(*a, **k):
        out = forward(*a, **k)
        rpn_p.append((out["losses"]["rpn_loc"]
                      + out["losses"]["rpn_cls"]).detach())
        return out

    for c in range(n_ref):
        t = clock()
        if c == 0:
            model.train_forward = keep_rpn_loss
        losses_p.append(cycle(c))
        if c == 0:
            del model.train_forward
            rpn_p = torch.stack(rpn_p).float().cpu()
        run.log(f"set-up cycle {c}: {clock() - t!r} s")
        if c == 0:
            grad_p = _host((n, opt.state[p]["exp_avg"] / (1.0 - beta1))
                           for n, p in model.named_parameters()
                           if p in opt.state)
    init = dict(run.reference_model(rcfg).named_parameters())
    delta_p = _host((n, p - init[n]) for n, p in model.named_parameters())
    del init
    run.free()
    if run.control == "sound":
        del state, model, opt
        return train_gaps(run, (losses_p, rpn_p, grad_p, delta_p),
                          reference())
    if run.trace:
        run.install_spans(model)
    sl = tr.get("trace_slice", {})
    run.settle()
    t0 = clock()
    run.setup_done(t0)
    c, cycles, last_end, nonfinite = n_ref, 0, t0, 0
    took, profiled = [], None
    while True:
        profiling = run.trace and cycles == sl.get("after_cycles", 1)
        if profiling:
            run.start_slice()
        t_c = clock()
        tot = cycle(c)
        end = clock()
        run.log(f"window cycle {cycles}: {end - t_c!r} s")
        if profiling:
            run.stop_slice()
            profiled = end - t_c
        else:
            took.append(end - t_c)
        if end - t0 > run.seconds:
            break
        nonfinite += int((~torch.isfinite(tot)).sum())
        cycles, last_end, c = cycles + 1, end, c + 1
    run.read_slice()
    peak = run.memory_peak()
    if not cycles:
        raise BenchError("no accumulation cycle ended inside the window")
    images = cycles * pcfg.grad_accum_steps * pcfg.batch_size
    rate = images / (last_end - t0)
    run.log(f"{cycles} cycles, {images} images in {last_end - t0!r} s: "
            f"{rate!r} img/s; set-up {run.setup_s!r} s; peak memory {peak} "
            f"bytes with a {feed.n}-image set on the device; {nonfinite} "
            "losses of the window not finite")
    metrics = {"train_img_per_s": rate, "setup_s": run.setup_s}
    breakdown = None
    if run.trace:
        if profiled is not None and took:
            run.log(f"the profiled cycle took {profiled!r} s, the others' "
                    f"median {statistics.median(took)!r} s")
        ctx = SimpleNamespace(
            bounds=run.kernel_bounds(), batch=pcfg.batch_size,
            flops_per_image=counts.model_flops(rcfg, train=True),
            rate=(len(took) * pcfg.grad_accum_steps * pcfg.batch_size
                  / sum(took)) if took else None)
        metrics = run.per_layer(ctx)
        breakdown = run.breakdown()
        run.spans.close()
    del state, model, opt
    correct, checks = run.checks(train_gaps(
        run, (losses_p, rpn_p, grad_p, delta_p), reference()))
    return dict(correct=correct, attempted=cycles * pcfg.grad_accum_steps,
                failed=0, metrics=metrics, device=run.device_entry(peak),
                breakdown=breakdown, checks=checks)


def reference_cycles(run, rcfg, feed: _Feed, steps_per_epoch: int,
                     n_ref: int, precision: str = None, half: bool = False):
    """The reference through the first ``n_ref`` cycles, from the seed's
    weights, rows and generators: each cycle's losses, the first cycle's
    RPN losses, the first update's gradient and the change after ``n_ref``
    updates, a leaf each, on the host.  ``precision``: its products on ``"fp8"`` operands (the
    control); ``half``: each micro-step trains on the first half of its
    batch alone (a planted fault)."""
    from port_bench.reference.layers import low_precision
    from port_bench.reference.trainer import Trainer
    run.free()
    run.reference_precision()
    model = run.reference_model(rcfg)
    init = {n: p.detach().clone() for n, p in model.named_parameters()}
    trainer = Trainer(rcfg, model, steps_per_epoch)
    losses = []
    with (low_precision(precision) if precision
          else contextlib.nullcontext()):
        for c in range(n_ref):
            idx = torch.as_tensor(feed.idx(c), device=run.device)
            totals = []
            for k, gen in enumerate(feed.generators(c)):
                rows = idx[k][: len(idx[k]) // 2] if half else idx[k]
                batch = {n: v[rows] for n, v in feed.data.items()}
                totals.append(trainer.micro_step(batch, gen, True))
            losses.append(torch.stack(totals).cpu())
    delta = _host((n, p - init[n]) for n, p in model.named_parameters())
    grad = trainer.first_grads
    rpn = torch.stack(trainer.rpn_losses[:feed.k]).float().cpu()
    del model, trainer, init
    run.free()
    return losses, rpn, grad, delta


def train_gaps(run, got: tuple, want: tuple) -> dict:
    """A run's readings (``got``: losses, first gradient, change, a leaf
    each) against the reference's (``want``), over the leaves the
    reference's gradient moves (:func:`compare.moving_leaves`):

    * ``grad_diff``: the first gradient's error by the median leaf,
      ``||g - g_ref|| / max(||g_ref||, median leaf's)``: its direction
      element by element, which an 8-bit product or a part of the batch
      changes;
    * ``change_gap``: the gap of the change's norm after the compared
      updates by the worst leaf (a step that leaves the state unchanged
      reads 1);
    * printed beside them: the change's error by the median leaf, the
      worst leaves, each cycle's mean loss and the first cycle's
      micro-step losses."""
    losses_p, rpn_p, grad_p, delta_p = got
    losses_r, rpn_r, grad_r, delta_r = want
    moving = compare.moving_leaves(compare.leaf_norms(grad_r))
    grad_diffs = compare.leaf_errors(grad_p, grad_r, moving)
    rpn_diffs = [grad_diffs[n] for n in moving if n.startswith("rpn_head.")]
    rpn_gaps = ((rpn_p.double() - rpn_r.double()).abs()
                / rpn_r.double().abs())
    change_diffs = compare.leaf_errors(delta_p, delta_r, moving)
    change_gap, change_leaf = compare.worst_leaf_gap(
        compare.leaf_norms(delta_p), compare.leaf_norms(delta_r), moving)
    loss_gap = max(abs(float(p.double().mean()) - float(r.double().mean()))
                   / abs(float(r.double().mean()))
                   for p, r in zip(losses_p, losses_r))
    step_gaps = ((losses_p[0].double() - losses_r[0].double()).abs()
                 / losses_r[0].double().abs())
    q = (50, 75, 90, 100)
    grad_q = np.percentile(list(grad_diffs.values()), q).tolist()
    change_q = np.percentile(list(change_diffs.values()), q).tolist()
    run.log(f"per-leaf errors, quantiles {q}: first gradient {grad_q!r} "
            f"(worst {max(grad_diffs, key=grad_diffs.get)}), change "
            f"{change_q!r} (worst {max(change_diffs, key=change_diffs.get)});"
            f" change norm gap worst leaf {change_leaf} of {len(moving)} "
            f"moving, {len(grad_r) - len(moving)} left out; cycle mean "
            f"losses: run {[float(x.mean()) for x in losses_p]!r}, reference "
            f"{[float(x.mean()) for x in losses_r]!r} (gap {loss_gap!r}); "
            f"first cycle's micro-step loss gaps: median "
            f"{float(step_gaps.median())!r}; RPN head's gradient errors "
            f"{rpn_diffs!r}; first cycle's RPN loss gaps: median "
            f"{float(rpn_gaps.median())!r} max {float(rpn_gaps.max())!r}")
    return {"grad_diff": grad_q[0], "change_gap": change_gap,
            "change_diff": change_q[0],
            "rpn_grad_diff": float(np.median(rpn_diffs)) if rpn_diffs else 1.0,
            "rpn_loss_gap": float(rpn_gaps.median())}
