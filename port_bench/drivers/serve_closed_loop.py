"""One caller sending many-image requests back to back to a
``Predictor``: images completed per second (``serve_img_per_s``).

Traffic file: ``wire``, ``batch_sizes``, ``calibrate``,
``images_per_request``, ``pool_requests``, ``check_images``,
``reference_block``, ``trace_slice`` (``start_frac``, ``seconds``).
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np

from port_bench import counts, inputs, served
from port_bench.harness import BenchError
from port_bench.runner import clock
from port_bench.trace import PredictorProxy


def drive(run) -> dict:
    tr = run.traffic
    pcfg, rcfg = run.program_config(), run.reference_config()
    model = run.program_model(pcfg, rcfg)
    per = int(tr["images_per_request"])
    pool = served.served_images(run, pcfg, per * int(tr["pool_requests"]),
                                inputs.device_generator(run.seed, run.device, 4))
    requests = pool.reshape(-1, per, *pool.shape[1:])
    order = inputs.rng(run.seed, 5)
    pred = served.predictor(run, model, pcfg)
    proxy = PredictorProxy(pred, clock)
    for r in requests:                     # warm: each bucket plan once
        proxy(r)
    if run.trace:
        run.install_spans(model)
    proxy.calls.clear()
    sl = tr.get("trace_slice", {})
    run.settle()
    t0 = clock()
    run.setup_done(t0)
    done, last_end, images, started = [], t0, 0, 0
    slicing = sliced = False
    slice_t = slice_end = None
    while True:
        now = clock()
        if now - t0 >= run.seconds:
            break
        if run.trace and not slicing and not sliced and (
                now - t0 >= sl["start_frac"] * run.seconds):
            run.start_slice()
            slicing, sliced, slice_t = True, True, now
        k = int(order.integers(len(requests)))
        started += 1
        out = proxy(requests[k])
        end = clock()
        if slicing and end - slice_t >= sl["seconds"]:
            run.stop_slice()
            slicing, slice_end = False, clock()
        if end - t0 <= run.seconds:
            done.append((k, out))
            images += per
            last_end = end
    if slicing:
        run.stop_slice()
        slice_end = clock()
    run.read_slice()
    peak = run.memory_peak()
    if not done:
        raise BenchError("no request completed inside the window")
    rate = images / (last_end - t0)
    run.log(f"{len(done)} requests of {per} images in "
            f"{last_end - t0!r} s: {rate!r} img/s; set-up {run.setup_s!r} s; "
            f"peak memory {peak} bytes")
    metrics = {"serve_img_per_s": rate, "setup_s": run.setup_s}
    breakdown = None
    if run.trace:
        # the rate outside the slice: requests that ended before it or
        # started after it
        outside = [c for c in proxy.calls
                   if slice_t is None or c[1] <= slice_t or c[0] >= slice_end]
        unsliced_s = (last_end - t0 - (slice_end - slice_t)) if slice_t else None
        ctx = SimpleNamespace(
            bounds=run.kernel_bounds(),
            flops_per_image=counts.model_flops(rcfg, train=False),
            rate=(sum(c[2] for c in outside if c[1] <= last_end) / unsliced_s)
            if unsliced_s else None)
        metrics = run.per_layer(ctx)
        breakdown = run.breakdown()
        run.spans.close()
    rng = inputs.rng(run.seed, 6)
    flat = [(s, j) for s in range(len(done)) for j in range(per)]
    pick = rng.choice(len(flat), size=min(int(tr["check_images"]), len(flat)),
                      replace=False)
    got, wire_imgs = [], []
    for p in sorted(pick):
        s, j = flat[p]
        k, out = done[s]
        got.append({f: v[j] for f, v in out.items()})
        wire_imgs.append(requests[k][j])
    del proxy, pred, model, done
    correct, checks = served.detection_checks(run, rcfg, got,
                                              np.stack(wire_imgs))
    return dict(correct=correct, attempted=started, failed=0,
                metrics=metrics, device=run.device_entry(peak),
                breakdown=breakdown, checks=checks)
