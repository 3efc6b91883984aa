"""What every driver shares: one run of one cell (:class:`Run`), with its
arguments, files and device, the program and the reference built from the
configuration, the timing of set-up, the profiled slice and the checks.

A driver is ``port_bench/drivers/<driver>.py``, named by the ``driver`` of
a traffic file, with a function ``drive(run)`` that returns the run's
result.  Each builds the program from the configuration file, with weights
the reference draws from the seed, warms up the shapes its traffic uses,
measures for ``--seconds``, and then, once the program's state is freed,
has the reference work out the same outputs from the same inputs.  With
``--trace 1`` the run also profiles a slice of the window and hands it to
the per-layer readers.
"""

from __future__ import annotations

import dataclasses
import gc
import os
import sys
import tempfile
import time

import torch

from port_bench import counts, inputs, kernels
from port_bench.reference import config as ref_config
from port_bench.reference.detector import FasterRCNN as RefDetector
from port_bench.reference.layers import init_weights
from port_bench.trace import Spans, Timeline, profile

clock = time.perf_counter


def _tuples(d: dict) -> dict:
    return {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}


def _logit_scales(ref, rcfg, target: dict, seed: int) -> dict:
    """``{layer: factor}`` that brings the standard deviation of each
    layer's output on four seeded images (float32, eval mode) to
    ``target[layer]``; the layers are scaled in order, each measured after
    the ones before it."""
    from port_bench.reference import wire
    h, w = rcfg.input_size
    x = wire.u8_to_float(inputs.images_u8(
        4, h, w, inputs.device_generator(seed, ref.device, 7)))
    scales = {}
    for name, t in target.items():
        outs = []
        layer = ref.get_submodule(name)
        hk = layer.register_forward_hook(
            lambda m, i, o: outs.append(o.detach().float()))
        try:
            with torch.inference_mode():
                ref.predict(x)
        finally:
            hk.remove()
        scales[name] = float(t) / max(float(outs[0].std()), 1e-12)
        with torch.no_grad():
            layer.weight.mul_(scales[name])
    return scales


class Run:
    """One run of one cell: its arguments, files and device, and what the
    drivers share.

    ``control`` (``port_bench/control.py``) switches a driver to a
    reading of its comparison without the window: ``"fp8"`` puts the
    reference on float8 operands in the program's place, ``"half"`` (a
    planted fault, training) trains the reference on half of each batch,
    ``"sound"`` (training) reads the program's set-up cycles.  ``memo``
    keeps what such readings of one seed share (the float32 reference)."""

    def __init__(self, root, cell, seed: int, seconds: float, trace: int,
                 t_start: float, device, overrides=None, memo=None):
        self.root, self.cell, self.seed = root, cell, int(seed)
        self.seconds, self.trace, self.t_start = float(seconds), trace, t_start
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.traffic = cell.traffic
        self.model_kw = _tuples({**cell.config["config"],
                                 **(overrides or {})})
        self.setup_s = None
        self.spans = None
        self.timeline = None
        self.control = None
        self.memo = {} if memo is None else memo
        self._init_scales = None
        self._prof = None

    # ------------------------------------------------------------ logging
    def log(self, *a):
        print("port_bench:", *a, file=sys.stderr, flush=True)

    # ------------------------------------------------------------ models
    def program_config(self, **kw):
        from two_stage_object_detection_tpu_torch.config import Config
        return Config(**{**self.model_kw, **kw, "device": self.device.type})

    def reference_config(self, **kw):
        kw = {**self.model_kw, **kw, "compute_dtype": "float32"}
        names = {f.name for f in dataclasses.fields(ref_config.Config)}
        return ref_config.Config(**{k: v for k, v in kw.items() if k in names})

    def reference_model(self, rcfg):
        """The reference detector, float32, its weights drawn on the device
        from the seed (one call); the same seed gives the same weights.

        ``init_logit_std`` in the configuration file (``{layer: std}``)
        then scales each named layer so that its outputs on four seeded
        images have the standard deviation ``std`` (its first call's, for
        a head shared by the pyramid's levels): the RPN's objectness and
        the box classifier's logits, spread as a trained detector's are,
        so that proposals are decided by the image and not by rounding,
        and served images hold detections.  The scales are found once a
        run and reused."""
        ref = RefDetector(rcfg, device=self.device)
        init_weights(ref, inputs.sub_seed(self.seed, 0))
        target = self.cell.config.get("init_logit_std") or {}
        if target and self._init_scales is None:
            self._init_scales = _logit_scales(ref, rcfg, target, self.seed)
            return ref
        with torch.no_grad():
            for name, k in (self._init_scales or {}).items():
                ref.get_submodule(name).weight.mul_(k)
        return ref

    def program_model(self, pcfg, rcfg):
        """The program's detector on the device, with the reference's
        seeded weights loaded (kernels built first, into the program's own
        build directory)."""
        from two_stage_object_detection_tpu_torch.nets.detector import (
            FasterRCNN)
        if self.cuda:
            from two_stage_object_detection_tpu_torch.ops import _cuda
            _cuda.build_all()
        model = FasterRCNN(pcfg, device=self.device)
        ref = self.reference_model(rcfg)
        model.load_state_dict(ref.state_dict())
        del ref
        return model

    def reference_precision(self):
        """float32 with TF32 off, for the reference's products."""
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    # ------------------------------------------------------------ timing
    def sync(self):
        if self.cuda:
            torch.cuda.synchronize(self.device)

    @staticmethod
    def settle():
        """The last step of set-up: what set-up made stays for the run, so
        it is collected once and moved out of the collector's sight
        (``gc.freeze``, as a server does after loading).  A full pass
        inside the window then scans what the window makes, not the
        process's set-up objects: a pass over those takes 130-300 ms and
        stalls every thread."""
        gc.collect()
        gc.freeze()

    def setup_done(self, at_perf: float):
        """Set-up ends at ``at_perf`` (the first timed request or step)."""
        self.setup_s = time.time() + (at_perf - clock()) - self.t_start

    def memory_peak(self) -> int:
        return int(torch.cuda.max_memory_allocated(self.device)) if self.cuda else 0

    def free(self):
        gc.collect()
        if self.cuda:
            torch.cuda.empty_cache()

    # ------------------------------------------------------------ tracing
    def install_spans(self, model):
        """The benchmark's ranges around the layers' calls, and the kernel
        captures (``--trace 1`` only)."""
        from two_stage_object_detection_tpu_torch.nets import detector, trainer
        spans = Spans()
        spans.modules(model, ("extractor", "neck", "rpn_head", "roi_head"))
        for attr in ("features", "proposals", "detect", "train_forward"):
            spans.method(model, attr)
        spans.name(detector, "anchor_target")
        spans.name(detector, "proposal_target")
        spans.name(trainer, "train_step", "micro_step")
        kernels.install(spans)
        self.spans = spans
        return spans

    def start_slice(self):
        """Start the profiler, on the thread whose calls it is to record."""
        self._prof = profile()
        self._prof.start()
        self.spans.capturing = True

    def stop_slice(self):
        self.sync()
        self.spans.capturing = False
        self._prof.stop()

    def read_slice(self):
        """Export and read the slice, once the window has closed."""
        if self._prof is None:
            return
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            self.timeline = Timeline(path)
        finally:
            os.unlink(path)
        self._prof = None

    def kernel_bounds(self):
        """``[(bound ms, hand-kernel ms)]`` of the captured calls."""
        pk = counts.peaks(self.device_kind())
        if self.timeline is None or pk is None:
            return []
        names = kernels.hand_kernel_names(self.root)
        pairs = []
        with torch.inference_mode():
            for kind, caps in self.spans.captures.items():
                for i, cap in enumerate(caps):
                    if cap is None:
                        continue
                    rngs = self.timeline.ranges_named(
                        rf"bench\.kernel\.{kind}#{i}$")
                    if len(rngs) != 1:
                        continue
                    ms = self.timeline.kernel_ms(rngs[0], names)
                    if ms > 0:
                        pairs.append((kernels.bound_ms(kind, *cap, pk), ms))
        return pairs

    def device_kind(self) -> str:
        return torch.cuda.get_device_name(self.device) if self.cuda else "cpu"

    def per_layer(self, ctx) -> dict:
        """Every per-layer metric of the cell its reader finds."""
        ctx.timeline = self.timeline
        ctx.peaks = counts.peaks(self.device_kind())
        out = {}
        for m in self.cell.metrics("per_layer"):
            v = self.cell.reader(m["name"]).read(ctx)
            if v is not None:
                out[m["name"]] = float(v)
        return out

    def breakdown(self):
        if self.timeline is None:
            return None
        return {"device_ops": self.timeline.device_ops_by_name(),
                "idle_gaps": self.timeline.idle_gaps_by_range()}

    def device_entry(self, peak: int) -> dict:
        d = {"platform": "gpu" if self.cuda else "cpu",
             "kind": self.device_kind(), "count": int(self.cell.entry["chips"]),
             "memory_peak_bytes": peak}
        if self.trace and self.timeline is not None:
            d["busy_s"] = self.timeline.busy_s
            d["window_s"] = self.timeline.window_s
        return d

    def checks(self, readings: dict) -> tuple:
        """``(correct, checks)``: each reading the cell's limits file names
        beside its limit; the others are printed, not compared."""
        out, ok = {}, True
        for name, v in readings.items():
            if name not in self.cell.limits:
                continue
            lim = self.cell.limits[name]
            out[name] = {"value": v, "limit": lim}
            ok = ok and v <= lim
        return ok and bool(out), out
