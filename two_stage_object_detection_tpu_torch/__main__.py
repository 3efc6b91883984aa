"""Unified CLI: ``python -m two_stage_object_detection_tpu_torch <command>``.

The port's copy of the JAX package's CLI:

    python -m two_stage_object_detection_tpu_torch train  --data-root data
    python -m two_stage_object_detection_tpu_torch eval   --weights weights --predict
    python -m two_stage_object_detection_tpu_torch infer  --num 5
    python -m two_stage_object_detection_tpu_torch serve  --port 8000
    python -m two_stage_object_detection_tpu_torch export --out frcnn.pt2

Shared flags: ``--config`` (reference-format ``config.json``),
``--set key=value`` (override any :class:`~.config.Config` field from the
command line, e.g. ``--set device=cpu --set backbone=hardnet39s``, or
several after one ``--set``: ``--set device=cpu backbone=hardnet39s``),
``--flagship``, ``--data-root`` and ``--weights``.  Every command runs on
``Config.device``, ``"cuda"`` unless ``--set device=cpu``, and raises when
no GPU is there.  ``--compile-cache`` has no counterpart here (it is XLA's
compilation cache).  ``export`` writes a ``torch.export`` program in place
of StableHLO; ``--cuda-only`` takes the place of ``--tpu-only`` (keep the
CUDA kernels as custom ops).

``train`` and ``eval`` run data-parallel under ``torchrun``, one process a
GPU, from its environment (``--set batch_size`` is then a rank's batch):

    torchrun --nproc-per-node 4 -m two_stage_object_detection_tpu_torch train --flagship

The JAX CLI has no flag for a model axis, and neither has this one:
tensor-parallel training is ``train(mesh=make_mesh(n_data, n_model))``.
``train --spatial`` splits image rows over the model axis of
``auto_mesh_spatial``'s mesh instead (``parallel/spatial.py``):

    torchrun --nproc-per-node 4 -m two_stage_object_detection_tpu_torch train --flagship --spatial --set batch_size=1
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging

from two_stage_object_detection_tpu_torch.config import Config, load_config



def _parse_override(cfg: Config, kv: str):
    """``key=value`` -> (key, typed value), typed against the Config field."""
    if "=" not in kv:
        raise SystemExit(f"--set expects key=value, got {kv!r}")
    key, raw = kv.split("=", 1)
    fields = {f.name: f for f in dataclasses.fields(Config)}
    if key not in fields:
        raise SystemExit(f"--set: unknown Config field {key!r}")
    cur = getattr(cfg, key)
    if isinstance(cur, bool):           # bool before int: bool is an int
        if raw.lower() in ("1", "true", "yes", "on"):
            return key, True
        if raw.lower() in ("0", "false", "no", "off"):
            return key, False
        raise SystemExit(f"--set {key}: expected a bool, got {raw!r}")
    if isinstance(cur, int):
        return key, int(raw)
    if isinstance(cur, float):
        return key, float(raw)
    if isinstance(cur, (tuple, list)):
        vals = [v for v in raw.replace("(", "").replace(")", "").split(",") if v]
        elem = type(cur[0]) if len(cur) else float
        return key, tuple(elem(v) for v in vals)
    return key, raw


def _load_cfg(args) -> Config:
    cfg = load_config(getattr(args, "config", None))
    if getattr(args, "flagship", False):
        # the round-5 recommended production recipe (see docs/DESIGN.md
        # "Round 5: flagship promotion"); --set still overrides on top
        cfg = cfg.replace(fpn=True, backbone="resnet50", loc_normalize=True)
    overrides = dict(_parse_override(cfg, kv)
                     for kv in (getattr(args, "set", None) or []))
    if overrides:
        cfg = cfg.replace(**overrides)
    return cfg


def _add_common(p: argparse.ArgumentParser):
    p.add_argument("--config", default=None,
                   help="config.json path (reference key surface)")
    p.add_argument("--set", action="extend", nargs="+", metavar="KEY=VALUE",
                   help="override any Config field (repeatable, and one "
                        "--set takes several pairs)")
    p.add_argument("--flagship", action="store_true",
                   help="use the recommended production preset: FPN + "
                        "resnet50 + loc_normalize (--set overrides on top)")
    p.add_argument("--data-root", default="data")
    p.add_argument("--weights", default="weights")


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="two_stage_object_detection_tpu_torch",
        description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("train", help="run the training loop (train.train)")
    _add_common(p)
    p.add_argument("--resume", action="store_true",
                   help="continue from the _last full-state checkpoint")
    p.add_argument("--pre-train", action="store_true",
                   help="start from _best weights (fresh optimiser)")
    p.add_argument("--spatial", action="store_true",
                   help="shard image height over the mesh's model axis "
                        "(auto_mesh_spatial; parameters replicated)")
    p.add_argument("--eval-period", type=int, default=10)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--no-viz", action="store_true")

    p = sub.add_parser("eval", help="score a checkpoint on the val set")
    _add_common(p)
    p.add_argument("--checkpoint", default=None, choices=(None, "best", "last"),
                   help="which checkpoint (default: best)")
    p.add_argument("--predict", action="store_true",
                   help="score the true inference path instead of the "
                        "reference's trainer-graph protocol")
    p.add_argument("--coco", action="store_true",
                   help="also print the COCO-style summary (area bins, AR)")

    p = sub.add_parser("infer", help="render GT vs predictions to PNGs")
    _add_common(p)
    p.add_argument("--num", type=int, default=5)
    p.add_argument("--out", default="inference_results")
    p.add_argument("--seed", type=int, default=0)

    p = sub.add_parser("serve", help="HTTP serving front (serving_http)")
    _add_common(p)
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--wire", default="yuv420", choices=("f32", "u8", "yuv420"))
    p.add_argument("--buckets", default="1,8,16")
    p.add_argument("--wait-ms", type=float, default=5.0)

    p = sub.add_parser("export", help="serialize predict with torch.export")
    _add_common(p)
    p.add_argument("--out", default="frcnn.pt2")
    p.add_argument("--batch-size", type=int, default=1)
    p.add_argument("--cuda-only", action="store_true",
                   help="keep the CUDA kernels as custom ops (default "
                        "artifact is portable: plain PyTorch)")
    p.add_argument("--checkpoint", default=None, choices=(None, "best", "last"))
    return ap


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    cfg = _load_cfg(args)

    if args.cmd == "train":
        from two_stage_object_detection_tpu_torch.train import train
        train(visualization=not args.no_viz, cfg=cfg,
              data_root=args.data_root, weights_dir=args.weights,
              pre_train=args.pre_train, resume=args.resume,
              eval_period=args.eval_period, seed=args.seed,
              spatial=args.spatial)
        return 0

    if args.cmd == "eval":
        from two_stage_object_detection_tpu_torch.evaluate import evaluate_checkpoint
        from two_stage_object_detection_tpu_torch.utils import checkpoint as ckpt
        name = {None: None, "best": ckpt.BEST, "last": ckpt.LAST}[args.checkpoint]
        from two_stage_object_detection_tpu_torch.parallel.multiprocess import (
            rank)
        sweep = evaluate_checkpoint(
            weights_dir=args.weights, cfg=cfg, data_root=args.data_root,
            name=name, use_predict=args.predict, coco_summary=args.coco)
        if rank() == 0:                  # every rank holds the same sweep
            print(json.dumps(sweep, indent=2, default=float))
        return 0

    if args.cmd == "infer":
        from two_stage_object_detection_tpu_torch.infer import multi_inference
        multi_inference(args.num, cfg=cfg, data_root=args.data_root,
                        weights_dir=args.weights, output_dir=args.out,
                        seed=args.seed)
        return 0

    if args.cmd == "serve":
        from two_stage_object_detection_tpu_torch.serving import Predictor
        from two_stage_object_detection_tpu_torch.serving_http import (
            DetectionServer)
        pred = Predictor.from_checkpoint(
            args.weights, cfg, wire=args.wire, calibrate=True,
            batch_sizes=tuple(int(b) for b in args.buckets.split(",")))
        with DetectionServer(pred, max_wait_ms=args.wait_ms,
                             host=args.host, port=args.port) as srv:
            print(f"serving on http://{srv.host}:{srv.port}  "
                  f"(wire={args.wire}, buckets={pred.batch_sizes})",
                  flush=True)
            try:
                srv.serve_forever()
            except KeyboardInterrupt:
                pass
        return 0

    if args.cmd == "export":
        from two_stage_object_detection_tpu_torch.serving import (
            Predictor, export_program)
        from two_stage_object_detection_tpu_torch.utils import checkpoint as ckpt
        name = {None: ckpt.BEST, "best": ckpt.BEST,
                "last": ckpt.LAST}[args.checkpoint]
        try:
            model = Predictor.from_checkpoint(args.weights, cfg,
                                              name=name).model
        except FileNotFoundError as e:
            raise SystemExit(str(e)) from None
        n = export_program(cfg, model, args.out, batch_size=args.batch_size,
                           portable=not args.cuda_only)
        print(f"wrote {args.out} ({n} bytes, "
              f"{'CUDA-only' if args.cuda_only else 'portable'})")
        return 0

    raise SystemExit(f"unknown command {args.cmd!r}")   # pragma: no cover


if __name__ == "__main__":
    raise SystemExit(main())
