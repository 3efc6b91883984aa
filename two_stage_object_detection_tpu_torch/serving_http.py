"""HTTP serving front: JPEG/PNG requests in, JSON detections out.

The port's copy of the JAX package's ``serving_http.py``:

    network wire          host edge                    device wire
    JPEG/PNG bytes  ->    native decode + resize  ->   yuv420 planes
                          (native/preprocess.cpp,      (1.5 B/px, unpacked
                           PIL where it is not built)   on the device)

* Each request thread decodes and wire-packs its own image, then submits
  it to one shared :class:`~.serving.DynamicBatcher`, so concurrent
  requests share padded bucket runs.
* Boxes come back in the original image's pixel coordinates (the model
  sees ``cfg.input_size``; the decode reports the source size).
* Stdlib only (``http.server.ThreadingHTTPServer``).

Routes: ``POST /detect`` (image bytes; 400 on an empty or undecodable
body), ``GET /healthz`` and ``GET /health``; any other path is a 404.

Usage::

    pred = Predictor.from_checkpoint("weights", cfg, wire="yuv420",
                                     calibrate=True)
    with DetectionServer(pred, class_names=names, port=8000) as srv:
        srv.serve_forever()          # or srv.start() for a daemon thread

    # client:  curl -s -X POST --data-binary @photo.jpg localhost:8000/detect
"""

from __future__ import annotations

import io
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Sequence

import numpy as np


class DetectionServer:
    """Threaded HTTP server around a :class:`~.serving.Predictor`.

    Args:
      predictor: a ``Predictor`` (any wire; ``"yuv420"`` ships the fewest
        host->device bytes per request).
      class_names: optional 1-based label -> name mapping for responses.
      max_wait_ms: the DynamicBatcher's collation window.
      host/port: bind address; ``port=0`` picks a free port (see ``.port``).
    """

    def __init__(self, predictor, class_names: Optional[Sequence[str]] = None,
                 max_wait_ms: float = 5.0, host: str = "127.0.0.1",
                 port: int = 0):
        from two_stage_object_detection_tpu_torch.serving import (
            DynamicBatcher)
        self._pred = predictor
        self._names = list(class_names) if class_names is not None else None
        self._batcher = DynamicBatcher(predictor, max_wait_ms=max_wait_ms)
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):      # keep the access log quiet
                pass

            def _json(self, code: int, payload: dict):
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path in ("/healthz", "/health"):
                    self._json(200, server._health())
                else:
                    self._json(404, {"error": f"no route {self.path}"})

            def do_POST(self):
                if self.path != "/detect":
                    self._json(404, {"error": f"no route {self.path}"})
                    return
                try:
                    n = int(self.headers.get("Content-Length", 0))
                except ValueError:
                    n = 0
                if n <= 0:
                    self._json(400, {"error": "empty body; POST image bytes"})
                    return
                data = self.rfile.read(n)
                try:
                    payload = server._detect(data)
                except _BadImage as e:
                    self._json(400, {"error": str(e)})
                except Exception as e:                  # noqa: BLE001
                    self._json(500, {"error": f"{type(e).__name__}: {e}"})
                else:
                    self._json(200, payload)

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self.host, self.port = self._httpd.server_address[:2]
        self._thread = None

    # ----------------------------------------------------------- lifecycle
    def serve_forever(self):
        self._httpd.serve_forever()

    def start(self) -> "DetectionServer":
        """Serve on a daemon thread (tests, embedding)."""
        self._thread = threading.Thread(target=self.serve_forever,
                                        daemon=True, name="DetectionServer")
        self._thread.start()
        return self

    def close(self):
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=10)
        self._batcher.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ------------------------------------------------------------ handlers
    def _health(self) -> dict:
        return {
            "status": "ok",
            "wire": self._pred.wire,
            "input_size": list(self._pred.cfg.input_size),
            "buckets": list(self._pred.batch_sizes),
            "backbone": self._pred.cfg.backbone,
        }

    def _detect(self, data: bytes) -> dict:
        img, oh, ow = self._ingest(data)
        out = self._batcher.submit(img).result()
        h, w = self._pred.cfg.input_size
        k = int(out["valid"][0].sum())
        boxes = np.asarray(out["boxes"][0][:k], np.float64)
        # model coordinates -> original image coordinates (xyxy)
        boxes[:, 0::2] *= ow / w
        boxes[:, 1::2] *= oh / h
        dets = []
        for i in range(k):
            label = int(out["labels"][0][i])
            d = {"box": [round(float(v), 2) for v in boxes[i]],
                 "score": round(float(out["scores"][0][i]), 4),
                 "label": label}
            if self._names is not None and 1 <= label <= len(self._names):
                d["class"] = self._names[label - 1]
            dets.append(d)
        return {"detections": dets, "image": {"height": oh, "width": ow}}

    def _ingest(self, data: bytes):
        """Request bytes -> one wire image and the original size."""
        f32, oh, ow = decode_image(data, self._pred.cfg.input_size)
        if self._pred.wire == "f32":
            return f32, oh, ow
        u8 = np.clip(np.rint(f32 * 255.0), 0, 255).astype(np.uint8)
        return u8, oh, ow       # the u8 wire as is; yuv420 packs in submit()


class _BadImage(ValueError):
    """The request body is not a decodable image (HTTP 400)."""


def decode_image(data: bytes, size):
    """JPEG/PNG bytes -> ``(float32 [H, W, 3] in [0, 1], orig_h, orig_w)``
    at ``size = (H, W)``.  The native library decodes and resizes; PIL does
    where it is not built.  Raises :class:`_BadImage` on bytes neither
    decodes."""
    from two_stage_object_detection_tpu_torch.data import native
    h, w = size
    got = native.decode_resize_bytes(data, (h, w))
    if got is not None:
        return got
    try:
        from PIL import Image
        with Image.open(io.BytesIO(data)) as im:
            im = im.convert("RGB")
            ow, oh = im.size
            f32 = np.asarray(im.resize((w, h), Image.BILINEAR),
                             np.float32) / 255.0
    except Exception as e:
        raise _BadImage(f"cannot decode image: {e}") from e
    return f32, oh, ow


def main(argv=None) -> int:
    """``python -m two_stage_object_detection_tpu_torch.serving_http``:
    serve the best checkpoint over HTTP.  The config comes from
    ``configs/config.json`` (the reference's key surface), the weights from
    ``--weights`` (the ``FasterRCNNTrainer_best`` checkpoint ``train()``
    writes); ``--device cpu`` serves on the CPU."""
    import argparse

    from two_stage_object_detection_tpu_torch.config import load_config
    from two_stage_object_detection_tpu_torch.serving import Predictor

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--weights", default="weights")
    ap.add_argument("--config", default=None, help="config.json path")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--wire", default="yuv420",
                    choices=("f32", "u8", "yuv420"))
    ap.add_argument("--buckets", default="1,8,16",
                    help="comma-separated batch buckets")
    ap.add_argument("--wait-ms", type=float, default=5.0)
    args = ap.parse_args(argv)

    cfg = load_config(args.config, device=args.device)
    pred = Predictor.from_checkpoint(
        args.weights, cfg, wire=args.wire, calibrate=True,
        batch_sizes=tuple(int(b) for b in args.buckets.split(",")))
    with DetectionServer(pred, max_wait_ms=args.wait_ms,
                         host=args.host, port=args.port) as srv:
        print(f"serving on http://{srv.host}:{srv.port}  "
              f"(wire={args.wire}, buckets={pred.batch_sizes})", flush=True)
        try:
            srv.serve_forever()
        except KeyboardInterrupt:
            pass
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
