"""PyTorch port, the HTTP serving front (``serving_http.py``) and the CLI's
``serve``: JPEG bytes in, JSON detections in the original image's
coordinates out, against the JAX package's ``DetectionServer`` on the same
bytes and weights.  float32 on the CPU, the yuv420 wire.
"""

import http.client
import io
import json
import os
import threading

import numpy as np
import pytest
import torch
from PIL import Image

from tests.test_torch_serving import KW, jax_model
from tests.torch_native import same_native_path
from two_stage_object_detection_tpu import serving as jserving
from two_stage_object_detection_tpu import serving_http as jhttp
from two_stage_object_detection_tpu.config import Config as JConfig
from two_stage_object_detection_tpu_torch import serving_http
from two_stage_object_detection_tpu_torch.__main__ import main
from two_stage_object_detection_tpu_torch.config import Config
from two_stage_object_detection_tpu_torch.nets.trainer import (
    create_train_state)
from two_stage_object_detection_tpu_torch.serving import Predictor
from two_stage_object_detection_tpu_torch.serving_http import DetectionServer
from two_stage_object_detection_tpu_torch.utils import checkpoint as ckpt

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "data", "real_coco", "train2017", "hopper_full.jpg")
NAMES = ["cat", "dog", "bird"]
# the flagship's FPN at 64x64 on a ResNet-10 trunk
FPN = {**KW, "backbone": "resnet10"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def servers():
    """The port's server and the JAX package's, both on the yuv420 wire
    with the same weights, decoding by the same path (native or PIL:
    ``tests/torch_native.py:same_native_path``)."""
    with pytest.MonkeyPatch.context() as mp:
        same_native_path(mp)
        yield from _servers()


def _servers():
    _, v = jax_model(FPN)
    pred = Predictor.from_jax_variables(Config(**FPN, device="cpu"),
                                        v["params"], v["batch_stats"],
                                        batch_sizes=(1, 4), wire="yuv420")
    jpred = jserving.Predictor(JConfig(**FPN), v["params"], v["batch_stats"],
                               batch_sizes=(1,), wire="yuv420")
    with DetectionServer(pred, class_names=NAMES,
                         max_wait_ms=10.0).start() as srv, \
            jhttp.DetectionServer(jpred, class_names=NAMES,
                                  max_wait_ms=10.0).start() as jsrv:
        yield srv, jsrv, pred


def _post(srv, body, path="/detect"):
    conn = http.client.HTTPConnection(srv.host, srv.port, timeout=120)
    conn.request("POST", path, body=body,
                 headers={"Content-Length": str(len(body))})
    resp = conn.getresponse()
    out = (resp.status, json.loads(resp.read().decode()))
    conn.close()
    return out


def _get(srv, path):
    conn = http.client.HTTPConnection(srv.host, srv.port, timeout=30)
    conn.request("GET", path)
    resp = conn.getresponse()
    out = (resp.status, json.loads(resp.read().decode()))
    conn.close()
    return out


def _jpeg_bytes(arr_u8):
    buf = io.BytesIO()
    Image.fromarray(arr_u8).save(buf, "JPEG", quality=92)
    return buf.getvalue()


def test_detect_matches_jax_server(servers):
    """The response to ``hopper_full.jpg`` against the JAX server's for the
    same bytes: the same image size, count, labels and classes; scores
    within 1e-4 and boxes within 1e-4 + 1e-4 * |box| model pixels (the box
    tolerance; at most 10 original pixels a model pixel here), each plus
    the rounding of both answers (4 places for scores, 2 for boxes)."""
    srv, jsrv, _ = servers
    with open(FIXTURE, "rb") as f:
        body = f.read()
    status, got = _post(srv, body)
    jstatus, want = _post(jsrv, body)
    assert status == jstatus == 200
    assert got["image"] == want["image"]
    gd, wd = got["detections"], want["detections"]
    assert len(gd) == len(wd) > 0
    for g, w in zip(gd, wd):
        assert (g["label"], g["class"]) == (w["label"], w["class"])
        assert abs(g["score"] - w["score"]) <= 1e-4 + 1.01e-4
        gb, wb = np.array(g["box"]), np.array(w["box"])
        assert np.all(np.abs(gb - wb) <= 1e-3 + 1e-4 * np.abs(wb) + 0.0101), (
            gb, wb)


def test_detect_maps_boxes_to_original_coords(servers):
    """The HTTP answer equals the library's on the same ingest pixels,
    scaled back to the original size, every box inside the image."""
    srv, _, pred = servers
    with open(FIXTURE, "rb") as f:
        body = f.read()
    status, out = _post(srv, body)
    assert status == 200
    with Image.open(FIXTURE) as im:
        ow, oh = im.size
    assert out["image"] == {"height": oh, "width": ow}
    img, ih, iw = srv._ingest(body)
    want = pred(img[None])
    k = int(want["valid"][0].sum())
    assert len(out["detections"]) == k > 0
    h, w = pred.cfg.input_size
    boxes = np.asarray(want["boxes"][0][:k], np.float64)
    boxes[:, 0::2] *= iw / w
    boxes[:, 1::2] *= ih / h
    got = np.array([d["box"] for d in out["detections"]], np.float64)
    np.testing.assert_allclose(got, boxes, atol=0.011)   # rounded to 2 dp
    assert (got[:, 0] >= 0).all() and (got[:, 2] <= ow + 1e-6).all()
    assert (got[:, 1] >= 0).all() and (got[:, 3] <= oh + 1e-6).all()


def test_concurrent_requests_collate(servers):
    srv, _, _ = servers
    rng = np.random.RandomState(3)
    bodies = [_jpeg_bytes(rng.randint(0, 256, (40, 50, 3)).astype(np.uint8))
              for _ in range(6)]
    results = [None] * 6

    def client(i):
        results[i] = _post(srv, bodies[i])

    threads = [threading.Thread(target=client, args=(i,)) for i in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    for status, out in results:
        assert status == 200
        assert out["image"] == {"height": 40, "width": 50}
        assert isinstance(out["detections"], list)


def test_health_and_errors(servers):
    srv, _, _ = servers
    for path in ("/healthz", "/health"):
        status, health = _get(srv, path)
        assert status == 200 and health == {
            "status": "ok", "wire": "yuv420", "input_size": [64, 64],
            "buckets": [1, 4], "backbone": "resnet10"}
    assert _get(srv, "/nope")[0] == 404
    for body in (b"this is not an image", b"\xff\xd8ragged jpeg header"):
        status, out = _post(srv, body)
        assert status == 400 and "error" in out
    status, out = _post(srv, b"")
    assert status == 400 and "empty" in out["error"]
    assert _post(srv, _jpeg_bytes(np.zeros((8, 8, 3), np.uint8)),
                 path="/wrong")[0] == 404
    with pytest.raises(serving_http._BadImage):
        serving_http.decode_image(b"garbage", (64, 64))


def test_cli_serve(tmp_path, monkeypatch):
    """``serve --set device=cpu`` loads the checkpoint, times its buckets
    (``calibrate=True``) and serves; here ``serve_forever`` serves on a
    thread for one health check and one detection, then returns."""
    cfg = Config(device="cpu", input_size=(64, 64), num_classes=3,
                 n_test_post_nms=16, max_detections=8)
    _, state = create_train_state(cfg, seed=0)
    ckpt.save_checkpoint(str(tmp_path), state, name=ckpt.BEST)
    seen = {}
    serve = DetectionServer.serve_forever

    def once(srv):
        threading.Thread(target=serve, args=(srv,), daemon=True).start()
        seen["health"] = _get(srv, "/healthz")
        with open(FIXTURE, "rb") as f:
            seen["detect"] = _post(srv, f.read())

    monkeypatch.setattr(DetectionServer, "serve_forever", once)
    assert main(["serve", "--weights", str(tmp_path), "--host", "127.0.0.1",
                 "--port", "0", "--buckets", "1,2", "--set", "device=cpu",
                 "input_size=64,64", "num_classes=3", "n_test_post_nms=16",
                 "max_detections=8"]) == 0
    assert seen["health"] == (200, {
        "status": "ok", "wire": "yuv420", "input_size": [64, 64],
        "buckets": [1, 2], "backbone": "hardnet39"})
    assert seen["detect"][0] == 200
