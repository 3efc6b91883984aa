"""PyTorch port, the rest of ``serving.py`` against the JAX package's: the
yuv420 wire (host pack byte for byte, device unpack bit for bit), the
``Predictor`` on its three wires, the bucket plan (size heuristic and
measured costs), the pipelined dispatch and the ``DynamicBatcher``.  float32
on the CPU, where the port runs the plain versions of its kernels.

The model is the flagship's FPN-ResNet50 at 64x64 (the config of
``tests/test_torch_detector.py``).  Its variables get their shapes from
``jax.eval_shape`` of the flax init and seeded numpy values (no init
compile), carried across by ``load_jax_variables``.  Helpers here are shared
with ``test_torch_serving_http.py``, ``test_torch_quantize.py`` and
``test_torch_export.py``.
"""

import sys
import threading
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import unfreeze

from tests.torch_native import same_native_path
from two_stage_object_detection_tpu import serving as jserving
from two_stage_object_detection_tpu.config import Config as JConfig
from two_stage_object_detection_tpu.data import native as jnative
from two_stage_object_detection_tpu.nets.detector import FasterRCNN as JFasterRCNN
from two_stage_object_detection_tpu_torch import serving
from two_stage_object_detection_tpu_torch.config import Config
from two_stage_object_detection_tpu_torch.data import native
from two_stage_object_detection_tpu_torch.serving import (
    FIELDS, DynamicBatcher, Predictor)

# the flagship at 64x64: 6 * 64 <= 1,023 anchors, the truncated route
KW = dict(fpn=True, backbone="resnet50", loc_normalize=True, input_size=(64, 64),
          fpn_channels=32, fpn_fc_dim=64, num_classes=3, n_test_pre_nms=64,
          n_test_post_nms=16, max_detections=8, compute_dtype="float32",
          score_thresh=0.0)
H = W = 64


def fill(shapes, rng):
    """Seeded numpy values for a flax variable tree of ``ShapeDtypeStruct``s:
    kernels ~ N(0, 1/fan_in), biases and batch-norm mean ~ 0.1 N(0, 1),
    batch-norm scale and var ~ U(0.5, 1.5)."""
    out = {}
    for k, v in shapes.items():
        if not hasattr(v, "shape"):
            out[k] = fill(v, rng)
        elif k == "kernel":
            fan_in = int(np.prod(v.shape[:-1]))
            out[k] = np.asarray(rng.randn(*v.shape) / np.sqrt(fan_in),
                                np.float32)
        elif k in ("scale", "var"):
            out[k] = np.asarray(rng.uniform(0.5, 1.5, v.shape), np.float32)
        else:
            out[k] = np.asarray(rng.randn(*v.shape) * 0.1, np.float32)
    return out


def jax_model(kw=KW, seed=0):
    """``(flax model, variables)``: shapes from ``eval_shape``, seeded
    values, small RPN deltas (proposals stay inside the image)."""
    jm = JFasterRCNN(JConfig(**kw))
    h, w = kw["input_size"]
    shapes = unfreeze(jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                                     jnp.zeros((1, h, w, 3))))
    rng = np.random.RandomState(seed)
    v = {k: fill(s, rng) for k, s in shapes.items()}
    v["params"]["rpn_head"]["loc"]["kernel"] *= 0.1
    return jm, v


def assert_matches_jax(got, want):
    """The box tolerance of ROADMAP.md section 3: equal ``valid`` and
    ``labels``, scores within 1e-4, boxes within 1e-4 + 1e-4 * |box| px."""
    got = [got[k] for k in FIELDS] if isinstance(got, dict) else got
    want = [want[k] for k in FIELDS] if isinstance(want, dict) else want
    gb, gs, gl, gv = (np.asarray(a) for a in got)
    wb, ws, wl, wv = (np.asarray(a) for a in want)
    assert gv.sum() > 0, "no detections to compare"
    np.testing.assert_array_equal(gv, wv)
    np.testing.assert_array_equal(gl, wl)
    np.testing.assert_allclose(gs, ws, rtol=0, atol=1e-4)
    np.testing.assert_allclose(gb, wb, rtol=1e-4, atol=1e-4)


def assert_same(got, want):
    for k in FIELDS:
        np.testing.assert_array_equal(got[k], want[k])


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several test processes on one CPU; torch's own thread
    pool in each would oversubscribe it many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def served():
    """The JAX variables, the port's model carrying them, and one JAX
    ``Predictor`` a wire (bucket 2)."""
    jm, v = jax_model()
    pred = Predictor.from_jax_variables(Config(**KW, device="cpu"),
                                        v["params"], v["batch_stats"],
                                        batch_sizes=(1, 2))
    jpreds = {wire: jserving.Predictor(JConfig(**KW), v["params"],
                                       v["batch_stats"], batch_sizes=(2,),
                                       wire=wire)
              for wire in ("f32", "u8", "yuv420")}
    return pred, jpreds


def _u8(rng, n):
    return rng.randint(0, 256, (n, H, W, 3)).astype(np.uint8)


# ------------------------------------------------------------ yuv420 wire
@pytest.mark.parametrize("path", ["numpy", "native"])
def test_rgb_to_yuv420_bytes_equal_jax(rng, monkeypatch, path):
    """The host pack, byte for byte, on each of its two paths (the JAX
    package's numpy path forced by hiding its native pack; the native
    path with both libraries loaded, :func:`same_native_path`)."""
    u8 = rng.randint(0, 256, (3, 48, 96, 3)).astype(np.uint8)
    if path == "numpy":
        monkeypatch.setattr(native, "rgb_to_yuv420", lambda _: None)
        monkeypatch.setattr(jnative, "rgb_to_yuv420", lambda _: None)
    elif not same_native_path(monkeypatch):
        assert native.rgb_to_yuv420(u8) is None
        return
    got = serving.rgb_to_yuv420(u8)
    want = jserving.rgb_to_yuv420(u8)
    assert got.shape == (3, 72, 96) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(serving.rgb_to_yuv420(u8[0]), want[:1])
    with pytest.raises(ValueError, match="even"):
        serving.rgb_to_yuv420(u8[:, :47])
    with pytest.raises(ValueError, match="uint8"):
        serving.rgb_to_yuv420(u8.astype(np.float32))


def test_yuv420_unpack_bit_for_bit(rng):
    """The device unpack (here on the CPU) equals the JAX package's numpy
    reference bit for bit, as does the port's copy of that reference; JAX's
    own jitted unpack agrees to 1e-6 (its test's tolerance: XLA may fuse a
    multiply-add)."""
    packed = jserving.rgb_to_yuv420(_u8(rng, 3))
    want = jserving.yuv420_to_rgb_reference(packed, H, W)
    got = serving._yuv420_unpack(torch.from_numpy(packed), H, W).numpy()
    assert got.dtype == np.float32 and got.shape == (3, H, W, 3)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        serving.yuv420_to_rgb_reference(packed, H, W), want)
    jit = np.asarray(jax.jit(lambda p: jserving._yuv420_unpack(p, H, W))(
        jnp.asarray(packed)))
    np.testing.assert_allclose(got, jit, rtol=0, atol=1e-6)


# ------------------------------------------------------------ Predictor
@pytest.mark.parametrize("wire", ["f32", "u8", "yuv420"])
def test_predictor_wires_match_jax(served, rng, wire):
    """Each wire against the JAX ``Predictor`` on the same request, within
    the box tolerance; the yuv420 wire takes RGB (packed on the host) and
    packed planes alike."""
    pred, jpreds = served
    port = Predictor(pred.cfg, pred.model, batch_sizes=(2,), wire=wire)
    u8 = _u8(rng, 2)
    req = u8.astype(np.float32) / np.float32(255.0) if wire == "f32" else u8
    got = port(req)
    assert_matches_jax(got, jpreds[wire](req))
    if wire == "yuv420":
        assert_same(port(serving.rgb_to_yuv420(u8)), got)


COSTS = {"heuristic": None, "b8_fastest": {1: 11.8, 8: 7.8, 16: 30.0},
         "b1_cheap": {1: 3.0, 8: 96.0, 16: 99.0}}


@pytest.mark.parametrize("costs", list(COSTS))
def test_plan_equals_jax(served, costs):
    """The bucket plan, for every request size 1..40, equals the JAX
    ``Predictor._plan`` for the same buckets and the same injected costs
    (``None``: the size heuristic)."""
    pred, _ = served
    port = Predictor(pred.cfg, pred.model, batch_sizes=(1, 8, 16))
    port._bucket_ms = COSTS[costs]
    # the JAX method reads only these attributes: no AOT compile needed
    ref = types.SimpleNamespace(
        batch_sizes=(1, 8, 16), _bucket_ms=COSTS[costs], _plan_memo={},
        _DISPATCH_OVERHEAD=jserving.Predictor._DISPATCH_OVERHEAD)
    for n in range(1, 41):
        assert port._plan(n) == jserving.Predictor._plan(ref, n), n
    if costs == "heuristic":
        assert sorted(port._plan(9)) == [1, 8] and port._plan(7) == (8,)


def test_calibrate_routes_by_measured_cost(served, rng):
    """``calibrate=True`` times every bucket; with costs where b=2 beats
    b=1, a one-image request pads into the 2-bucket and still answers as
    a direct predict does."""
    pred, _ = served
    port = Predictor(pred.cfg, pred.model, batch_sizes=(1, 2),
                     calibrate=True)
    assert set(port._bucket_ms) == {1, 2}
    assert all(v > 0 for v in port._bucket_ms.values())
    port._bucket_ms, port._plan_memo = {1: 11.8, 2: 7.8}, {}
    assert port._plan(1) == (2,) and sorted(port._plan(3)) == [2, 2]
    x = rng.rand(1, H, W, 3).astype(np.float32)
    direct = [t.numpy() for t in pred.model.predict(torch.from_numpy(x))]
    got = port(x)
    np.testing.assert_array_equal(got["valid"], direct[3])
    np.testing.assert_allclose(got["boxes"], direct[0], rtol=1e-5, atol=1e-5)


def test_pipelined_dispatch_keeps_two_in_flight(served, rng):
    """A 5-bucket request: at most 2 buckets are in flight (the oldest is
    fetched before a third is enqueued), results in request order."""
    pred, _ = served
    port = Predictor(pred.cfg, pred.model, batch_sizes=(1,))
    state = {"in_flight": 0, "most": 0}
    enqueue, fetch = port._enqueue, port._fetch

    def counted_enqueue(*a):
        state["in_flight"] += 1
        state["most"] = max(state["most"], state["in_flight"])
        return enqueue(*a)

    def counted_fetch(p):
        state["in_flight"] -= 1
        return fetch(p)

    port._enqueue, port._fetch = counted_enqueue, counted_fetch
    x = rng.rand(5, H, W, 3).astype(np.float32)
    got = port(x)
    assert state == {"in_flight": 0, "most": 2}
    for i in range(5):
        one = pred(x[i])
        for k in FIELDS:
            np.testing.assert_allclose(got[k][i:i + 1], one[k], rtol=1e-5,
                                       atol=1e-5)


def test_mesh_and_spatial_raise(served, rng):
    """``spatial`` (image rows over the mesh's model axis) builds and runs:
    without a mesh it is the plain predictor, over a ``(1, 2)`` mesh of
    CPU "devices" it answers as the plain one within the box tolerance
    (its parity with the JAX package: ``tests/test_torch_spatial.py``); a
    mesh that is not a ``parallel.mesh.Mesh``, or one over processes, is
    refused (the data axis: ``tests/test_torch_parallel.py``)."""
    from two_stage_object_detection_tpu_torch.parallel.mesh import make_mesh
    pred, _ = served
    assert not Predictor(pred.cfg, pred.model, spatial=True).spatial
    rows = Predictor(pred.cfg, pred.model, batch_sizes=(1,), spatial=True,
                     mesh=make_mesh(1, 2, devices=["cpu", "cpu"]))
    assert rows.spatial
    x = rng.rand(1, H, W, 3).astype(np.float32)
    got, want = rows(x), Predictor(pred.cfg, pred.model,
                                   batch_sizes=(1,))(x)
    np.testing.assert_array_equal(got["valid"], want["valid"])
    np.testing.assert_array_equal(got["labels"], want["labels"])
    np.testing.assert_allclose(got["boxes"], want["boxes"], rtol=1e-4,
                               atol=1e-3)
    with pytest.raises(TypeError, match="Mesh"):
        Predictor(pred.cfg, pred.model, mesh=object())
    from two_stage_object_detection_tpu_torch.parallel.mesh import Mesh
    with pytest.raises(ValueError, match="one process"):
        Predictor(pred.cfg, pred.model,
                  mesh=Mesh({"data": 2, "model": 1}, (pred.model.device,),
                            group=object()))
    with pytest.raises(ValueError, match="wire"):
        Predictor(pred.cfg, pred.model, wire="u16")


def test_yuv420_rejects_bad_requests(served, rng):
    pred, _ = served
    port = Predictor(pred.cfg, pred.model, batch_sizes=(1,), wire="yuv420")
    with pytest.raises(ValueError):
        port(rng.rand(1, H, W, 3).astype(np.float32))     # float RGB
    with pytest.raises(ValueError):
        port(np.zeros((1, 7, 7), np.uint8))                # packed, wrong shape
    with pytest.raises(ValueError, match="even"):
        Predictor(pred.cfg.replace(input_size=(62, 63)), pred.model,
                  wire="yuv420")


def test_yuv420_pads_chunks_and_batcher(served, rng):
    """3 images in a padded 4-bucket (zero-chroma pads) answer as one by
    one, and through the batcher (packed in the submitting thread)."""
    pred, _ = served
    port = Predictor(pred.cfg, pred.model, batch_sizes=(1, 4), wire="yuv420")
    u8 = _u8(rng, 3)
    assert port._plan(3) == (4,)
    want = port(u8)
    with DynamicBatcher(port, max_wait_ms=20.0) as dyn:
        outs = [f.result(timeout=60) for f in [dyn.submit(u8[i])
                                               for i in range(3)]]
    for i, out in enumerate(outs):
        np.testing.assert_allclose(out["boxes"], want["boxes"][i:i + 1],
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_array_equal(out["valid"], want["valid"][i:i + 1])


# ------------------------------------------------------------ DynamicBatcher
def _f32(rng, n):
    return rng.rand(n, H, W, 3).astype(np.float32)


def test_dynamic_batcher_matches_direct(served, rng):
    pred, _ = served
    port = Predictor(pred.cfg, pred.model, batch_sizes=(1, 4))
    x = _f32(rng, 3)
    want = port(x)
    with DynamicBatcher(port, max_wait_ms=20.0) as dyn:
        outs = [f.result(timeout=60) for f in [dyn.submit(x[i])
                                               for i in range(3)]]
    for i, out in enumerate(outs):
        assert out["boxes"].shape == (1, pred.cfg.max_detections, 4)
        for k in FIELDS:
            np.testing.assert_allclose(out[k], want[k][i:i + 1], rtol=1e-5,
                                       atol=1e-5)


def test_dynamic_batcher_concurrent_threads(served, rng):
    pred, _ = served
    port = Predictor(pred.cfg, pred.model, batch_sizes=(1, 4))
    reqs = [_f32(rng, n) for n in (1, 2, 1, 3, 1, 2)]
    want = [port(r) for r in reqs]
    results = [None] * len(reqs)
    with DynamicBatcher(port, max_wait_ms=10.0) as dyn:
        def go(i):
            results[i] = dyn.submit(reqs[i]).result(timeout=60)
        ts = [threading.Thread(target=go, args=(i,)) for i in range(len(reqs))]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=120)
            assert not t.is_alive()
    assert 1 <= dyn.flushes <= len(reqs)
    for got, ref, req in zip(results, want, reqs):
        assert got["boxes"].shape == (req.shape[0], pred.cfg.max_detections, 4)
        np.testing.assert_allclose(got["boxes"], ref["boxes"], rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_array_equal(got["valid"], ref["valid"])


def test_dynamic_batcher_close_flushes_pending(served, rng):
    pred, _ = served
    port = Predictor(pred.cfg, pred.model, batch_sizes=(4,))
    dyn = DynamicBatcher(port, max_wait_ms=10_000.0)     # never by time
    fut = dyn.submit(_f32(rng, 2))
    dyn.close()
    out = fut.result(timeout=0)            # resolved by the closing flush
    assert out["boxes"].shape == (2, pred.cfg.max_detections, 4)
    with pytest.raises(RuntimeError, match="closed"):
        dyn.submit(_f32(rng, 1))


def test_dynamic_batcher_survives_cancelled_future(served, rng):
    pred, _ = served
    port = Predictor(pred.cfg, pred.model, batch_sizes=(4,))
    with DynamicBatcher(port, max_wait_ms=200.0) as dyn:
        doomed = dyn.submit(_f32(rng, 1))
        assert doomed.cancel()
        out = dyn.submit(_f32(rng, 2)).result(timeout=60)
        assert out["boxes"].shape == (2, pred.cfg.max_detections, 4)
    assert doomed.cancelled()


def test_dynamic_batcher_rejects_wrong_shape_and_dtype(served, rng):
    """Each request is validated in the submitting thread, so one bad
    submit cannot poison a collated flush."""
    pred, _ = served
    pf = Predictor(pred.cfg, pred.model, batch_sizes=(1,))
    pu = Predictor(pred.cfg, pred.model, batch_sizes=(1,), wire="u8")
    with DynamicBatcher(pf) as dyn:
        with pytest.raises(ValueError, match="static"):
            dyn.submit(np.zeros((1, 8, 8, 3), np.float32))
        with pytest.raises(ValueError, match="float"):
            dyn.submit(_u8(rng, 1))
    with DynamicBatcher(pu) as dyn:
        with pytest.raises(ValueError, match="uint8"):
            dyn.submit(_f32(rng, 1))


class _Echo:
    """A stand-in predictor: each image's "boxes" are its own pixels, so a
    request gets back exactly what it sent when collation keeps order."""

    batch_sizes = (4,)

    def __init__(self):
        self.calls = []

    def _to_wire(self, images):
        return images[None] if images.ndim == 1 else images

    def __call__(self, images):
        self.calls.append(len(images))
        return {"boxes": images.copy()}


def test_dynamic_batcher_stress():
    """64 threads (more than the cores) submit 4 requests of 1-3 rows each
    with the interpreter switching threads every microsecond: every future
    resolves to its own rows, every row is run once, and no flush is
    larger than the queue held."""
    pred = _Echo()
    results = {}
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with DynamicBatcher(pred, max_wait_ms=1.0) as dyn:
            def client(t):
                for j in range(4):
                    req = np.full((1 + (t + j) % 3, 2), t * 10 + j, np.int64)
                    results[t, j] = (req, dyn.submit(req).result(timeout=60))
            ts = [threading.Thread(target=client, args=(t,)) for t in range(64)]
            for t in ts:
                t.start()
            for t in ts:
                t.join(timeout=120)
                assert not t.is_alive()
    finally:
        sys.setswitchinterval(old)
    assert len(results) == 256
    for req, out in results.values():
        np.testing.assert_array_equal(out["boxes"], req)
    assert sum(pred.calls) == sum(len(r) for r, _ in results.values())
    assert dyn.flushes == len(pred.calls)
