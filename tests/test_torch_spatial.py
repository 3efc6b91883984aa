"""PyTorch port, image rows over the model axis (``parallel/spatial.py``), on
the CPU:

* ``auto_mesh_spatial``'s axes against the JAX package's on a table of
  batch sizes and device counts;
* every row-sharded layer of the backbone and neck (3x3 stride 1 and 2,
  7x7 stride 2, 1x1 stride 2, depth-wise 3x3 stride 2, the -inf max pool,
  the FPN's upsample-and-crop and its P6) on maps 75, 38, 19 and 1 rows
  high over 2, 3 and 4 shards (empty shards included), forward and
  backward, in float64 against the unsharded layer, the shards being
  worker threads of the in-process transport;
* the batch norm over uneven row shards, one of them empty, in 3 gloo
  ranks against the whole batch;
* ``Predictor(spatial=True)`` of both ported detectors over meshes of CPU
  "devices" against the JAX package's one-device predict on the same
  weights, the buckets that take JAX's other routes, and a request after
  a shard failed.

The train step and ``train(spatial=True)``: ``tests/test_torch_spatial_train.py``.
"""

import threading
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tests import torch_dp_workers as workers
from tests.test_torch_serving import KW, jax_model
from tests.test_torch_single_scale import KW as SINGLE_KW, _variables
from two_stage_object_detection_tpu.config import Config as JConfig
from two_stage_object_detection_tpu.nets.detector import (
    FasterRCNN as JFasterRCNN)
from two_stage_object_detection_tpu.parallel import mesh as jmesh
from two_stage_object_detection_tpu_torch.config import Config
from two_stage_object_detection_tpu_torch.models.layers import BatchNorm, Conv
from two_stage_object_detection_tpu_torch.nets import fpn
from two_stage_object_detection_tpu_torch.parallel import mesh as pmesh
from two_stage_object_detection_tpu_torch.parallel import spatial
from two_stage_object_detection_tpu_torch.serving import FIELDS, Predictor


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------ meshes
@pytest.mark.parametrize("batch,devices,want", [
    (2, 8, (2, 4)), (1, 8, (1, 8)), (16, 8, (8, 1)), (6, 8, (2, 4)),
    (4, 4, (4, 1)), (3, 4, (1, 4)), (6, 4, (2, 2)), (1, 2, (1, 2)),
    (9, 6, (3, 2)), (5, 1, None)])
def test_auto_mesh_spatial_axes_equal_jax(monkeypatch, batch, devices, want):
    """The ``(data, model)`` axes the port picks, within a process over
    ``devices`` CPU "devices", equal the JAX package's ``auto_mesh_spatial``
    fed as many fake devices (the table of its own tests included); both
    give no mesh on one device."""
    seen = {}

    def capture(n_data=None, n_model=1, devices=None):
        seen.update(n_data=n_data, n_model=n_model)
        return "mesh"

    monkeypatch.setattr(jmesh, "make_mesh", capture)
    fake = [types.SimpleNamespace(id=i) for i in range(devices)]
    got = pmesh.auto_mesh_spatial(batch, devices=["cpu"] * devices)
    if want is None:
        assert jmesh.auto_mesh_spatial(batch, devices=fake) is None
        assert got is None
        return
    assert jmesh.auto_mesh_spatial(batch, devices=fake) == "mesh"
    assert (seen["n_data"], seen["n_model"]) == want
    assert pmesh.spatial_axes(batch, devices) == want
    assert (got.shape["data"], got.shape["model"]) == want
    assert len(got.devices) == devices


def test_row_edges_and_levels():
    """600 rows over 4 shards: equal image blocks, uneven from stride 4 on
    (38, 37, 38, 37), a map found by its width; heights that do not divide
    are refused, as the JAX placement refuses them; a shard's rows come
    from ``shard_batch_spatial``'s split."""
    assert spatial.split_rows(600, 4) == (0, 150, 300, 450, 600)
    with pytest.raises(ValueError, match="divide"):
        spatial.split_rows(64, 3)
    shard = spatial.Shard(spatial.ThreadGroup(4).transport(1), 600, 600)
    x = torch.zeros(1, 1, 37, 150)
    assert shard.edges(x) == (0, 38, 75, 113, 150)
    assert shard.rows(x) == (38, 75)
    with pytest.raises(ValueError, match="holds rows"):
        shard.rows(torch.zeros(1, 1, 38, 150))
    with pytest.raises(ValueError, match="wide"):
        shard.edges(torch.zeros(1, 1, 37, 151))


# ------------------------------------------------------------ layers
W_IMG = 48
# (image height, the op input's stride) a shard count: maps 75, 38, 19 and
# 1 rows high; the 1-row map leaves every shard but the first empty
GEOMETRY = {2: [(600, 8), (600, 16), (600, 32), (32, 32)],
            3: [(600, 8), (600, 16), (600, 32), (30, 32)],
            4: [(600, 8), (600, 16), (600, 32), (32, 32)]}


def _conv(k, s, groups=1):
    def make(rng):
        c = Conv(4, 4 if groups > 1 else 6, k, s, k // 2, groups=groups,
                 compute_dtype=torch.float64).double()
        with torch.no_grad():
            c.weight.copy_(torch.from_numpy(rng.randn(*c.weight.shape)))
            c.bias.copy_(torch.from_numpy(rng.randn(*c.bias.shape)))
        return c, c, [c.weight, c.bias]
    return make


def _pool(rng):
    return (lambda x: F.max_pool2d(x, 3, 2, 1),
            lambda x: spatial.max_pool(x, 3, 2, 1), [])


def _p6(rng):
    return (lambda x: x[:, :, ::2, ::2], fpn._subsample2x, [])


# each op: (its make, whether its forward only copies values, whether it
# upsamples: its input is the map one level coarser than the geometry's)
OPS = {"conv3x3_s1": (_conv(3, 1), False, False),
       "conv3x3_s2": (_conv(3, 2), False, False),
       "conv7x7_s2": (_conv(7, 2), False, False),
       "conv1x1_s2": (_conv(1, 2), False, False),
       "dwconv3x3_s2": (_conv(3, 2, groups=4), False, False),
       "max_pool_3_2_1": (_pool, True, False),
       "upsample_crop": (None, True, True),
       "p6": (_p6, True, False)}


def _run_shards(n, h_img, fn, inputs, dy):
    """``fn`` on each of ``n`` worker threads' rows of ``inputs`` (global
    maps; the first is differentiated) under its shard, backward from its
    rows of ``dy``: the shards' outputs and input gradients, each
    concatenated in row order."""
    group = spatial.ThreadGroup(n)
    outs, errors = [None] * n, []

    def work(i):
        try:
            shard = spatial.Shard(group.transport(i), h_img, W_IMG)
            local = [shard.own_rows(t, t).clone() for t in inputs]
            local[0].requires_grad_()
            with spatial.sharded(shard):
                y = fn(*local)
            (y * shard.own_rows(dy, y)).sum().backward()
            outs[i] = (y.detach(), local[0].grad)
        except Exception as e:                             # noqa: BLE001
            errors.append(e)
            group.abort()

    _run(work, n)
    assert not errors, errors
    return (torch.cat([o[0] for o in outs], 2),
            torch.cat([o[1] for o in outs], 2))


def _run(work, n: int) -> None:
    """``work(i)`` on ``n`` threads, each joined within 120 s."""
    threads = [threading.Thread(target=work, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert not any(t.is_alive() for t in threads)


def _close(got, want):
    scale = float(want.abs().max()) if want.numel() else 0.0
    assert float((got - want).abs().max()) <= 1e-12 * max(scale, 1.0)


@pytest.mark.parametrize("shards", sorted(GEOMETRY))
@pytest.mark.parametrize("op", list(OPS))
def test_row_sharded_layer_matches_unsharded(op, shards):
    """Each layer on row shards, float64: the output (bit for bit where the
    layer only copies values, within 1e-12 of its largest magnitude where
    it sums), the input gradient and, summed over the shards, the weight
    and bias gradients (within 1e-12 of their largest magnitude) equal the
    unsharded layer's, on every geometry of ``GEOMETRY``."""
    make, copies, upsamples = OPS[op]
    rng = np.random.RandomState(0)
    for h_img, s in GEOMETRY[shards]:
        h, w = -(-h_img // s), -(-W_IMG // s)
        if upsamples:
            # coarse (the differentiated input) at 2s, the lateral at s
            coarse = torch.from_numpy(rng.randn(2, 4, -(-h // 2),
                                                -(-w // 2)))
            like = torch.from_numpy(rng.randn(2, 4, h, w))
            full = lambda c, lat: fpn._upsample2x_to(c, lat)
            inputs, params = [coarse, like], []
            sharded = full
        else:
            full, sharded, params = make(rng)
            inputs = [torch.from_numpy(rng.randn(2, 4, h, w))]
        x = inputs[0].clone().requires_grad_()
        y = full(x, *inputs[1:])
        dy = torch.from_numpy(rng.randn(*y.shape))
        (y * dy).sum().backward()
        want_p = [p.grad.clone() for p in params]
        for p in params:
            p.grad = None
        got_y, got_dx = _run_shards(shards, h_img, sharded, inputs, dy)
        assert got_y.shape == y.shape
        if copies:
            assert torch.equal(got_y, y.detach()), (h_img, s)
        else:
            _close(got_y, y.detach())
        _close(got_dx, x.grad)
        for p, want in zip(params, want_p):
            _close(p.grad, want)
            p.grad = None


def test_trunk_on_row_shards_matches_unsharded():
    """The flagship's whole ResNet-50 + FPN trunk at 64x64 in float64 (eval
    mode, with autograd) on 4 row shards, C5 and P6 empty on two of them:
    each shard's rows of P2..P6 and, each shard backpropagating its rows'
    part of the loss, every parameter's gradient summed over the shards,
    within 1e-12 of the largest magnitude of the unsharded ones; the maps
    gathered onto the lead shard (the in-process gather), None on the
    others."""
    from two_stage_object_detection_tpu_torch.nets.detector import FasterRCNN
    cfg = Config(**{**KW, "input_size": (64, 64)}, device="cpu")
    model = FasterRCNN(cfg, device="cpu").double()
    for m in model.modules():
        if isinstance(m, Conv):
            m.compute_dtype = torch.float64
    x = torch.from_numpy(np.random.RandomState(1).rand(2, 64, 64, 3))
    want = model.local_features(x)
    dys = [torch.from_numpy(np.random.RandomState(i).randn(*f.shape))
           for i, f in enumerate(want)]
    sum((f * d).sum() for f, d in zip(want, dys)).backward()
    want_g = {n: p.grad.clone() for n, p in model.named_parameters()
              if p.grad is not None}
    model.zero_grad(set_to_none=True)
    n = 4
    group, got, errors = spatial.ThreadGroup(n), [None] * n, []

    def work(i):
        try:
            shard = spatial.Shard(group.transport(i), 64, 64)
            with spatial.sharded(shard):
                local = model.local_features(shard.own_image_rows(x))
            sum((f * shard.own_rows(d, f)).sum()
                for f, d in zip(local, dys)).backward()
            got[i] = ([f.detach() for f in local], shard.gather(local))
        except Exception as e:                             # noqa: BLE001
            errors.append(e)
            group.abort()

    _run(work, n)
    assert not errors, errors
    for lvl, w in enumerate(want):
        _close(torch.cat([g[0][lvl] for g in got], 2), w.detach())
        _close(got[0][1][lvl], w.detach())
    assert [g[1] for g in got[1:]] == [None] * (n - 1)
    top = max(float(g.abs().max()) for g in want_g.values())
    assert set(want_g) == {n for n, p in model.named_parameters()
                           if p.grad is not None}
    for name, w in want_g.items():
        g = model.get_parameter(name).grad
        assert float((g - w).abs().max()) <= 1e-12 * top, name


# ------------------------------------------------------------ batch norm
def test_batch_norm_over_uneven_row_shards(tmp_path):
    """Three gloo ranks holding 5, 0 and 3 of 8 rows of each image: the
    output and input gradient of each rank's rows, the weight and bias
    gradients summed over the ranks and the running statistics equal the
    one-process layer's on the whole maps, within 1e-6 of each tensor's
    largest magnitude (the cross-replica test's rule)."""
    rng = np.random.RandomState(0)
    x = (rng.randn(2, 3, 8, 5) * 2 + 1).astype(np.float32)
    dy = rng.randn(*x.shape).astype(np.float32)
    weight = rng.uniform(0.5, 1.5, 3).astype(np.float32)
    bias = rng.randn(3).astype(np.float32)
    edges = (0, 5, 5, 8)
    ranks = workers.spawn(workers.row_norm_rank, 3, str(tmp_path), x, dy,
                          weight, bias, edges)
    bn = BatchNorm(3).train()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(weight))
        bn.bias.copy_(torch.from_numpy(bias))
    xt = torch.from_numpy(x).requires_grad_()
    y = bn(xt)
    (y * torch.from_numpy(dy)).sum().backward()

    def close(got, want):
        got, want = got.detach().numpy(), want.detach().numpy()
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-6 * np.abs(want).max())

    close(torch.cat([r["y"] for r in ranks], 2), y)
    close(torch.cat([r["dx"] for r in ranks], 2), xt.grad)
    assert ranks[1]["y"].shape == (2, 3, 0, 5)
    for r in ranks:
        close(r["dweight"], bn.weight.grad)
        close(r["dbias"], bn.bias.grad)
        close(r["running_mean"], bn.running_mean)
        close(r["running_var"], bn.running_var)


# ------------------------------------------------------------ Predictor
_JAX_PREDICT = {}


def _jax_predict(jm, v, x):
    """The JAX package's one-device predict: one jitted function a model,
    so each request shape compiles once."""
    if id(jm) not in _JAX_PREDICT:
        _JAX_PREDICT[id(jm)] = jax.jit(
            lambda v, x: jm.apply(v, x, method="predict"))
    return [np.asarray(a) for a in _JAX_PREDICT[id(jm)](v, x)]


def _assert_matches(got, want):
    """``valid`` and ``labels`` equal, boxes within ``rtol=1e-4,
    atol=1e-3`` (the JAX package's spatial test's tolerance)."""
    gb, _, gl, gv = (got[k] for k in FIELDS)
    wb, _, wl, wv = want
    assert gv.sum() > 0
    np.testing.assert_array_equal(gv, wv)
    np.testing.assert_array_equal(gl, wl)
    np.testing.assert_allclose(gb, wb, rtol=1e-4, atol=1e-3)


@pytest.fixture(scope="module")
def flagship():
    jm, v = jax_model()
    return jm, v, Config(**KW, device="cpu")


@pytest.fixture(scope="module")
def single():
    jm = JFasterRCNN(JConfig(**SINGLE_KW, pallas="on", pallas_roi=False))
    v = _variables(jm, jnp.zeros((1, 128, 128, 3)))
    v["params"]["rpn_head"]["loc"]["kernel"] *= 0.1
    return jm, v, Config(**SINGLE_KW, device="cpu")


@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("model", ["flagship", "single"])
def test_spatial_predictor_matches_jax(request, model, shards):
    """A batch-1 request with its rows over ``(1, shards)`` CPU "devices"
    (the flagship's 64-pixel image leaves C5 and P6 empty on two of 4
    shards; the single scale's 128 pixels give 2 of 8 stride-16 rows a
    shard at 4) equals the JAX package's one-device predict."""
    jm, v, cfg = request.getfixturevalue(model)
    h = cfg.input_size[0]
    x = np.random.RandomState(3).rand(1, h, h, 3).astype(np.float32)
    mesh = pmesh.make_mesh(1, shards, devices=["cpu"] * shards)
    port = Predictor.from_jax_variables(cfg, v["params"], v["batch_stats"],
                                        device="cpu", batch_sizes=(1,),
                                        mesh=mesh, spatial=True)
    assert port.spatial
    _assert_matches(port(x), _jax_predict(jm, v, x))


def test_spatial_predictor_routes_buckets_as_jax(flagship, monkeypatch):
    """On a ``(2, 2)`` mesh a bucket the data axis divides runs by rows
    (every data index on its 2 row shards) and equals JAX; bucket 1 runs
    as without ``spatial`` (the JAX spec is ``P("data", "model")`` only
    where the data axis divides the bucket).  The yuv420 wire and a height
    the model axis does not divide take no row split (JAX's
    ``h % n_model == 0 and wire != "yuv420"``) and answer bit for bit as
    the predictor on the same mesh without ``spatial``.  The u8 wire
    splits rows too."""
    jm, v, cfg = flagship
    rng = np.random.RandomState(4)
    x = rng.rand(3, 64, 64, 3).astype(np.float32)
    mesh = pmesh.make_mesh(2, 2, devices=["cpu"] * 4)
    port = Predictor.from_jax_variables(cfg, v["params"], v["batch_stats"],
                                        device="cpu", batch_sizes=(1, 2),
                                        mesh=mesh, spatial=True)
    runs = []
    real = port._enqueue_spatial
    monkeypatch.setattr(port, "_enqueue_spatial",
                        lambda b, host: runs.append(b) or real(b, host))
    assert port._plan(3) == (1, 2)
    _assert_matches(port(x), _jax_predict(jm, v, x))
    assert runs == [2]
    u8 = rng.randint(0, 256, (2, 64, 64, 3)).astype(np.uint8)
    port_u8 = Predictor(cfg, port.model, batch_sizes=(2,), mesh=mesh,
                        spatial=True, wire="u8")
    _assert_matches(port_u8(u8), _jax_predict(
        jm, v, (u8.astype(np.float32) / 255.0).astype(np.float32)))
    for kw in ({"mesh": mesh, "wire": "yuv420"},
               {"mesh": pmesh.make_mesh(1, 3, devices=["cpu"] * 3)}):
        other = Predictor(cfg, port.model, batch_sizes=(2,), spatial=True,
                          **kw)
        assert not other.spatial
        ref = Predictor(cfg, port.model, batch_sizes=(2,), **kw)
        img = u8 if "wire" in kw else x[:2]
        got, want = other(img), ref(img)
        for k in FIELDS:
            np.testing.assert_array_equal(got[k], want[k])


def test_spatial_predictor_recovers_from_a_failed_shard(flagship,
                                                        monkeypatch):
    """A shard whose predict raises releases the others at once (its group
    aborted, well inside the barrier's timeout) and the request raises;
    the next request gets a new group of shards and answers as before."""
    _, v, cfg = flagship
    monkeypatch.setattr(spatial, "BARRIER_TIMEOUT", 60.0)
    x = np.random.RandomState(5).rand(1, 64, 64, 3).astype(np.float32)
    port = Predictor.from_jax_variables(
        cfg, v["params"], v["batch_stats"], device="cpu", batch_sizes=(1,),
        mesh=pmesh.make_mesh(1, 2, devices=["cpu"] * 2), spatial=True)
    want = port(x)

    def fail(*_):
        raise RuntimeError("shard 1 failed")

    port._grid[1].local_features = fail
    t0 = time.perf_counter()
    with pytest.raises((RuntimeError, threading.BrokenBarrierError)):
        port(x)
    assert time.perf_counter() - t0 < 30.0
    del port._grid[1].local_features
    got = port(x)
    for k in FIELDS:
        np.testing.assert_array_equal(got[k], want[k])


def test_model_axis_across_nodes_falls_back(monkeypatch, caplog):
    """``train(spatial=True)``'s guard: a model axis that would cross nodes
    (torchrun's ``LOCAL_WORLD_SIZE`` not a multiple of it) warns and takes
    data parallelism, as the JAX package falls back over several
    processes; within one node it stays (without torchrun's variable the
    ranks are taken to share one node: the world, here one process)."""
    from two_stage_object_detection_tpu_torch.parallel.mesh import (
        model_axis_local)
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "8")
    assert model_axis_local(4)
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "6")
    with caplog.at_level("WARNING"):
        assert not model_axis_local(4)
    assert "cross nodes" in caplog.text
    monkeypatch.delenv("LOCAL_WORLD_SIZE")
    assert model_axis_local(1) and not model_axis_local(2)


def test_hardnet85_dropout_mask_by_global_rows():
    """HarDNet-85's train-mode dropout on row shards: each shard applies its
    rows of the mask drawn for the whole map from equal generators (the
    unsharded mask, bit for bit); without a generator the shards could not
    agree on one, and it raises."""
    from two_stage_object_detection_tpu_torch.models.hardnet import (
        HarDNetFeatureExtraction)
    ext = HarDNetFeatureExtraction(39)
    h_img, s, n = 600, 16, 3                 # a 38-row map: 13, 12, 13 rows
    x = torch.from_numpy(np.random.RandomState(0).rand(2, 5, 38, 3))
    want = ext._dropout(x, torch.Generator().manual_seed(7))
    group, got, errors = spatial.ThreadGroup(n), [None] * n, []

    def work(i):
        try:
            shard = spatial.Shard(group.transport(i), h_img, W_IMG)
            mine = shard.own_rows(x, x)
            with spatial.sharded(shard):
                got[i] = ext._dropout(mine, torch.Generator().manual_seed(7))
                with pytest.raises(ValueError, match="generator"):
                    ext._dropout(mine, None)
        except BaseException as e:                         # noqa: BLE001
            errors.append(e)

    _run(work, n)
    assert not errors, errors
    assert [g.shape[2] for g in got] == [13, 12, 13]
    assert torch.equal(torch.cat(got, 2), want)


def test_thread_transport_under_contention(monkeypatch):
    """The in-process transport's board under contention: 8 worker threads,
    the interpreter switching threads
    every microsecond, 200 gathers each, random pauses between them: every
    gather returns every worker's value of that round, in index order, and
    every sum is the same on every worker."""
    import random
    import sys
    n, rounds = 8, 200
    monkeypatch.setattr(spatial, "BARRIER_TIMEOUT", 60.0)
    group, errors = spatial.ThreadGroup(n), []

    def work(i):
        try:
            tr, rnd = group.transport(i), random.Random(i)
            for k in range(rounds):
                if rnd.random() < 0.1:
                    threading.Event().wait(rnd.random() * 1e-3)
                got = tr.all_gather(torch.tensor([k, i], dtype=torch.int64))
                assert got.tolist() == [[k, j] for j in range(n)], (i, k)
                total = tr.all_reduce(torch.tensor([float(i + k)]))
                assert float(total) == n * k + n * (n - 1) / 2, (i, k)
        except Exception as e:                             # noqa: BLE001
            errors.append(e)
            group.abort()

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        _run(work, n)
    finally:
        sys.setswitchinterval(old)
    assert not errors, errors
