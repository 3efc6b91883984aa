"""PyTorch port, ``parallel/`` (the data axis) and ``utils/profiling.py``,
on the CPU: the cross-replica batch norm over 2 gloo ranks against the
one-process layer over the concatenated batch; the collectives and the
batch placement; ``should_stop(sync=True)`` across ranks; ``auto_mesh``'s
axes against the JAX package's; a mesh train step at a world of 1 bit for
bit the meshless one; ``Predictor(mesh=)`` over two CPU replicas against
the meshless ``Predictor`` and the JAX one under a ``(data=2)`` mesh; the
model axis's meshes within a process, and ``spatial`` building;
``parallel.dryrun 2``; the profiling hooks.  (The model axis over ranks:
``tests/test_torch_parallel_tp.py``.)

Each multi-rank test spawns its ranks (``tests/torch_dp_workers.py``), a
gloo group over a file store in the test's temporary directory.
"""

import os
import subprocess
import sys
import types

import jax
import numpy as np
import pytest
import torch

from tests import torch_dp_workers as workers
from tests.test_torch_serving import KW, assert_matches_jax, jax_model
from tests.test_torch_train import COMMON, _batch
from two_stage_object_detection_tpu import serving as jserving
from two_stage_object_detection_tpu.config import Config as JConfig
from two_stage_object_detection_tpu.parallel import mesh as jmesh
from two_stage_object_detection_tpu_torch.config import Config
from two_stage_object_detection_tpu_torch.models.layers import BatchNorm
from two_stage_object_detection_tpu_torch.nets.trainer import (
    create_train_state, train_step)
from two_stage_object_detection_tpu_torch.parallel import mesh as pmesh
from two_stage_object_detection_tpu_torch.parallel import multiprocess
from two_stage_object_detection_tpu_torch.serving import FIELDS, Predictor
from two_stage_object_detection_tpu_torch.train import train
from two_stage_object_detection_tpu_torch.utils import profiling
from two_stage_object_detection_tpu_torch.utils.preemption import (
    PreemptionGuard)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------ batch norm
def test_cross_replica_batch_norm_matches_concatenated_batch(tmp_path):
    """Over 2 ranks of 2 images each: the output and input gradient of each
    rank's rows, the weight and bias gradients summed over the ranks, and
    the running statistics equal those of the one-process layer over the 4
    images, each within 1e-6 of its largest magnitude (float32 sums in
    another order); the ranks' statistics and summed gradients are equal
    bit for bit.  The channels' means sit at 3 standard deviations, where a
    plain sum of squares would lose the variance."""
    rng = np.random.RandomState(0)
    x = (rng.randn(4, 8, 5, 5) * 2 + 6).astype(np.float32)
    dy = rng.randn(4, 8, 5, 5).astype(np.float32)
    w = rng.uniform(0.5, 1.5, 8).astype(np.float32)
    b = rng.randn(8).astype(np.float32)
    res = workers.spawn(workers.batch_norm_rank, 2, str(tmp_path), x, dy, w, b)

    bn = BatchNorm(8).train()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(w))
        bn.bias.copy_(torch.from_numpy(b))
    xt = torch.from_numpy(x).requires_grad_()
    y = bn(xt)
    (y * torch.from_numpy(dy)).sum().backward()
    want = {"y": y.detach(), "dx": xt.grad, "dweight": bn.weight.grad,
            "dbias": bn.bias.grad, "running_mean": bn.running_mean,
            "running_var": bn.running_var}
    for r, got in enumerate(res):
        for k, v in want.items():
            v = v[2 * r:2 * r + 2] if k in ("y", "dx") else v
            tol = 1e-6 * max(1.0, float(v.abs().max()))
            np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=0,
                                       atol=tol, err_msg=f"rank {r} {k}")
    for k in ("dweight", "dbias", "running_mean", "running_var"):
        assert torch.equal(res[0][k], res[1][k]), k


def test_batch_norm_without_a_group_is_the_plain_layer():
    """No data group (one process, or a world of 1): the layer runs
    ``F.batch_norm`` as before, bit for bit, statistics included."""
    rng = np.random.RandomState(1)
    x = torch.from_numpy(rng.randn(3, 4, 6, 6).astype(np.float32))
    bn = BatchNorm(4).train()
    assert bn.group is None
    mean, var = torch.zeros(4), torch.zeros(4)
    want = torch.nn.functional.batch_norm(x, mean, var, bn.weight, bn.bias,
                                          True, 1.0, bn.EPS)
    assert torch.equal(bn(x), want)
    assert torch.equal(bn.running_mean, 0.1 * mean)
    n = 3 * 6 * 6
    assert torch.equal(bn.running_var,
                       torch.ones(4).mul_(0.9).add_(var,
                                                    alpha=0.1 * (n - 1) / n))


def test_mesh_train_step_at_a_world_of_one_is_the_meshless_step(tmp_path):
    """A gloo world of 1 (what ``chip_smoke.py`` runs over NCCL): the mesh
    train step, its gradient all-reduce included, equals the meshless step
    bit for bit; no batch norm takes a group."""
    cfg_kw = dict(COMMON, grad_accum_steps=2)
    rng = np.random.RandomState(4)
    batches = [_batch(rng) for _ in range(2)]
    model, state = create_train_state(Config(**cfg_kw, device="cpu"), seed=0)
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    (got,) = workers.spawn(workers.train_step_rank, 1, str(tmp_path), cfg_kw,
                           sd, batches, 2)
    for b in batches:
        _, out = train_step(state, b)
    assert got["updates"] == state.updates == 1 and got["bn_groups"] == 0
    for k, v in model.state_dict().items():
        assert torch.equal(got["state"][k], v), k
    assert got["losses"][-1] == {k: float(v) for k, v in out.items()}


# ------------------------------------------------------------ collectives
def test_collectives_and_batch_placement_over_two_ranks(tmp_path):
    """``shard_batch`` (each rank's own batch, or its block of rows of the
    same full batch), ``fetch_global`` (every rank the full value, in rank
    order; a 0-d leaf a value a rank) and booleans through ``all_gather``."""
    res = workers.spawn(workers.collectives_rank, 2, str(tmp_path))
    full = np.arange(12, dtype=np.float32).reshape(4, 3)
    for r, got in enumerate(res):
        assert got["shape"] == {"data": 2, "model": 1} and got["index"] == r
        np.testing.assert_array_equal(got["mine"]["x"], full[2 * r:2 * r + 2])
        np.testing.assert_array_equal(got["local"], full[:2] + 100 * r)
        np.testing.assert_array_equal(got["fetched"]["t"][0], full)
        np.testing.assert_array_equal(got["fetched"]["t"][1], [0, 1])
        np.testing.assert_array_equal(got["bools"],
                                      [[True, False], [True, True]])


def test_should_stop_sync_agrees_across_ranks(tmp_path):
    """Rank 1 alone asks at poll 5; with ``sync_every=4`` both ranks stop
    at poll 8, the first synced poll after the request, and stay stopped;
    rank 0 never saw a local request."""
    res = workers.spawn(workers.should_stop_rank, 2, str(tmp_path), 5, 4)
    assert [r["stopped_at"] for r in res] == [8, 8]
    assert [r["local"] for r in res] == [False, True]
    assert all(r["after"] == [True] * 3 for r in res)


def test_should_stop_sync_throttles_collectives(monkeypatch):
    """The JAX package's ``tests/test_preemption.py`` case: synced polls
    issue the collective every ``sync_every``-th poll only, and return the
    last agreement; ``sync=None`` in one process reads the local flag."""
    calls = []

    def fake_all_reduce(t, op="sum", group=None):
        calls.append(op)
        return t

    monkeypatch.setattr(multiprocess, "all_reduce_", fake_all_reduce)
    guard = PreemptionGuard(sync_every=4)
    for _ in range(3):
        assert guard.should_stop(sync=True) is False
    assert calls == []
    guard.request()
    assert guard.should_stop(sync=True) is True
    assert calls == ["max"]
    assert guard.should_stop(sync=True) is True
    assert calls == ["max"]
    local = PreemptionGuard()
    assert local.should_stop() is False
    local.request()
    assert local.should_stop() is True and calls == ["max"]


# ------------------------------------------------------------ meshes
# (devices, batch, processes): one process, and several with one or more
# devices each, with a batch that does and does not divide the data axis
AUTO_MESH = [(8, 16, 1), (8, 6, 1), (8, 7, 1), (3, 16, 1), (1, 16, 1),
             (2, 16, 2), (4, 16, 2), (4, 3, 2), (8, 4, 4), (8, 8, 4),
             (16, 12, 4), (4, 2, 4)]


@pytest.mark.parametrize("devices,batch,processes", AUTO_MESH)
def test_auto_mesh_axes_equal_jax(monkeypatch, devices, batch, processes):
    """The data axis ``auto_mesh`` picks (and the devices a process it
    uses, over several processes) equal the JAX package's ``auto_mesh``
    for the same device count,
    batch and process count, fed fake devices and a patched
    ``process_count``; both give no mesh on one device."""
    fake = [types.SimpleNamespace(id=i, process_index=i * processes // devices)
            for i in range(devices)]
    seen = {}

    def capture(n_data=None, n_model=1, devices=None):
        seen.update(n_data=n_data, devices=devices)
        return "mesh"

    monkeypatch.setattr(jax, "process_count", lambda: processes)
    monkeypatch.setattr(jmesh, "make_mesh", capture)
    want = jmesh.auto_mesh(batch, devices=fake)
    if devices <= 1:
        assert want is None
        return
    n_data, per_process = pmesh.data_axis(batch, devices, processes)
    if want is None:
        assert n_data <= 1
        return
    assert seen["n_data"] == n_data
    if processes > 1:       # one process: make_mesh takes the first n_data
        counts = np.bincount([d.process_index for d in seen["devices"]])
        assert set(counts.tolist()) == {per_process}


def test_model_axis_and_spatial_raise(tmp_path):
    """The model axis is ported: within one process ``make_mesh`` and
    ``auto_mesh`` with ``n_model=2`` build ``(data, model)`` grids, and
    one with too few devices raises ``ValueError``.  Spatial sharding (image
    rows over ``model``) is ported too, and every route to it builds and
    runs: ``auto_mesh_spatial`` gives a batch of 1 on 2 devices a ``(1,
    2)`` mesh, ``shard_batch_spatial`` places a rank's rows (a mesh within
    one process has no rank: ``ValueError``), ``train(spatial=True)`` in one
    process trains on one device as ``train()`` does (here it reaches the
    missing data root), and ``Predictor(spatial=True)`` over a ``(1, 2)``
    mesh predicts what the plain predictor does (its parity with the JAX
    package: ``tests/test_torch_spatial.py``)."""
    m = pmesh.make_mesh(n_model=2, devices=["cpu"] * 2)
    assert m.shape == {"data": 1, "model": 2} and m.model_group is None
    assert pmesh.auto_mesh(4, n_model=2, devices=["cpu"] * 4).shape == {
        "data": 2, "model": 2}
    with pytest.raises(ValueError, match="model axis of 2"):
        pmesh.make_mesh(n_data=2, n_model=2, devices=["cpu"] * 3)
    cfg = Config(**COMMON, device="cpu")
    model, _ = create_train_state(cfg)
    assert pmesh.auto_mesh_spatial(1, devices=["cpu"] * 2).shape == m.shape
    with pytest.raises(ValueError, match="over processes"):
        pmesh.shard_batch_spatial({}, m)
    with pytest.raises(FileNotFoundError):
        train(False, cfg, str(tmp_path), str(tmp_path), spatial=True)
    x = np.random.RandomState(0).rand(1, 64, 64, 3).astype(np.float32)
    rows = Predictor(cfg, model, batch_sizes=(1,), mesh=m, spatial=True)
    assert rows.spatial
    assert not Predictor(cfg, model, spatial=True).spatial   # no mesh
    got, want = rows(x), Predictor(cfg, model, batch_sizes=(1,))(x)
    np.testing.assert_array_equal(got["valid"], want["valid"])
    np.testing.assert_array_equal(got["labels"], want["labels"])
    np.testing.assert_allclose(got["boxes"], want["boxes"], rtol=1e-4,
                               atol=1e-3)


def test_meshes_within_one_process():
    """Without ``torch.distributed`` a mesh spans devices of this process:
    the first ``n_data``; ``auto_mesh`` over them as the JAX package picks
    (none on one device); a train state needs a mesh over processes, and
    ``train()`` refuses one within a process."""
    m = pmesh.make_mesh(n_data=2, devices=["cpu"] * 3)
    assert m.shape == {"data": 2, "model": 1} and len(m.devices) == 2
    assert m.group is None and m.processes == 1 and m.data_index == 0
    with pytest.raises(ValueError, match="data axis of 4"):
        pmesh.make_mesh(n_data=4, devices=["cpu"] * 3)
    assert pmesh.auto_mesh(6, devices=["cpu"] * 4).shape["data"] == 3
    assert pmesh.auto_mesh(6, devices=["cpu"]) is None
    _, state = create_train_state(Config(**COMMON, device="cpu"))
    with pytest.raises(ValueError, match="over processes"):
        pmesh.place_train_state(state, m)
    with pytest.raises(ValueError, match="one process a device"):
        train(False, Config(**COMMON, device="cpu"), "nowhere", "nowhere",
              mesh=m)
    with pytest.raises(TypeError, match="Mesh"):
        train(False, Config(**COMMON, device="cpu"), "nowhere", "nowhere",
              mesh=object())


# ------------------------------------------------------------ serving
@pytest.fixture(scope="module")
def flagship():
    """The flagship at 64x64 (``tests/test_torch_serving.py``'s config) in
    both packages, with the same seeded variables."""
    _, v = jax_model()
    return v, Predictor.from_jax_variables(Config(**KW, device="cpu"),
                                           v["params"], v["batch_stats"],
                                           batch_sizes=(1,))


def test_predictor_over_a_mesh_of_two_replicas(flagship):
    """Buckets (1, 2, 4) over a mesh of 2 CPU replicas: bucket 4 runs its
    rows 2 + 2 and bucket 2 runs 1 + 1 over the replicas, bucket 1 runs on
    the first replica.  Each request equals, bit for bit, the meshless
    ``Predictor`` run on the same blocks (buckets of 2, of 1, of 1: the
    CPU's convolutions are not the same bits at every batch size); and a
    2-image request equals the JAX ``Predictor`` under a ``(data=2)`` mesh
    within the box tolerance."""
    v, pred = flagship
    mesh = pmesh.make_mesh(devices=["cpu", "cpu"])
    port = Predictor(pred.cfg, pred.model, batch_sizes=(1, 2, 4), mesh=mesh)
    # both devices are the CPU, where the model already lies: one copy
    assert port.replicas == [pred.model, pred.model]
    x = np.random.RandomState(7).rand(4, 64, 64, 3).astype(np.float32)
    for n, block in ((4, 2), (2, 1), (1, 1)):
        assert port._plan(n) == (n,)
        got = port(x[:n])
        want = Predictor(pred.cfg, pred.model, batch_sizes=(block,))(x[:n])
        for k in FIELDS:
            np.testing.assert_array_equal(got[k], want[k], err_msg=(n, k))
    jpred = jserving.Predictor(JConfig(**KW), v["params"], v["batch_stats"],
                               batch_sizes=(2,),
                               mesh=jmesh.make_mesh(n_data=2))
    assert_matches_jax(port(x[:2]), jpred(x[:2]))
    with pytest.raises(TypeError, match="Mesh"):
        Predictor(pred.cfg, pred.model, mesh=object())


# ------------------------------------------------------------ dryrun
def test_dryrun_two_ranks_exits_zero():
    """``python -m ...parallel.dryrun 2``: a data-parallel train step, a
    resident macro step and a predict in 2 gloo ranks, then the spatial
    section on a ``(1, 2)`` mesh (a train step and a predict on each
    rank's rows), each section's seconds printed."""
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run(
        [sys.executable, "-m",
         "two_stage_object_detection_tpu_torch.parallel.dryrun", "2"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    for section in ("dp", "resident", "predict", "spatial"):
        assert f"[dryrun timing] {section}:" in res.stdout, res.stdout
    assert ("dryrun spatial: ranks=2 mesh={'data': 1, 'model': 2} loss="
            in res.stdout), res.stdout
    assert "left out" not in res.stdout


# ------------------------------------------------------------ profiling
def test_profiling_trace_and_hooks(tmp_path):
    """``trace`` writes a non-empty Chrome trace holding an ``annotate``
    region; ``device_memory_stats`` has no statistics on the CPU;
    ``enable_nan_checks`` toggles autograd's anomaly mode."""
    with profiling.trace(str(tmp_path)) as prof:
        with profiling.annotate("matmul_region"):
            torch.ones(32, 32) @ torch.ones(32, 32)
    path = tmp_path / "trace.json"
    assert path.stat().st_size > 0
    assert "matmul_region" in path.read_text()
    assert any(e.key == "matmul_region" for e in prof.key_averages())
    assert profiling.device_memory_stats() == {"cpu": None}
    profiling.enable_nan_checks(True)
    try:
        assert torch.is_anomaly_enabled()
    finally:
        profiling.enable_nan_checks(False)
    assert not torch.is_anomaly_enabled()
