"""PyTorch port, the model axis of ``parallel/`` (tensor-parallel dense
heads over gloo ranks on the CPU, ``tests/torch_dp_workers.py``):

* a ``(2, 2)`` train step of the flagship (64x64,
  ``tests/test_torch_train.py``'s config, one update a micro-step, a global
  batch of 4) against the JAX package's ``train_step`` body under its own
  ``make_mesh(n_data=2, n_model=2)`` with ``place_train_state`` (the
  tensor-parallel rules) on the conftest's 8 fake CPU devices, at
  ``tests/test_torch_parallel_step.py``'s tolerance, the update held as
  that file holds it (against the JAX optimiser driven with the port's
  gathered gradient; its docstring says why);
* the checkpoint that step's ranks save: the full layout, loading into one
  process; and one process's checkpoint, written mid-cycle, through a
  ``(1, 2)`` mesh and back, bit for bit;
* ``train()`` on a ``(2, 2)`` mesh, preempted and resumed, bit for bit the
  uninterrupted run;
* ``parallel.dryrun 4``: its ``dp+tp`` and ``fpn`` sections on ``(2, 2)``;
* the cross-replica batch norm's combine (``models/layers.py``) against
  float64.
"""

import os
import subprocess
import sys

import jax
import numpy as np
import optax
import pytest
import torch
from flax.core import unfreeze

from tests import torch_dp_workers as workers
from tests.test_torch_drivers import TINY
from tests.test_torch_parallel_step import STEPS_PER_EPOCH, _jax_grads
from tests.test_torch_train import MODELS, Pair, _batch, _leaves, _settle
from two_stage_object_detection_tpu.nets.trainer import (
    TrainState as JTrainState, make_optimizer as j_make_optimizer)
from two_stage_object_detection_tpu.parallel import mesh as jmesh
from two_stage_object_detection_tpu_torch.config import Config
from two_stage_object_detection_tpu_torch.data.synthetic import (
    generate_synthetic_coco)
from two_stage_object_detection_tpu_torch.nets.detector import FasterRCNN
from two_stage_object_detection_tpu_torch.nets.trainer import (
    create_train_state, train_step)
from two_stage_object_detection_tpu_torch.utils import checkpoint
from two_stage_object_detection_tpu_torch.utils.jax_weights import (
    to_jax_variables)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPLIT = {"roi_head.fc1.weight", "roi_head.fc2.weight",
         "roi_head.cls_loc.weight", "roi_head.score.weight"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _equal(a, b):
    return set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a)


# ------------------------------------------------------------ the step
@pytest.fixture(scope="module")
def tp_step(tmp_path_factory):
    """One update of the flagship on a ``(2, 2)`` mesh of 4 gloo ranks, the
    ``_last`` checkpoint saved after it."""
    pair = Pair("flagship")
    cfg_kw = dict(MODELS["flagship"], grad_accum_steps=1)
    batch = _batch(np.random.RandomState(11), b=4)
    model = pair.port_model()
    least = _settle(model, torch.from_numpy(batch["image"]))
    assert least["kink"] >= 0.9e-3
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    tmp = tmp_path_factory.mktemp("tp")
    ranks = workers.spawn(workers.tp_step_rank, 4, str(tmp / "ranks"), cfg_kw,
                          sd, [batch], 2, str(tmp / "ckpt"))
    return pair, cfg_kw, batch, model, ranks, str(tmp / "ckpt")


def test_tp_step_matches_jax_mesh(tp_step):
    """Ranks ``d * 2 + m``: the heads' weights split over ``m`` exactly as
    the rules say; every rank holds the same gathered gradient and state
    bit for bit; the losses (the mean over the data axis) within 1e-5 of
    the JAX ``(2, 2)`` mesh step's; the gathered gradient, leaf by leaf,
    within 1e-3 of the leaf's largest magnitude plus 1e-5 of the model's;
    the running statistics within 1e-5; every parameter within 1e-5 +
    1e-5 |p| of the JAX optimiser's update from that gradient (at most one
    element in 10,000 of a leaf, or two, off by at most two steps of
    ``lr``)."""
    pair, cfg_kw, batch, model, ranks, _ = tp_step
    assert [r["index"] for r in ranks] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    for r in ranks:
        assert r["split"] == dict.fromkeys(SPLIT, 0)
        assert (r["step"], r["updates"]) == (1, 1)
        assert _equal(r["state"], ranks[0]["state"])
        assert _equal(r["grads"], ranks[0]["grads"])
    params, stats = to_jax_variables(model)

    jcfg = pair.jcfg.replace(grad_accum_steps=1)
    tx = j_make_optimizer(jcfg, STEPS_PER_EPOCH)
    mesh = jmesh.make_mesh(n_data=2, n_model=2)
    state = jmesh.place_train_state(
        JTrainState.create(apply_fn=pair.jm.apply, params=params,
                           batch_stats=stats, tx=tx), mesh)
    assert state.params["roi_head"]["fc1"]["kernel"].sharding.spec[1] == (
        "model")
    with mesh:
        grads, new_stats, losses = jax.jit(_jax_grads)(
            state, jmesh.shard_batch(batch, mesh))
    for k, v in losses.items():
        got = np.mean([ranks[0]["losses"][0][k], ranks[2]["losses"][0][k]])
        np.testing.assert_allclose(got, float(v), rtol=1e-5, atol=1e-5,
                                   err_msg=k)

    port = FasterRCNN(pair.cfg, device="cpu")
    port.load_state_dict(ranks[0]["state"])
    for n, p in port.named_parameters():
        p.grad = ranks[0]["grads"][n]
    got_g, _ = to_jax_variables(port, grads=True)
    want_g = dict(_leaves(jax.tree.map(np.asarray, unfreeze(grads))))
    top = max(np.abs(w).max() for w in want_g.values())
    for leaf, got in _leaves(got_g):
        tol = 1e-3 * np.abs(want_g[leaf]).max() + 1e-5 * top
        np.testing.assert_allclose(got, want_g[leaf], rtol=0, atol=tol,
                                   err_msg=leaf)
    got_p, got_s = to_jax_variables(port)
    want_s = dict(_leaves(jax.tree.map(np.asarray, unfreeze(new_stats))))
    for leaf, got in _leaves(got_s):
        np.testing.assert_allclose(got, want_s[leaf], rtol=1e-4, atol=1e-5,
                                   err_msg=leaf)
    updates, _ = tx.update(jax.tree.map(np.asarray, got_g),
                           tx.init(params), params)
    want_p = dict(_leaves(jax.tree.map(
        np.asarray, optax.apply_updates(params, updates))))
    for leaf, got in _leaves(got_p):
        want = want_p[leaf]
        diff = np.abs(got - want)
        off = diff > 1e-5 + 1e-5 * np.abs(want)
        assert off.sum() <= max(2, 1e-4 * off.size), (leaf, off.sum())
        assert diff.max() <= 2.1 * pair.cfg.lr, (leaf, diff.max())


def test_tp_checkpoint_loads_into_one_process(tp_step, tmp_path):
    """The ranks' ``_last`` holds the full layout: the one-process model's
    keys and shapes, the gathered parameters bit for bit, and each split
    weight's AdamW moments the two model ranks' slices concatenated; it
    restores into one process, whose predict equals, bit for bit, that of
    a model holding the gathered parameters."""
    pair, cfg_kw, _, _, ranks, ckpt = tp_step
    payload = torch.load(os.path.join(ckpt, checkpoint.LAST,
                                      checkpoint.STATE_FILE),
                         weights_only=True)
    cfg = Config(**cfg_kw, device="cpu")
    model, state = create_train_state(cfg)
    want = model.state_dict()
    assert {k: v.shape for k, v in payload["model"].items()} == {
        k: v.shape for k, v in want.items()}
    assert _equal(payload["model"], ranks[0]["state"])
    names = [n for n, _ in model.named_parameters()]
    for i, st in payload["optimizer"]["state"].items():
        name = names[i]
        for key in ("exp_avg", "exp_avg_sq"):
            assert st[key].shape == want[name].shape, (name, key)
            if name in SPLIT:
                local = [r["opt"]["state"][i][key] for r in ranks[:2]]
                assert local[0].shape[0] * 2 == st[key].shape[0]
                assert torch.equal(st[key], torch.cat(local)), name
            else:
                assert torch.equal(st[key], ranks[1]["opt"]["state"][i][key])
    assert checkpoint.restore_checkpoint(ckpt, state, checkpoint.LAST)
    assert (state.step, state.updates) == (1, 1)
    direct = FasterRCNN(cfg, device="cpu")
    direct.load_state_dict(ranks[0]["state"])
    x = torch.from_numpy(_batch(np.random.RandomState(5), b=2)["image"])
    for a, b in zip(model.predict(x), direct.predict(x)):
        assert torch.equal(a, b)


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """One process's ``_last`` of the single scale, mid-cycle (3
    micro-steps, ``grad_accum_steps=2``: AdamW moments and an open
    cycle's gradients), and 2 ranks that take the batch norm's moments of
    ``MOMENTS_X`` and restore it on a ``(1, 2)`` mesh."""
    kw = MODELS["single_scale"]
    _, state = create_train_state(Config(**kw, device="cpu"), seed=3)
    rng = np.random.RandomState(8)
    for _ in range(3):
        train_step(state, _batch(rng, b=2))
    tmp = tmp_path_factory.mktemp("two")
    ckpt = str(tmp / "ckpt")
    checkpoint.save_checkpoint(ckpt, state, checkpoint.LAST)
    return ckpt, workers.spawn(workers.moments_and_restore_rank, 2,
                               str(tmp / "ranks"), MOMENTS_X, kw, ckpt)


def test_one_process_checkpoint_through_a_model_axis(two_ranks):
    """One process's mid-cycle checkpoint restored on a ``(1, 2)`` mesh:
    the ranks hold halves of the split heads, and gathered they hold the
    checkpoint's parameters, moments and counters bit for bit; saved back
    from the mesh, the file equals the original, the open cycle
    included."""
    ckpt, (r0, r1) = two_ranks
    load = lambda d: torch.load(os.path.join(d, checkpoint.LAST,
                                             checkpoint.STATE_FILE),
                                weights_only=True)
    orig, back = load(ckpt), load(os.path.join(ckpt, "mesh"))
    for r in (r0, r1):
        held = r["held"]
        assert _equal(held["state"], orig["model"])
        assert (held["step"], held["updates"]) == (3, 1)
        for i, st in orig["optimizer"]["state"].items():
            assert _equal(held["opt"]["state"][i], st)
        for name in ("roi_head.cls_loc.weight", "roi_head.score.weight"):
            assert held["local_shapes"][name][0] * 2 == (
                orig["model"][name].shape[0])
    assert _equal(back["model"], orig["model"])
    assert _equal(back["accum"], orig["accum"]) and orig["accum"]
    assert (back["step"], back["updates"]) == (orig["step"], orig["updates"])
    for i, st in orig["optimizer"]["state"].items():
        assert _equal(back["optimizer"]["state"][i], st)


# ------------------------------------------------------------ batch norm
# a global batch of 4 images over 2 ranks, channels whose mean dwarfs their
# spread (1e3 +- 1e-2 .. 1) and whose ranks' means differ: the
# cancellation a sum of squares would suffer
_rng = np.random.RandomState(21)
MOMENTS_X = (1e3 * _rng.uniform(0.5, 1.5, (1, 6, 1, 1))
             + np.array([0.0, 0.0, 0.5, 0.5])[:, None, None, None]
             * _rng.uniform(0.0, 1.0, (1, 6, 1, 1))
             + _rng.randn(4, 6, 5, 5) * np.logspace(-2, 0, 6)[None, :, None,
                                                            None]
             ).astype(np.float32)


def test_cross_replica_moments_against_float64(two_ranks):
    """``_global_moments`` over 2 ranks of ``MOMENTS_X``: every rank's
    float32 statistics equal bit for bit, the count is the global batch's,
    the mean within 1e-7 of the float64 mean's magnitude and the biased
    variance within 1e-6 of the float64 variance (measured: 4.2e-8 and
    2.8e-8; the float32 combine it replaced read 2.3e-4 of the variance on
    these channels)."""
    _, ranks = two_ranks
    x = MOMENTS_X.astype(np.float64)
    mean = x.mean(axis=(0, 2, 3))
    var = ((x - mean[None, :, None, None]) ** 2).mean(axis=(0, 2, 3))
    for r in ranks:
        assert torch.equal(r["mean"], ranks[0]["mean"])
        assert torch.equal(r["var"], ranks[0]["var"])
        assert r["count"] == x.size // x.shape[1]
    got_m = ranks[0]["mean"].double().numpy()
    got_v = ranks[0]["var"].double().numpy()
    assert np.all(np.abs(got_m - mean) <= 1e-7 * np.abs(mean)), (
        np.abs(got_m - mean) / np.abs(mean))
    assert np.all(np.abs(got_v - var) <= 1e-6 * var), np.abs(got_v - var) / var


# ------------------------------------------------------------ train()
@pytest.fixture(scope="module")
def trained_tp(tmp_path_factory):
    """``train()`` on a ``(2, 2)`` mesh of 4 ranks: uninterrupted, and
    preempted before micro-step 2 of 4 (asked by rank 3 only) and
    resumed."""
    root = str(tmp_path_factory.mktemp("coco"))
    generate_synthetic_coco(root, split="train2017", num_images=8,
                            num_classes=3, image_size=(64, 64), seed=0)
    generate_synthetic_coco(root, split="val2017", num_images=4,
                            num_classes=3, image_size=(64, 64), seed=1)
    whole = str(tmp_path_factory.mktemp("w_whole"))
    part = str(tmp_path_factory.mktemp("w_part"))
    runs = [("whole", whole, {}), ("stopped", part, {"stop_at": 2}),
            ("resumed", part, {"resume": True})]
    return workers.spawn(workers.train_rank, 4,
                         str(tmp_path_factory.mktemp("ranks")), TINY, root,
                         runs, 2, timeout=600)


def test_train_on_a_model_axis_resumes_exactly(trained_tp):
    """Two epochs of 2 micro-steps a data index (one update an epoch):
    every rank ends with the same gathered parameters, statistics and
    optimiser state, bit for bit; ``_best`` and ``_last`` are written once
    each and the sidecar is the same everywhere; the preempted run stopped
    every rank at micro-step 1 and its resumption equals the uninterrupted
    run bit for bit."""
    whole = trained_tp[0]["whole"]
    assert (whole["step"], whole["updates"]) == (4, 2)
    assert whole["dirs"] == ["FasterRCNNTrainer_best",
                             "FasterRCNNTrainer_last", "train_meta.json"]
    assert np.isfinite(whole["meta"]["min_eval_loss"])
    for r in trained_tp:
        assert _equal(r["whole"]["state"], whole["state"])
        assert r["whole"]["meta"] == whole["meta"]
        assert (r["stopped"]["step"], r["stopped"]["updates"]) == (1, 0)
        resumed = r["resumed"]
        assert (resumed["step"], resumed["updates"]) == (4, 2)
        assert _equal(resumed["state"], whole["state"])
        assert all(_equal(a, b) for a, b in zip(resumed["opt"],
                                                whole["opt"]))
    assert not _equal(whole["state"], trained_tp[0]["stopped"]["state"])


# ------------------------------------------------------------ dryrun
def test_dryrun_four_ranks_runs_the_model_axis_sections():
    """``python -m ...parallel.dryrun 4``: the ``dp+tp`` and ``fpn``
    sections train on a ``(2, 2)`` mesh and print their seconds; the
    spatial section is named as left out."""
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run(
        [sys.executable, "-m",
         "two_stage_object_detection_tpu_torch.parallel.dryrun", "4"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    for section in ("dp+tp", "fpn"):
        assert (f"dryrun {section}: ranks=4 mesh={{'data': 2, 'model': 2}}"
                in res.stdout), res.stdout
        assert f"[dryrun timing] {section}:" in res.stdout
    assert "spatial section" in res.stdout and "left out" in res.stdout
