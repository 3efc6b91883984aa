"""PyTorch port, the drivers over a data mesh of 2 gloo ranks on the CPU:
``train()`` on a synthetic COCO root (the ranks end bitwise equal, one
``_last`` and one ``_best``, a run preempted mid-cycle by one rank and then
resumed bitwise equal to an uninterrupted one, the same over the dataset
held on the device, and each rank's shard of an epoch that of the
streaming ``Loader(shard_count=2, shard_index=r)``), and the evaluator
(``collect_predictions``, ``evaluate``, ``max_batches``) against the
one-process eval and the JAX package's.
"""

import numpy as np
import pytest
import torch

from tests import torch_dp_workers as workers
from tests.test_torch_drivers import TINY
from two_stage_object_detection_tpu.eval import evaluator as jevaluator
from two_stage_object_detection_tpu_torch.config import Config
from two_stage_object_detection_tpu_torch.data.synthetic import (
    generate_synthetic_coco)
from two_stage_object_detection_tpu_torch.eval.evaluator import (
    collect_predictions, evaluate)
from two_stage_object_detection_tpu_torch.nets.trainer import (
    create_train_state)

CACHE = {"cache_device": True, "device_augment": True}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """Six ``train()`` runs in each of 2 ranks: uninterrupted, preempted
    before micro-step 2 of 4 (mid accumulation cycle, asked by rank 1
    only) and resumed, on the streaming loader and on the cache."""
    root = str(tmp_path_factory.mktemp("coco"))
    generate_synthetic_coco(root, split="train2017", num_images=8,
                            num_classes=3, image_size=(64, 64), seed=0)
    generate_synthetic_coco(root, split="val2017", num_images=4,
                            num_classes=3, image_size=(64, 64), seed=1)
    runs = []
    for label, cfg in (("stream", {}), ("cache", CACHE)):
        for name, opts in (("whole", {}), ("stopped", {"stop_at": 2}),
                           ("resumed", {"resume": True})):
            weights = str(tmp_path_factory.mktemp(f"w_{label}_{name}"))
            if name == "resumed":
                weights = runs[-1][1]
            runs.append((f"{label}/{name}", weights, dict(opts, cfg=cfg)))
    return workers.spawn(workers.train_rank, 2,
                         str(tmp_path_factory.mktemp("ranks")), TINY, root,
                         runs, timeout=600)


def _equal(a, b):
    return set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("loader", ["stream", "cache"])
def test_train_over_two_ranks(trained, loader):
    """Two epochs of 2 micro-steps a rank (one update an epoch): both ranks
    end with the same parameters, statistics and optimiser state, bit for
    bit; ``_best`` and ``_last`` are written once each, and the sidecar is
    the same on both; the preempted run stopped both ranks at micro-step 1
    and its resumption equals the uninterrupted run bit for bit."""
    r0, r1 = trained
    whole = r0[f"{loader}/whole"]
    assert (whole["step"], whole["updates"]) == (4, 2)
    assert _equal(whole["state"], r1[f"{loader}/whole"]["state"])
    assert all(_equal(a, b) for a, b in zip(whole["opt"],
                                            r1[f"{loader}/whole"]["opt"]))
    assert whole["dirs"] == ["FasterRCNNTrainer_best",
                             "FasterRCNNTrainer_last", "train_meta.json"]
    assert whole["meta"] == r1[f"{loader}/whole"]["meta"]
    assert np.isfinite(whole["meta"]["min_eval_loss"])
    for r in (r0, r1):
        stopped = r[f"{loader}/stopped"]
        assert (stopped["step"], stopped["updates"]) == (1, 0)
        resumed = r[f"{loader}/resumed"]
        assert (resumed["step"], resumed["updates"]) == (4, 2)
        assert _equal(resumed["state"], whole["state"])
        assert all(_equal(a, b) for a, b in zip(resumed["opt"],
                                                whole["opt"]))
        assert resumed["meta"] == whole["meta"]
    assert not _equal(whole["state"], r0[f"{loader}/stopped"]["state"])


@pytest.mark.parametrize("loader", ["stream", "cache"])
def test_each_rank_trains_on_its_loader_shard(trained, loader):
    """What ``build_loaders`` gives rank r in an epoch (the streaming
    loader, or the rows the cache gathers) equals ``Loader(shard_count=2,
    shard_index=r)``'s images; the ranks' shards are disjoint; the eval
    loader is not sharded (2 batches of 2 on every rank)."""
    shards = [r["shards"][loader] for r in trained]
    for s in shards:
        assert s["len"] == len(s["got"]) == len(s["want"]) == 2
        assert s["eval_batches"] == 2
        for got, want in zip(s["got"], s["want"]):
            np.testing.assert_array_equal(got, want)
    a = np.concatenate(shards[0]["got"]).reshape(4, -1)
    b = np.concatenate(shards[1]["got"]).reshape(4, -1)
    assert not any((x == y).all() for x in a for y in b)


@pytest.fixture(scope="module")
def evaluated(tmp_path_factory):
    """Seeded weights, 2 eval batches of 4 images, and what 2 ranks
    return from ``collect_predictions`` / ``evaluate`` on them."""
    cfg = Config(**{**TINY, "batch_size": 4}, device="cpu")
    model, _ = create_train_state(cfg, seed=5)
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    rng = np.random.RandomState(9)
    from tests.test_torch_train import _batch
    batches = [_batch(rng, b=4) for _ in range(2)]
    res = workers.spawn(workers.eval_rank, 2,
                        str(tmp_path_factory.mktemp("eval")),
                        {**TINY, "batch_size": 4}, sd, batches, {})
    return cfg, model, batches, res


def _same_predictions(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        for u, v in zip(x, y):
            np.testing.assert_array_equal(u, v)


@pytest.mark.parametrize("use_predict", [False, True])
def test_eval_over_two_ranks_equals_one_process(evaluated, use_predict):
    """Each batch of 4 split 2 + 2 over the ranks, the predictions
    gathered: on both ranks ``collect_predictions`` equals the one-process
    pass over the same blocks of 2 bit for bit (predictions and GT; the
    CPU's convolutions are not the same bits at every batch size), and so
    does the mAP; the eval loss (the mean of the ranks' means) within 1e-6
    of it; the ranks' results equal each other bit for bit."""
    cfg, model, batches, res = evaluated
    _, state = create_train_state(cfg)
    state.model.load_state_dict(model.state_dict())
    blocks = [{k: v[i:i + 2] for k, v in b.items()}
              for b in batches for i in (0, 2)]
    preds, gts, loss = collect_predictions(state, blocks, cfg,
                                           use_predict=use_predict)
    want_loss, want_map, _ = evaluate(state, blocks, cfg,
                                      use_predict=use_predict)
    for r in res:
        got = r[use_predict]
        _same_predictions(got["collect"][0], preds)
        _same_predictions(got["collect"][1], gts)
        np.testing.assert_allclose(got["collect"][2], loss, rtol=1e-6,
                                   atol=1e-7)
        assert got["evaluate"][1] == want_map
    a, b = res[0][use_predict], res[1][use_predict]
    _same_predictions(a["collect"][0], b["collect"][0])
    assert a["collect"][2] == b["collect"][2]
    assert a["evaluate"][:2] == b["evaluate"][:2]


def test_max_batches_as_jax(evaluated, monkeypatch):
    """``max_batches`` stops the pass after that many batches, as the JAX
    package's ``collect_predictions`` does: the predictions of the first
    ``n`` batches, and the same ground truth as the JAX pass (whose predict
    is stubbed here: this holds the loop, not the model); ``evaluate``
    takes it too."""
    cfg, model, batches, _ = evaluated
    _, state = create_train_state(cfg)
    state.model.load_state_dict(model.state_dict())

    def stub_predict(_, images):
        n = images.shape[0]
        return (np.zeros((n, 2, 4), np.float32), np.zeros((n, 2), np.float32),
                np.ones((n, 2), np.int32), np.zeros((n, 2), bool))

    monkeypatch.setattr(jevaluator, "predict_step", stub_predict)
    for n in (1, 2):
        preds, gts, _ = collect_predictions(state, batches, cfg,
                                            use_predict=True, max_batches=n)
        _same_predictions(preds, collect_predictions(
            state, batches[:n], cfg, use_predict=True)[0])
        _, jgts, _ = jevaluator.collect_predictions(
            None, batches, cfg, use_predict=True, max_batches=n)
        assert len(gts) == 4 * n
        _same_predictions(gts, jgts)
    assert evaluate(state, batches, cfg, max_batches=1)[0] == \
        collect_predictions(state, batches[:1], cfg)[2]
