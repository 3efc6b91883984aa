"""PyTorch port, training with image rows over the model axis (spatial), on
the CPU in gloo ranks (``tests/torch_dp_workers.py``):

* one ``train_step`` of both ported detectors at 64x64 with image rows over
  a model axis of 2 ranks, each rank's backbone and neck on half of each
  image's rows, against the JAX package's ``value_and_grad`` of
  ``train_forward`` on one device, with ``tests/test_torch_train.py``'s
  settled weights and batch (``Pair``; the JAX single-scale side
  interprets its Pallas kernels): the flagship on a ``(1, 2)`` mesh, the
  single-scale model on a ``(2, 2)`` mesh of 4 ranks, the data and the
  spatial axis together (one program on one device is the JAX mesh step's
  semantics: batch norm over the global batch, its gradient);
* ``train(spatial=True)`` over 2 ranks: an epoch preempted mid-cycle and
  resumed, bit for bit the uninterrupted run and the ranks equal, through
  the CLI's ``train --spatial`` too.
"""

import os

import jax
import numpy as np
import pytest
import torch
from flax.core import unfreeze

from tests import torch_dp_workers as workers
from tests.test_torch_drivers import TINY
from tests.test_torch_train import MODELS, Pair, _leaves
from two_stage_object_detection_tpu_torch.data.synthetic import (
    generate_synthetic_coco)
from two_stage_object_detection_tpu_torch.nets.detector import FasterRCNN
from two_stage_object_detection_tpu_torch.utils.jax_weights import (
    to_jax_variables)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name,n_data", [("flagship", 1),
                                         ("single_scale", 2)])
def test_spatial_step_matches_jax_value_and_grad(name, n_data, tmp_path):
    """The flagship on a ``(1, 2)`` mesh, the single-scale model on
    ``(2, 2)`` (one image a data index): the ranks' loss (for each model
    index, the mean over the data indices) within ``rtol=3e-4`` of JAX's
    (the JAX package's own spatial test's tolerance; measured: 8.0e-6 and
    1.2e-6), the gradient the update consumes (summed over the mesh) leaf
    by leaf within 1e-3 of the leaf's largest magnitude plus 1e-5 of the
    model's (``test_torch_train.py``'s tolerance; measured worst: 38% and
    5% of it), every rank's parameters and statistics bit for bit the same
    after the update, and halos exchanged and rows gathered on the way."""
    pair = Pair(name)
    cfg_kw = dict(MODELS[name], grad_accum_steps=1)
    sd = {k: v.clone() for k, v in pair.port_model().state_dict().items()}
    n_model = 2
    ranks = workers.spawn(workers.spatial_step_rank, n_data * n_model,
                          str(tmp_path), cfg_kw, sd, [pair.batch], n_model)
    assert [r["index"] for r in ranks] == [
        (d, m) for d in range(n_data) for m in range(n_model)]
    for r in ranks[1:]:
        for k, v in ranks[0]["state"].items():
            assert torch.equal(v, r["state"][k]), k
    assert ranks[0]["stats"]["halo"][0] > 0
    assert ranks[0]["stats"]["gather"][0] == 1

    (_, (_, j_losses)), j_grads = pair.jax_step(pair.params, pair.stats,
                                                pair.batch)
    for m in range(n_model):
        got = np.mean([ranks[d * n_model + m]["losses"][0]["total"]
                       for d in range(n_data)])
        np.testing.assert_allclose(got, float(j_losses["total"]), rtol=3e-4)
    port = FasterRCNN(pair.cfg, device="cpu")
    port.load_state_dict(sd)
    for n, p in port.named_parameters():
        p.grad = ranks[0]["grads"][n]
    got = dict(_leaves(to_jax_variables(port, grads=True)[0]))
    want = dict(_leaves(jax.tree.map(np.asarray, unfreeze(j_grads))))
    assert set(got) == set(want)
    top = max(np.abs(w).max() for w in want.values())
    for leaf, w in want.items():
        tol = 1e-3 * np.abs(w).max() + 1e-5 * top
        np.testing.assert_allclose(got[leaf], w, rtol=0, atol=tol,
                                   err_msg=leaf)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """``train(spatial=True)`` in 2 ranks at a batch of 1 (auto: a
    ``(1, 2)`` mesh, each rank half of each image's rows): uninterrupted,
    preempted before micro-step 2 of 8 (mid accumulation cycle, asked by
    rank 1 only) and resumed, on the streaming loader; uninterrupted over
    the dataset held on the device with the augmentation on the device;
    then the CLI's ``train --spatial`` with the first run's settings, and
    ``evaluate_checkpoint`` with and without ``spatial``."""
    root = str(tmp_path_factory.mktemp("coco"))
    generate_synthetic_coco(root, split="train2017", num_images=4,
                            num_classes=3, image_size=(64, 64), seed=0)
    generate_synthetic_coco(root, split="val2017", num_images=2,
                            num_classes=3, image_size=(64, 64), seed=1)
    kw = dict(TINY, batch_size=1)
    whole = str(tmp_path_factory.mktemp("w_whole"))
    part = str(tmp_path_factory.mktemp("w_part"))
    runs = [("whole", whole, {}), ("stopped", part, {"stop_at": 2}),
            ("resumed", part, {"resume": True}),
            ("cache", str(tmp_path_factory.mktemp("w_cache")),
             {"cfg": {"cache_device": True, "device_augment": True}})]
    cli_dir = str(tmp_path_factory.mktemp("w_cli"))
    cli = ["train", "--spatial", "--data-root", root, "--weights", cli_dir,
           "--seed", "3", "--eval-period", "2", "--no-viz",
           "--set", "device=cpu",
           *[f"{k}={','.join(map(str, v)) if isinstance(v, tuple) else v}"
             for k, v in kw.items()]]
    ranks = workers.spawn(workers.spatial_train_rank, 2,
                          str(tmp_path_factory.mktemp("ranks")), kw, root,
                          runs, cli, timeout=600)
    return ranks, cli_dir


def _equal(a, b):
    return set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a)


def test_spatial_train_resumes_exactly_and_ranks_agree(trained):
    """Two epochs of 4 micro-steps (two updates an epoch) on a ``(1, 2)``
    mesh: both ranks end with the same parameters, statistics and
    optimiser state, bit for bit, on both loaders; ``_best`` and ``_last``
    are written; the preempted run stopped both ranks at micro-step 1 and
    its resumption (each rank's half-cycle gradient restored) equals the
    uninterrupted run bit for bit; the CLI's ``train --spatial`` wrote the
    uninterrupted run's parameters."""
    (r0, r1), cli_dir = trained
    whole = r0["whole"]
    assert (whole["step"], whole["updates"]) == (8, 4)
    assert whole["axis"] == (2, 0) and r1["whole"]["axis"] == (2, 1)
    assert whole["dirs"] == ["FasterRCNNTrainer_best",
                             "FasterRCNNTrainer_last", "train_meta.json"]
    for name in ("whole", "cache", "resumed"):
        assert _equal(r0[name]["state"], r1[name]["state"]), name
        assert all(_equal(a, b) for a, b in zip(r0[name]["opt"],
                                                r1[name]["opt"])), name
    assert (r0["stopped"]["step"], r0["stopped"]["updates"]) == (1, 0)
    assert (r0["resumed"]["step"], r0["resumed"]["updates"]) == (8, 4)
    assert _equal(r0["resumed"]["state"], whole["state"])
    assert not _equal(r0["cache"]["state"], whole["state"])
    assert r0["cli"] == r1["cli"] == 0
    saved = torch.load(os.path.join(cli_dir, "FasterRCNNTrainer_last",
                                    "state.pt"), weights_only=True)
    assert _equal(saved["model"], whole["state"])


def test_evaluate_checkpoint_over_a_spatial_mesh(trained):
    """``evaluate_checkpoint(spatial=True)`` scores what the data-parallel
    evaluation scores: the loss within 1e-4, the mAPs equal."""
    (r0, r1), _ = trained
    for r in (r0, r1):
        sp, dp = r["sweeps"][True], r["sweeps"][False]
        np.testing.assert_allclose(sp["eval_loss"], dp["eval_loss"],
                                   rtol=1e-4)
        for k in ("mAP50", "mAP95", "mAP50_95"):
            assert sp[k] == dp[k], k
    assert r0["sweeps"] == r1["sweeps"]
