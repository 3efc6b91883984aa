"""PyTorch port, training quality on the CPU: ``scripts/torch_quality.py``.

* Each recipe of the script (the JAX package's ``overfit_check.py``,
  ``overfit_resident.py`` and ``ablate_real_fixture.py`` recipes) builds
  the same ``Config`` in both packages, field by field, ``device`` apart.
* The port trains a tiny detector: the ``overfit`` recipe cut to 64x64
  (``torch_quality.TINY``: 4 synthetic images, ResNet-10, float32) for
  ``TINY_STEPS`` steps reaches true-inference mAP@0.5 > 0.3, the JAX
  script's bar.  Measured: 0.931 at 60 steps (0.497 at 40, 0.550 at 80,
  0.933 at 100; the cosine schedule spans the run), so 60 steps keep a
  wide margin; the loss falls from ~3.4 to under 0.4.
* Train here, evaluate there: those weights, through
  ``to_jax_variables``, score the same mAP in the JAX package's
  ``evaluate(use_predict=True)`` on the same images, with its predictions'
  ``valid`` and ``labels`` equal to the port's and scores and boxes within
  the predict tolerance of ``tests/test_torch_detector.py``.
* Each subcommand runs ``--device cpu --tiny`` for 2 steps (the resident
  one for its least, one cycle of 8 micro-steps) and writes its JSON.
"""

import dataclasses
import importlib.util
import json
import os

import jax
import numpy as np
import pytest
import torch

from two_stage_object_detection_tpu.config import Config as JConfig
from two_stage_object_detection_tpu.eval import evaluator as j_evaluator
from two_stage_object_detection_tpu.nets.trainer import (
    create_train_state as j_create_train_state, predict_step as j_predict)
from two_stage_object_detection_tpu_torch.config import MASK_FIELDS, Config
from two_stage_object_detection_tpu_torch.nets.trainer import predict_step
from two_stage_object_detection_tpu_torch.utils.jax_weights import (
    to_jax_variables)

_PATH = os.path.join(os.path.dirname(os.path.dirname(__file__)), "scripts",
                     "torch_quality.py")
_spec = importlib.util.spec_from_file_location("torch_quality", _PATH)
tq = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(tq)

TINY_STEPS = 60


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several test processes on one CPU; torch's own thread
    pool in each would oversubscribe it many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", list(tq.recipes()))
def test_recipe_builds_the_same_config_in_both_packages(name):
    recipe = tq.recipes()[name]
    got = dataclasses.asdict(Config(**recipe))
    want = dataclasses.asdict(JConfig(**recipe))
    assert (got.pop("device"), want.pop("device")) == ("cuda", "tpu")
    assert not got["mask_head"]
    for name in MASK_FIELDS:
        del got[name]
    assert got == want
    assert tq.make_config(recipe, "cpu").device == "cpu"


@pytest.fixture(scope="module")
def trained():
    """The tiny ``overfit`` run on the CPU: its numbers, state and batch."""
    out = tq.run("overfit", TINY_STEPS, device="cpu", tiny=True,
                 log=lambda *a: None, backbone="resnet10")
    assert out["recipe"] == tq.overfit_recipe(TINY_STEPS, "resnet10")
    return out["recipe"], out


def test_tiny_detector_trains_on_the_cpu(trained):
    _, out = trained
    assert out["all_finite"] and out["loss_fell"]
    assert out["final_loss"] < 0.5 * out["first_loss"], out["losses"]
    assert out["map50"] > tq.MAP_BAR, out
    assert out["bar"] == tq.MAP_BAR and out["failures"] == []


def test_jax_evaluator_scores_the_ports_weights_alike(trained):
    """The JAX single scale runs ``pallas="on"`` (its whole-table proposal
    kernel, interpreted): the route the port takes."""
    recipe, out = trained
    state, batch = out["state"], out["batch"]
    jcfg = JConfig(**{**recipe, **tq.TINY}, pallas="on")
    _, jstate = j_create_train_state(jcfg, jax.random.PRNGKey(0),
                                     init_image_size=(64, 64))
    params, stats = to_jax_variables(state.model)
    jstate = jstate.replace(params=params, batch_stats=stats)
    host = {k: v.numpy() for k, v in batch.items()}
    _, j_map, _ = j_evaluator.evaluate(jstate, [host], jcfg,
                                       map_iou_threshold=0.5,
                                       use_predict=True)
    assert abs(j_map - out["map50"]) <= 1e-6, (j_map, out["map50"])
    wb, ws, wl, wv = (np.asarray(a) for a in j_predict(jstate, host["image"]))
    gb, gs, gl, gv = (t.numpy() for t in predict_step(state, host["image"]))
    assert gv.sum() == out["detections"] > 0
    np.testing.assert_array_equal(gv, wv)
    np.testing.assert_array_equal(gl, wl)
    np.testing.assert_allclose(gs, ws, rtol=0, atol=1e-4)
    np.testing.assert_allclose(gb, wb, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("argv", [
    ["overfit", "--steps", "2"],
    ["overfit-resident", "--cycles", "1"],
    ["real", "--steps", "2"]], ids=["overfit", "overfit-resident", "real"])
def test_subcommand_runs_tiny_and_writes_its_json(argv, tmp_path, capsys):
    path = str(tmp_path / "out.json")
    rc = tq.main([*argv, "--device", "cpu", "--tiny", "--json", path])
    with open(path) as f:
        res = json.load(f)
    assert rc == (1 if res["failures"] else 0)
    assert res["command"] == argv[0] and res["tiny"]
    names = {"overfit": ["overfit hardnet39"],
             "overfit-resident": ["overfit-resident hardnet39s"],
             "real": [f"real {v}" for v in tq.REAL_VARIANTS]}[argv[0]]
    assert list(res["runs"]) == names
    for run in res["runs"].values():
        assert run["all_finite"] and 0.0 <= run["map50"] <= 1.0
        assert len(run["losses"]) == (1 if argv[0] == "overfit-resident"
                                      else 2)
    if argv[0] == "real":
        for v in ("fpn", "fpn_locnorm"):
            cov = res["runs"][f"real {v}"]["window_coverage"]
            assert 0 <= cov["covered"] <= cov["proposals"] > 0
    if argv[0] == "overfit-resident":
        run = res["runs"][names[0]]
        assert run["micro_steps"] == tq.K and run["cycle_totals"] == tq.K
        assert run["cache_device"] == "cpu"
    assert "wrote" in capsys.readouterr().out
