"""PyTorch port, ``parallel/sharding.py:infer_param_sharding`` against the
JAX package's, on the CPU: the rules on a table of layers (the port of
``tests/test_sharding.py::test_param_sharding_rules``), and the set of
split parameters on both ported models' real variable trees at model axes
of 2 and 3, the flagship at its 81 classes (``score [81, fc]`` divides by 3
and not by 2, ``cls_loc [324, fc]`` by both; the RPN's ``score`` is a conv
and stays whole).
"""

import jax
import jax.numpy as jnp
import pytest
import torch
import torch.nn as nn
from flax.core import unfreeze

from two_stage_object_detection_tpu.config import Config as JConfig
from two_stage_object_detection_tpu.nets.detector import FasterRCNN as JFasterRCNN
from two_stage_object_detection_tpu.parallel import mesh as jmesh
from two_stage_object_detection_tpu.parallel.sharding import (
    infer_param_sharding as j_infer)
from two_stage_object_detection_tpu_torch.config import Config
from two_stage_object_detection_tpu_torch.models.layers import Conv, Dense
from two_stage_object_detection_tpu_torch.nets.detector import FasterRCNN
from two_stage_object_detection_tpu_torch.parallel import mesh as pmesh
from two_stage_object_detection_tpu_torch.parallel.sharding import (
    infer_param_sharding)

SMALL = dict(input_size=(64, 64), compute_dtype="float32")
MODELS = {
    # 81 classes: the flagship's head widths over a narrow pyramid
    "flagship": dict(SMALL, fpn=True, backbone="resnet50", loc_normalize=True,
                     num_classes=80, fpn_channels=32, fpn_fc_dim=64),
    "single_scale": dict(SMALL, num_classes=3),
}


def test_param_sharding_rules():
    """On a ``(4, 2)`` mesh: a dense weight splits its output features
    (dim 0 of torch's ``[out, in]``), its bias and a conv stay whole, and
    a dense weight the axis does not divide stays whole; a model axis of 1
    splits nothing."""
    model = nn.Module()
    model.Dense_0 = Dense(64, 128)
    model.Conv_0 = Conv(16, 32, 3)
    model.odd = Dense(64, 127)
    sh = infer_param_sharding(model, pmesh.make_mesh(4, 2, ["cpu"] * 8))
    assert sh == {"Dense_0.weight": 0, "Dense_0.bias": None,
                  "Conv_0.weight": None, "Conv_0.bias": None,
                  "odd.weight": None, "odd.bias": None}
    one = infer_param_sharding(model, pmesh.make_mesh(8, 1, ["cpu"] * 8))
    assert set(one.values()) == {None}


def _jax_split(name, n_model):
    """The parameters the JAX rules split on model ``name``'s flax tree,
    under the port's names (``roi_head/fc1/kernel`` ->
    ``roi_head.fc1.weight``)."""
    jm = JFasterRCNN(JConfig(**MODELS[name]))
    shapes = unfreeze(jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                                     jnp.zeros((1, 64, 64, 3))))["params"]
    mesh = jmesh.make_mesh(n_data=8 // n_model // 2 or 1, n_model=n_model)
    specs = j_infer(shapes, mesh)
    out = set()

    def walk(tree, path):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, path + (k,))
            elif any(a is not None for a in v.spec):
                leaf = {"kernel": "weight"}.get(k, k)
                out.add(".".join(path + (leaf,)))
    walk(specs, ())
    return out


@pytest.mark.parametrize("name,n_model", [("flagship", 2), ("flagship", 3),
                                          ("single_scale", 2),
                                          ("single_scale", 3)])
def test_split_set_equals_jax_on_real_trees(name, n_model):
    """The port's split set equals the JAX rules' on the same model's real
    variable tree, each split weight along its output features (dim 0)."""
    model = FasterRCNN(Config(**MODELS[name], device="cpu"))
    sh = infer_param_sharding(
        model, pmesh.make_mesh(1, n_model, ["cpu"] * n_model))
    assert set(sh) == {n for n, _ in model.named_parameters()}
    got = {n for n, d in sh.items() if d is not None}
    assert set(sh[n] for n in got) <= {0}
    assert got == _jax_split(name, n_model)
    if name == "flagship":
        assert "rpn_head.score.weight" not in got
        assert ("roi_head.score.weight" in got) == (81 % n_model == 0)
        assert "roi_head.cls_loc.weight" in got
        assert ("roi_head.fc1.weight" in got) == (64 % n_model == 0)
    else:
        assert got == ({"roi_head.cls_loc.weight", "roi_head.score.weight"}
                       if n_model == 2 else set())
