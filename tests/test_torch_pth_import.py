"""PyTorch port, ``utils/torch_import.py`` (reference ``.pth`` checkpoints
in and out) and ``scripts/torch_convert_orbax.py``, against the JAX
package's ``utils/torch_import.py`` and ``utils/checkpoint.py`` on the CPU.

No file from outside the repository: every reference-layout dict is
written here, by the JAX package's ``export_state_dict`` (HarDNet) or from
torchvision's ResNet key layout with seeded values (ResNet), and the
variables are seeded numpy values on the shapes of the flax init
(``tests/test_torch_serving.py:fill``).  The port's loaders are held bit
for bit against the JAX conversion followed by ``load_jax_variables``.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.core import unfreeze

from tests.test_torch_serving import KW, assert_matches_jax, fill, jax_model
from two_stage_object_detection_tpu.config import Config as JConfig
from two_stage_object_detection_tpu.nets.detector import FasterRCNN as JFasterRCNN
from two_stage_object_detection_tpu.nets.trainer import TrainState as JTrainState
from two_stage_object_detection_tpu.utils import checkpoint as jckpt
from two_stage_object_detection_tpu.utils import torch_import as jimport
from two_stage_object_detection_tpu_torch.config import Config
from two_stage_object_detection_tpu_torch.nets.trainer import create_train_state
from two_stage_object_detection_tpu_torch.serving import Predictor
from two_stage_object_detection_tpu_torch.utils import torch_import as pimport
from two_stage_object_detection_tpu_torch.utils.jax_weights import (
    load_jax_variables)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(input_size=(64, 64), num_classes=3, compute_dtype="float32")
# the single-scale HarDNet-39 of Config(), the stride-16 ResNet-50 trunk
# (layer1..3) and the FPN flagship's pyramid trunk (layer1..4)
CONFIGS = {"hardnet39": dict(SMALL),
           "resnet50": dict(SMALL, backbone="resnet50"),
           "flagship": dict(KW)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def variables(name, seed=0):
    """Seeded flax variables of model ``name`` (shapes from
    ``eval_shape``, nothing compiled)."""
    jm = JFasterRCNN(JConfig(**CONFIGS[name]))
    shapes = unfreeze(jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                                     jnp.zeros((1, 64, 64, 3))))
    rng = np.random.RandomState(seed)
    return jm, fill(shapes["params"], rng), fill(shapes["batch_stats"], rng)


def port_model(name, params=None, stats=None, seed=5):
    model, state = create_train_state(Config(**CONFIGS[name], device="cpu"),
                                      seed=seed)
    if params is not None:
        load_jax_variables(model, params, stats)
    return model, state


def assert_same_state(a, b):
    sa, sb = a.state_dict(), b.state_dict()
    assert sorted(sa) == sorted(sb)
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k


# ------------------------------------------------------------ HarDNet
@pytest.fixture(scope="module")
def hardnet():
    _, params, stats = variables("hardnet39")
    return params, stats, jimport.export_state_dict(params, stats)


def test_hardnet_pth_loads_bitwise_as_jax_variables(hardnet, tmp_path):
    """JAX ``export_state_dict`` -> a ``.pth`` trainer checkpoint ->
    ``load_torch_checkpoint`` equals ``load_jax_variables`` of the same
    variables bit for bit, parameters and statistics, on a model of
    other seeded weights; ``convert_state_dict`` of a bare backbone dict
    (``base...``) fills the backbone alone."""
    params, stats, sd = hardnet
    want, _ = port_model("hardnet39", params, stats)
    path = tmp_path / "FasterRCNNTrainer_best.pth"
    torch.save({"model_state_dict": {k: torch.from_numpy(v)
                                     for k, v in sd.items()},
                "optimizer_state_dict": {}}, path)
    model, state = port_model("hardnet39")
    assert pimport.load_torch_checkpoint(str(path), state) is state
    assert_same_state(model, want)
    bare = {k.replace("feat_extra.", ""): v for k, v in sd.items()
            if k.startswith("feat_extra.")}
    got = pimport.convert_state_dict(bare)
    assert all(k.startswith("extractor.") for k in got)
    full = want.state_dict()
    assert len(got) == sum(k.startswith("extractor.") for k in full)
    for k, v in got.items():
        assert torch.equal(v, full[k]), k


def test_hardnet_export_equals_jax_export(hardnet):
    """The port's ``export_state_dict`` equals the JAX package's key for key
    and bit for bit (float32 CPU tensors)."""
    params, stats, want = hardnet
    model, _ = port_model("hardnet39", params, stats)
    got = pimport.export_state_dict(model)
    assert list(got) == list(want)
    for k, v in got.items():
        assert v.dtype == torch.float32 and v.device.type == "cpu"
        np.testing.assert_array_equal(v.numpy(), want[k], err_msg=k)


def test_hardnet_missing_key_and_wrong_shape_raise(hardnet):
    """A key the converter reads and the dict lacks raises ``KeyError``
    naming it; a shape the model does not have raises ``ValueError``
    naming its key; the model is left as it was."""
    _, _, sd = hardnet
    sd = {k: torch.from_numpy(v) for k, v in sd.items()}
    model, state = port_model("hardnet39")
    before = {k: v.clone() for k, v in model.state_dict().items()}
    key = "feat_extra.base.6.layers.2.layer1.norm.running_var"
    with pytest.raises(KeyError, match=key.replace(".", r"\.")):
        pimport.convert_state_dict({k: v for k, v in sd.items() if k != key})
    bad = dict(sd)
    bad["head.score.weight"] = torch.zeros(5, 512)
    with pytest.raises(ValueError, match=r"roi_head\.score\.weight"):
        pimport._load(state, pimport.convert_state_dict(bad))
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k


# ------------------------------------------------------------ ResNet
def torchvision_resnet50(rng, layers=(3, 4, 6, 3), prelu=False):
    """A torchvision ``resnet50`` state dict (its key layout, ``fc`` and
    ``num_batches_tracked`` included) of seeded values, first ``layers``
    stages; ``prelu`` adds the reference's per-block PReLU slopes."""
    sd = {}

    def bn(prefix, c):
        sd[f"{prefix}.weight"] = rng.uniform(0.5, 1.5, c)
        sd[f"{prefix}.bias"] = rng.randn(c) * 0.1
        sd[f"{prefix}.running_mean"] = rng.randn(c) * 0.1
        sd[f"{prefix}.running_var"] = rng.uniform(0.5, 1.5, c)
        sd[f"{prefix}.num_batches_tracked"] = np.array(7)

    def conv(key, o, i, k):
        sd[key] = rng.randn(o, i, k, k) / np.sqrt(i * k * k)

    conv("conv1.weight", 64, 3, 7)
    bn("bn1", 64)
    if prelu:
        sd["relu.weight"] = np.array([0.2])
    c_in = 64
    for li, n in enumerate(layers):
        w = 64 * 2 ** li
        for bi in range(n):
            p = f"layer{li + 1}.{bi}"
            conv(f"{p}.conv1.weight", w, c_in, 1)
            bn(f"{p}.bn1", w)
            conv(f"{p}.conv2.weight", w, w, 3)
            bn(f"{p}.bn2", w)
            conv(f"{p}.conv3.weight", 4 * w, w, 1)
            bn(f"{p}.bn3", 4 * w)
            if bi == 0:
                conv(f"{p}.downsample.0.weight", 4 * w, c_in, 1)
                bn(f"{p}.downsample.1", 4 * w)
            if prelu:
                sd[f"{p}.relu.weight"] = rng.uniform(0.1, 0.3, 1)
            c_in = 4 * w
    sd["fc.weight"] = rng.randn(1000, 2048) * 0.01
    sd["fc.bias"] = np.zeros(1000)
    return {k: torch.from_numpy(np.asarray(v, np.float32)
                                if v.dtype.kind == "f" else v)
            for k, v in sd.items()}


@pytest.mark.parametrize("name,prelu", [("resnet50", False),
                                        ("resnet50", True),
                                        ("flagship", False),
                                        ("flagship", True)])
def test_resnet_backbone_loads_bitwise_as_jax(name, prelu, tmp_path):
    """A torchvision-layout dict (``layer4`` only for the flagship, which
    passes ``blocks_num=(3, 4, 6, 3)``), with and without PReLU slopes,
    from a ``.pth`` file: the port's ``load_resnet_backbone`` equals the
    JAX package's ``load_resnet_backbone`` followed by
    ``load_jax_variables`` bit for bit, the neck and heads untouched;
    absent slopes import as 0."""
    blocks = (3, 4, 6, 3) if name == "flagship" else (3, 4, 6)
    sd = torchvision_resnet50(np.random.RandomState(3), blocks, prelu)
    jm, params, stats = variables(name)
    jstate = JTrainState.create(apply_fn=jm.apply, params=params,
                                batch_stats=stats, tx=optax.sgd(0.1))
    jstate = jimport.load_resnet_backbone(
        {k: v.numpy() for k, v in sd.items()}, jstate, blocks_num=blocks)
    want, _ = port_model(name, jstate.params, jstate.batch_stats)
    model, state = port_model(name, params, stats)
    path = tmp_path / "resnet50.pth"
    torch.save(sd, path)
    assert pimport.load_resnet_backbone(str(path), state,
                                        blocks_num=blocks) is state
    assert_same_state(model, want)
    slope = float(model.extractor.layer2_1.relu.weight.detach())
    assert slope == (float(sd["layer2.1.relu.weight"]) if prelu else 0.0)


def test_resnet_missing_layer4_shape_and_key_raise():
    """The flagship's trunk with ``blocks_num=(3, 4, 6)`` leaves ``layer4``
    unfilled and raises, naming a ``layer4`` key; a missing key or a wrong
    shape raises naming it."""
    sd = torchvision_resnet50(np.random.RandomState(4))
    _, state = port_model("flagship")
    with pytest.raises(KeyError, match=r"layer4_0"):
        pimport.load_resnet_backbone(sd, state)
    key = "layer3.5.bn2.running_mean"
    with pytest.raises(KeyError, match=key.replace(".", r"\.")):
        pimport.load_resnet_backbone({k: v for k, v in sd.items()
                                      if k != key}, state,
                                     blocks_num=(3, 4, 6, 3))
    bad = dict(sd, **{"layer1.0.conv2.weight": torch.zeros(64, 64, 1, 1)})
    with pytest.raises(ValueError, match=r"layer1_0\.conv2\.weight"):
        pimport.load_resnet_backbone(bad, state, blocks_num=(3, 4, 6, 3))


# ------------------------------------------------------------ Orbax
def test_orbax_converter_output_predicts_as_jax(tmp_path):
    """JAX ``save_checkpoint`` of a flagship state (64x64) ->
    ``scripts/torch_convert_orbax.py`` -> the port's
    ``Predictor.from_checkpoint`` predicts as the JAX model within the box
    tolerance of ``tests/test_torch_detector.py``; the written state has a
    fresh optimiser and counters at 0."""
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    try:
        import torch_convert_orbax as conv
    finally:
        sys.path.remove(os.path.join(REPO, "scripts"))
    jm, v = jax_model()
    jstate = JTrainState.create(apply_fn=jm.apply, params=v["params"],
                                batch_stats=v["batch_stats"],
                                tx=optax.adamw(1e-3))
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jckpt.save_checkpoint(jdir, jstate, name=jckpt.BEST)
    args = [jdir, pdir, "--name", "best", "--flagship", "--set"] + [
        f"{k}={','.join(map(str, v)) if isinstance(v, tuple) else v}"
        for k, v in KW.items() if k not in ("fpn", "backbone",
                                            "loc_normalize")]
    assert conv.main(args) == 0
    cfg = Config(**KW, device="cpu")
    pred = Predictor.from_checkpoint(pdir, cfg, device="cpu",
                                     batch_sizes=(2,))
    x = np.random.RandomState(3).rand(2, 64, 64, 3).astype(np.float32)
    want = jax.jit(lambda v, x: jm.apply(v, x, method="predict"))(v, x)
    assert_matches_jax(pred(x), want)
    payload = torch.load(os.path.join(pdir, "FasterRCNNTrainer_best",
                                      "state.pt"), weights_only=True)
    assert payload["optimizer"]["state"] == {}
    assert payload["step"] == 0 and payload["updates"] == 0
