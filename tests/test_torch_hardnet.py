"""PyTorch port, HarDNet backbones against the JAX package's flax modules,
in float32 on the CPU at 64x64.

``hardnet39`` (reference layout) and ``hardnet39s`` (strided, with its
pyramid taps) are compared by value, with the flax init carried across by
``load_jax_variables`` and the batch-norm leaves randomised.  The two share
every parameter but ``pyr_down``, so one flax init serves both.
``hardnet68``/``hardnet85`` are checked by output shapes and a complete
weight load, which keeps JAX compile time down.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import unfreeze

from two_stage_object_detection_tpu.models.hardnet import (
    hard_block_links as j_links)
from two_stage_object_detection_tpu.models.registry import (
    build_backbone as j_build)
from two_stage_object_detection_tpu_torch.models.hardnet import (
    HarDNetFeatureExtraction, _ARCH, hard_block_links, relu6)
from two_stage_object_detection_tpu_torch.models.registry import build_backbone
from two_stage_object_detection_tpu_torch.utils.jax_weights import (
    load_jax_variables)

X = np.random.RandomState(7).rand(2, 64, 64, 3).astype(np.float32)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several test processes on one CPU; torch's own thread
    pool in each would oversubscribe it many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(tree):
    return jax.tree.map(lambda a: np.array(a, np.float32), unfreeze(tree))


def _randomise_bn(tree, rng):
    """Perturb batch-norm scale/bias/mean/var leaves in place (a conv bias
    is a ``bias`` leaf too: perturbing it exercises that rule as well)."""
    for k, v in tree.items():
        if isinstance(v, dict):
            _randomise_bn(v, rng)
        elif k in ("scale", "var"):
            tree[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        elif k in ("mean", "bias"):
            tree[k] = (rng.randn(*v.shape) * 0.1).astype(np.float32)
    return tree


@pytest.fixture(scope="module")
def flax_vars():
    """One flax init of hardnet39s with its pyramid taps (the superset)."""
    jm, _ = j_build("hardnet39s", pyramid=True)
    v = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    rng = np.random.RandomState(1)
    return (_randomise_bn(_np_tree(v["params"]), rng),
            _randomise_bn(_np_tree(v["batch_stats"]), rng))


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("name,pyramid", [("hardnet39", False),
                                          ("hardnet39s", True)])
def test_hardnet39_matches_flax(flax_vars, name, pyramid):
    """Each output map within 1e-4 of its largest |value| (float32 conv
    accumulation order through ~100 layers)."""
    params, stats = flax_vars
    if not pyramid:
        params = {k: v for k, v in params.items() if k != "pyr_down"}
        stats = {k: v for k, v in stats.items() if k != "pyr_down"}
    jm, j_ch = j_build(name, pyramid=pyramid)
    want = jax.jit(jm.apply)({"params": params, "batch_stats": stats}, X)
    model, ch = build_backbone(name, pyramid=pyramid)
    assert ch == j_ch
    load_jax_variables(model, params, stats)
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(X).permute(0, 3, 1, 2))
    want = want if pyramid else (want,)
    got = got if pyramid else (got,)
    assert len(got) == len(want) == (4 if pyramid else 1)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert _nhwc(g).shape == w.shape
        np.testing.assert_allclose(_nhwc(g), w, rtol=0,
                                   atol=1e-4 * np.abs(w).max())


@pytest.mark.parametrize("name", ["hardnet68", "hardnet85"])
def test_hardnet_deeper_archs_shapes_and_weight_load(name):
    """Every flax leaf of the variable tree (shapes from ``eval_shape``)
    has a port counterpart of its shape and every port variable is
    filled; the port's output shapes equal flax's."""
    jm, j_ch = j_build(name)
    out_shapes, shapes = jax.eval_shape(
        lambda x: jm.init_with_output(jax.random.PRNGKey(0), x),
        jnp.zeros((2, 64, 64, 3)))
    rng = np.random.RandomState(2)
    fill = lambda s: (rng.randn(*s.shape) * 0.05).astype(np.float32)  # noqa: E731
    tree = _randomise_bn(jax.tree.map(fill, unfreeze(shapes)), rng)
    model, ch = build_backbone(name)
    assert ch == j_ch == 512
    load_jax_variables(model, tree["params"], tree["batch_stats"])
    with torch.no_grad():
        got = _nhwc(model.eval()(torch.from_numpy(X).permute(0, 3, 1, 2)))
    assert got.shape == out_shapes.shape == (2, 4, 4, 512)
    assert np.isfinite(got).all()


@pytest.mark.parametrize("arch", [39, 68, 85])
def test_hard_block_links_match_jax(arch):
    first_ch, ch_list, grmul, gr, n_layers, _ = _ARCH[arch]
    ch = first_ch[1]
    for i, n in enumerate(n_layers):
        got = hard_block_links(n, ch, gr[i], grmul)
        assert got == j_links(n, ch, gr[i], grmul)
        ch = ch_list[i]


def test_registry_hardnet_names():
    """Reference layout and strided names; the reference layout cannot feed
    an FPN (the same ValueError as the JAX registry)."""
    for name, arch, strided in (("hardnet39", 39, False), ("HarDNet68", 68, False),
                                ("hardnet85s", 85, True)):
        mod, ch = build_backbone(name)
        assert isinstance(mod, HarDNetFeatureExtraction)
        assert (mod.arch, mod.strided, ch) == (arch, strided, 512)
    _, ch = build_backbone("hardnet68s", pyramid=True)
    assert ch == j_build("hardnet68s", pyramid=True)[1]
    with pytest.raises(ValueError, match="cannot feed an FPN"):
        build_backbone("hardnet39", pyramid=True)
    with pytest.raises(ValueError, match="cannot feed an FPN"):
        j_build("hardnet39", pyramid=True)
    x = torch.tensor([-1.0, 0.5, 7.0])
    assert torch.equal(relu6(x), torch.tensor([0.0, 0.5, 6.0]))
