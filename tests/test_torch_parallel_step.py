"""PyTorch port, the data-parallel train step against the JAX package's
under a ``(data=2)`` mesh, on the CPU: both ported detectors at 64x64
(``tests/test_torch_train.py``'s configs, one update a micro-step), a
global batch of 4, 2 images on each of 2 gloo ranks.

The JAX side is the package's ``train_step_fn`` body (``value_and_grad`` of
``train_forward`` with the mutable batch statistics) jitted over its own
``make_mesh(n_data=2)`` with ``place_train_state`` / ``shard_batch``, as
``tests/test_sharding.py`` places them: one SPMD program whose batch norms
take the global batch's statistics and whose gradient is the global
batch's.  It leaves out the ``sampling`` rng that ``train_step`` always
passes, so that both sides sample the first k in index order
(``generator=None`` in the port).  The weights are the seeded ones of
``tests/test_torch_train.py``, moved (``_settle``) away from every ReLU and
pooling decision on the 4 images.

The update is held against the JAX package's optimiser driven with the
port's all-reduced gradient, as ``test_torch_train.py``'s optimiser test
does, and not against the JAX step's own parameters: a batch-norm bias
that feeds another batch norm has a gradient of exactly 0, so both
packages compute rounding noise there (the JAX step on one device and on
the mesh disagree on it too), and AdamW's first update turns the sign of
that noise into a step of ``lr`` either way.
"""

import jax
import numpy as np
import optax
import pytest
import torch
from flax.core import unfreeze

from tests import torch_dp_workers as workers
from tests.test_torch_train import MODELS, Pair, _batch, _leaves, _settle
from two_stage_object_detection_tpu.nets.trainer import (
    TrainState as JTrainState, make_optimizer as j_make_optimizer)
from two_stage_object_detection_tpu.parallel import mesh as jmesh
from two_stage_object_detection_tpu_torch.nets.detector import FasterRCNN
from two_stage_object_detection_tpu_torch.utils.jax_weights import (
    to_jax_variables)

STEPS_PER_EPOCH = 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_grads(state, batch):
    def loss_fn(params):
        out, mutated = state.apply_fn(
            {"params": params, "batch_stats": state.batch_stats},
            batch["image"], batch["boxes"], batch["labels"], batch["valid"],
            method="train_forward", mutable=["batch_stats"])
        return out["losses"]["total"], (mutated["batch_stats"], out["losses"])

    (_, (new_stats, losses)), grads = jax.value_and_grad(
        loss_fn, has_aux=True)(state.params)
    return grads, new_stats, losses


@pytest.mark.parametrize("name", list(MODELS))
def test_data_parallel_step_matches_jax_mesh(name, tmp_path):
    """One update on a global batch of 4: the losses (the mean of the two
    ranks') within 1e-5 of the JAX mesh step's; the all-reduced gradient,
    leaf by leaf, within 1e-3 of the leaf's largest magnitude plus 1e-5 of
    the model's (``test_torch_train.py``'s gradient tolerance) of the JAX
    mesh step's; the new running statistics within 1e-5; every parameter
    within 1e-5 + 1e-5 * |p| of the JAX optimiser's update from that
    gradient (at most one element in 10,000 of a leaf, or two, off by at
    most two steps of ``lr``, where a gradient is as small as AdamW's
    ``eps``); and the two ranks' states equal bit for bit."""
    pair = Pair(name)
    cfg_kw = dict(MODELS[name], grad_accum_steps=1)
    batch = _batch(np.random.RandomState(11), b=4)
    model = pair.port_model()
    least = _settle(model, torch.from_numpy(batch["image"]))
    assert least["kink"] >= 0.9e-3
    params, stats = to_jax_variables(model)
    sd = {k: v.clone() for k, v in model.state_dict().items()}

    r0, r1 = workers.spawn(workers.train_step_rank, 2, str(tmp_path), cfg_kw,
                           sd, [batch], 1)
    for k, v in r0["state"].items():
        assert torch.equal(v, r1["state"][k]), k
    assert r0["updates"] == 1 and r0["bn_groups"] > 0

    jcfg = pair.jcfg.replace(grad_accum_steps=1)
    tx = j_make_optimizer(jcfg, STEPS_PER_EPOCH)
    mesh = jmesh.make_mesh(n_data=2)
    state = jmesh.place_train_state(
        JTrainState.create(apply_fn=pair.jm.apply, params=params,
                           batch_stats=stats, tx=tx), mesh)
    with mesh:
        grads, new_stats, losses = jax.jit(_jax_grads)(
            state, jmesh.shard_batch(batch, mesh))
    for k, v in losses.items():
        got = np.mean([r0["losses"][0][k], r1["losses"][0][k]])
        np.testing.assert_allclose(got, float(v), rtol=1e-5, atol=1e-5,
                                   err_msg=k)

    port = FasterRCNN(pair.cfg, device="cpu")
    port.load_state_dict(r0["state"])
    for n, p in port.named_parameters():
        p.grad = r0["grads"][n]
    got_g, _ = to_jax_variables(port, grads=True)
    want_g = dict(_leaves(jax.tree.map(np.asarray, unfreeze(grads))))
    top = max(np.abs(w).max() for w in want_g.values())
    for leaf, got in _leaves(got_g):
        tol = 1e-3 * np.abs(want_g[leaf]).max() + 1e-5 * top
        np.testing.assert_allclose(got, want_g[leaf], rtol=0, atol=tol,
                                   err_msg=leaf)
    got_p, got_s = to_jax_variables(port)
    for leaf, got in _leaves(got_s):
        np.testing.assert_allclose(
            got, dict(_leaves(jax.tree.map(np.asarray,
                                           unfreeze(new_stats))))[leaf],
            rtol=1e-4, atol=1e-5, err_msg=leaf)

    updates, _ = tx.update(jax.tree.map(np.asarray, got_g),
                           tx.init(params), params)
    want_p = dict(_leaves(jax.tree.map(
        np.asarray, optax.apply_updates(params, updates))))
    before = dict(_leaves(params))
    moved = 0
    for leaf, got in _leaves(got_p):
        want = want_p[leaf]
        diff = np.abs(got - want)
        off = diff > 1e-5 + 1e-5 * np.abs(want)
        assert off.sum() <= max(2, 1e-4 * off.size), (leaf, off.sum())
        assert diff.max() <= 2.1 * pair.cfg.lr, (leaf, diff.max())
        moved += int(not np.array_equal(got, before[leaf]))
    assert moved == len(want_p)
