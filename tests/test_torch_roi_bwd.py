"""PyTorch port, the backward passes of the RoI pooling ops and train-mode
batch norm against the JAX package, float32 on the CPU.

* RoIPool max has three backward rules that differ where a bin's maximum is
  tied: ``"xla"`` (autodiff of the two-stage masked max: ties share evenly
  at each stage), ``"structured"`` (the same shares from tie counts) and
  ``"pallas"`` (kernel 6: all to the first row-major maximum).  Each is held
  against its own JAX reference, the JAX kernel 6 interpreted as
  ``tests/test_pallas_roi_bwd.py`` runs it, on a random map and on a map
  with exact ties.  On the CPU the port's kernel wrappers run their plain
  versions.
* ``roi_pool_max``'s scatter backward against ``jax.grad`` of
  ``roi_pool_pallas`` (interpreted).
* The hybrid RoIAlign (windowed forward, dense backward) against
  ``multilevel_roi_align_hybrid_batched``.
* Train-mode ``BatchNorm`` against ``flax.linen.BatchNorm``.
"""

import importlib

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from two_stage_object_detection_tpu.ops.pallas_roi import roi_pool_pallas
from two_stage_object_detection_tpu.ops.pallas_roi_bwd import (
    roi_pool_fast as j_roi_pool_fast)
from two_stage_object_detection_tpu_torch.models.layers import (
    BatchNorm, frozen_running_stats)
from two_stage_object_detection_tpu_torch.ops import roi_pool as troi
from two_stage_object_detection_tpu_torch.ops.roi_pool_bwd import (
    roi_pool_bwd_recompute, roi_pool_fast, roi_pool_recompute)
from two_stage_object_detection_tpu_torch.ops.roi_pool_max import (
    roi_pool_bwd_scatter, roi_pool_max)
from two_stage_object_detection_tpu_torch.ops.windowed_align import (
    multilevel_roi_align_hybrid_batched, windowed_roi_align_batched)
from two_stage_object_detection_tpu_torch.utils.profiling import counters

# the JAX ops package re-exports a function under its module's name
jroi = importlib.import_module("two_stage_object_detection_tpu.ops.roi_pool")
T = torch.from_numpy
P, SCALE = 7, 1.0 / 16


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several test processes on one CPU; torch's own thread
    pool in each would oversubscribe it many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(rng, data, b=2, r=6, h=13, w=11, c=8):
    """A ``[B, H, W, C]`` map, rois in image coordinates (one hanging off the
    map: empty bins, one tiny: bins that share cells) and a cotangent.
    ``"ties"``: a ReLU-like map of coarse values, half of it exact zeros."""
    if data == "ties":
        feats = np.maximum(rng.randint(-4, 4, size=(b, h, w, c)), 0) / 2.0
    else:
        feats = rng.randn(b, h, w, c)
    xy = rng.rand(b, r, 2) * np.array([w, h]) * 16 * 0.6
    rois = np.concatenate([xy, xy + rng.rand(b, r, 2) * 100 + 20], -1)
    rois[:, 0] = [-90.0, -80.0, 30.0, 40.0]
    rois[:, 1] = [40.0, 40.0, 60.0, 70.0]
    g = rng.randn(b, r, P, P, c)
    return tuple(a.astype(np.float32) for a in (feats, rois, g))


def _jax_grad(mode, feats, rois, g):
    if mode == "pallas":
        def pooled(f):
            return j_roi_pool_fast(f, jnp.asarray(rois), P, SCALE, True)
    else:
        one = jroi.roi_pool if mode == "xla" else jroi.roi_pool_structured

        def pooled(f):
            return jax.vmap(lambda ff, rr: one(ff, rr, P, SCALE))(
                f, jnp.asarray(rois))
    return np.asarray(jax.grad(lambda f: jnp.sum(pooled(f) * g))(
        jnp.asarray(feats)))


PLAIN = {"xla": troi.roi_pool_grad_xla,
         "structured": troi.roi_pool_grad_structured,
         "pallas": troi.roi_pool_grad_first_argmax}


@pytest.mark.parametrize("data", ["random", "ties"])
@pytest.mark.parametrize("mode", ["xla", "structured", "pallas"])
def test_roi_pool_backward_mode_matches_its_jax_reference(rng, mode, data):
    """The gradient of ``sum(pooled * g)`` through the differentiable
    RoIPool max under each rule, and the rule's plain function on ``g``,
    within 1e-5 of the JAX reference of that rule (f32 sums of up to a few
    dozen shares in another order)."""
    feats, rois, g = _inputs(rng, data)
    want = _jax_grad(mode, feats, rois, g)
    f = T(feats).requires_grad_(True)
    pooled = roi_pool_recompute(f, T(rois), P, SCALE, mode)
    want_fwd = jax.vmap(lambda ff, rr: jroi.roi_pool(ff, rr, P, SCALE))(
        feats, rois)
    np.testing.assert_array_equal(pooled.detach().numpy(), np.asarray(want_fwd))
    (pooled * T(g)).sum().backward()
    np.testing.assert_allclose(f.grad.numpy(), want, rtol=0, atol=1e-5)
    plain = PLAIN[mode](T(feats), T(rois), T(g), P, SCALE)
    np.testing.assert_allclose(plain.numpy(), want, rtol=0, atol=1e-5)
    assert np.abs(want).max() > 0.1 and (pooled[:, 0] == 0).any()


def test_roi_pool_backward_modes_differ_on_ties_as_in_jax(rng):
    """On a tied map the first-argmax rule differs from the even split, and
    "structured" equals "xla": the same pattern in both packages.  On a
    random map (no ties) all three agree."""
    feats, rois, g = _inputs(rng, "ties")
    jx = {m: _jax_grad(m, feats, rois, g) for m in PLAIN}
    tx = {m: PLAIN[m](T(feats), T(rois), T(g), P, SCALE).numpy() for m in PLAIN}
    for grads in (jx, tx):
        assert np.abs(grads["pallas"] - grads["xla"]).max() > 0.1
        np.testing.assert_allclose(grads["structured"], grads["xla"], atol=1e-5)
    # every rule hands out the whole cotangent of the non-empty bins
    for m in PLAIN:
        np.testing.assert_allclose(tx[m].sum(), jx[m].sum(), rtol=1e-4)
    feats, rois, g = _inputs(rng, "random")
    tx = {m: PLAIN[m](T(feats), T(rois), T(g), P, SCALE).numpy() for m in PLAIN}
    np.testing.assert_allclose(tx["pallas"], tx["xla"], atol=1e-5)
    np.testing.assert_allclose(tx["structured"], tx["xla"], atol=1e-5)


def test_roi_pool_fast_and_kernel6_wrapper_on_cpu(rng):
    """``roi_pool_fast`` is the "pallas" rule; the kernel 6 wrapper runs its
    plain version on CPU tensors and counts no launch; the result keeps the
    map's dtype (bf16 maps: f32 accumulation, one rounding)."""
    feats, rois, g = _inputs(rng, "ties")
    before = counters["launch.roi_pool_bwd_recompute"]
    got = roi_pool_bwd_recompute(T(feats), T(rois), T(g), P, SCALE)
    want = troi.roi_pool_grad_first_argmax(T(feats), T(rois), T(g), P, SCALE)
    assert counters["launch.roi_pool_bwd_recompute"] == before
    assert torch.equal(got, want)
    f = T(feats).requires_grad_(True)
    (roi_pool_fast(f, T(rois), P, SCALE) * T(g)).sum().backward()
    assert torch.equal(f.grad, want)
    half = roi_pool_bwd_recompute(T(feats).bfloat16(), T(rois), T(g), P, SCALE)
    assert half.dtype == torch.bfloat16
    assert torch.equal(half, want.bfloat16())      # the map is exact in bf16
    with pytest.raises(ValueError, match="roi_bwd"):
        roi_pool_recompute(T(feats), T(rois), P, SCALE, "scatter")


@pytest.mark.parametrize("data", ["random", "ties"])
def test_roi_pool_max_backward_matches_jax_pallas(rng, data):
    """``roi_pool_max`` (kernel 5) is differentiable like ``roi_pool_pallas``:
    its backward adds the cotangent at the saved argmax and drops empty
    bins; within 1e-5 of ``jax.grad`` of the interpreted JAX kernel."""
    feats, rois, g = _inputs(rng, data)
    want = np.asarray(jax.grad(lambda f: jnp.sum(jax.vmap(
        lambda ff, rr: roi_pool_pallas(ff, rr, P, SCALE, True))(
            f, jnp.asarray(rois)) * g))(jnp.asarray(feats)))
    f = T(feats).requires_grad_(True)
    pooled, argmax = roi_pool_max(f, T(rois), P, SCALE)
    assert argmax.dtype == torch.int32 and not argmax.requires_grad
    (pooled * T(g)).sum().backward()
    np.testing.assert_allclose(f.grad.numpy(), want, rtol=0, atol=1e-5)
    # the scatter wrapper on the CPU is its plain version
    before = counters["launch.roi_pool_bwd_scatter"]
    again = roi_pool_bwd_scatter(argmax, T(g), *feats.shape[1:3])
    assert counters["launch.roi_pool_bwd_scatter"] == before
    np.testing.assert_allclose(again.numpy(), want, rtol=0, atol=1e-5)
    assert (argmax < 0).any()


def test_roi_pool_max_skips_the_index_when_no_backward_follows(rng):
    """``with_argmax=False`` returns no index; the values are the same, and
    a gradient still flows where one is asked for."""
    feats, rois, g = _inputs(rng, "ties")
    both = roi_pool_max(T(feats), T(rois), P, SCALE)
    with torch.inference_mode():
        values, none = roi_pool_max(T(feats), T(rois), P, SCALE,
                                    with_argmax=False)
    assert none is None and torch.equal(values, both[0])
    f = T(feats).requires_grad_(True)
    pooled, none = roi_pool_max(f, T(rois), P, SCALE, with_argmax=False)
    assert none is None
    (pooled * T(g)).sum().backward()
    want = troi.scatter_argmax_grad(both[1], T(g), *feats.shape[1:3])
    assert torch.equal(f.grad, want)


def _pyramid(rng, b=2, c=8, img=128):
    sizes = (32, 16, 8, 4)
    pyr = [rng.randn(b, s, s, c).astype(np.float32) for s in sizes]
    side = rng.choice([12.0, 30.0, 70.0], size=(b, 10)) * rng.uniform(
        0.7, 1.4, size=(b, 10))
    xy = rng.rand(b, 10, 2) * (img - 20)
    rois = np.concatenate([xy, xy + side[..., None] * rng.uniform(
        0.6, 1.6, size=(b, 10, 2))], -1).astype(np.float32)
    levels = rng.randint(0, 4, size=(b, 10)).astype(np.int32)
    scales = tuple((s / img, s / img) for s in sizes)
    return pyr, rois, levels, scales


def test_hybrid_roi_align_matches_jax(rng):
    """Forward within 1e-5 of the JAX hybrid's (the windowed values) and the
    gradient of every level within 1e-5 of its dense backward; rois and
    levels get none.  Window 8 on a 32-cell level: some rois overflow it, so
    the backward is not the forward's own derivative, in both packages."""
    pyr, rois, levels, scales = _pyramid(rng)
    g = rng.randn(2, 10, P, P, 8).astype(np.float32)

    def jloss(pyramid):
        out = jroi.multilevel_roi_align_hybrid_batched(
            pyramid, jnp.asarray(rois), jnp.asarray(levels), scales, P, 2, 8,
            False, False)
        return jnp.sum(out * g), out

    (_, want_out), want_grads = jax.value_and_grad(jloss, has_aux=True)(
        tuple(jnp.asarray(p) for p in pyr))
    tp = [T(p).requires_grad_(True) for p in pyr]
    tr = T(rois).requires_grad_(True)
    out = multilevel_roi_align_hybrid_batched(tp, tr, T(levels), scales, P, 2, 8)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out),
                               rtol=0, atol=1e-5)
    assert torch.equal(out.detach(), windowed_roi_align_batched(
        [T(p) for p in pyr], T(rois), T(levels), scales, P, 2, 8))
    (out * T(g)).sum().backward()
    for t, w in zip(tp, want_grads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-5)
        assert np.abs(np.asarray(w)).max() > 0.1
    assert tr.grad is None


def test_batch_norm_train_mode_matches_flax(rng):
    """Two train-mode calls: outputs within 1e-5, running mean and (biased)
    variance within 1e-6 of flax's ``momentum=0.9`` averages; the gradient
    flows through the batch statistics as in flax; ``frozen_running_stats``
    gives the same output and moves nothing; eval mode uses the averages."""
    c = 6
    xs = [(rng.randn(3, 5, 7, c) * s + m).astype(np.float32)
          for s, m in ((2.0, 1.0), (0.5, -1.0))]
    scale = rng.uniform(0.5, 1.5, c).astype(np.float32)
    bias = rng.randn(c).astype(np.float32)
    jbn = nn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    v = {"params": {"scale": scale, "bias": bias},
         "batch_stats": {"mean": np.zeros(c, np.float32),
                         "var": np.ones(c, np.float32)}}
    bn = BatchNorm(c)
    with torch.no_grad():
        bn.weight.copy_(T(scale))
        bn.bias.copy_(T(bias))
    bn.train()
    for x in xs:
        want, mut = jbn.apply(v, x, mutable=["batch_stats"])
        v = {"params": v["params"], "batch_stats": mut["batch_stats"]}
        got = bn(T(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=0, atol=1e-5)
        np.testing.assert_allclose(bn.running_mean.numpy(),
                                   np.asarray(v["batch_stats"]["mean"]),
                                   rtol=0, atol=1e-6)
        np.testing.assert_allclose(bn.running_var.numpy(),
                                   np.asarray(v["batch_stats"]["var"]),
                                   rtol=0, atol=1e-6)
    w = rng.randn(3, 5, 7, c).astype(np.float32)
    want_g = jax.grad(lambda x: jnp.sum(jbn.apply(
        v, x, mutable=["batch_stats"])[0] * w))(jnp.asarray(xs[0]))
    x = T(xs[0]).requires_grad_(True)
    before = bn.running_mean.clone()
    with frozen_running_stats(bn):
        out = bn(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert torch.equal(bn.running_mean, before)
    (out * T(w)).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_g), rtol=0,
                               atol=1e-4)
    bn.eval()
    jev = nn.BatchNorm(use_running_average=True, epsilon=1e-5)
    np.testing.assert_allclose(
        bn(T(xs[1]).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).detach().numpy(),
        np.asarray(jev.apply(v, xs[1])), rtol=0, atol=1e-5)
