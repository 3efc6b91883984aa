"""PyTorch port, the training slice as a whole against the JAX package:
``train_forward`` + backward and the trainer of both ported detectors, at a
small size (64x64 images, 3 classes), float32 on the CPU.

Weights are seeded numpy values on the shapes of the flax init
(``load_jax_variables`` carries them across); sampling is deterministic on
both sides (no ``sampling`` rng / ``generator=None``).  The JAX single-scale
detector runs ``pallas="on"`` (the whole-table proposal kernel, interpreted,
as in ``tests/test_torch_single_scale.py``) with ``roi_bwd="pallas"`` (its
kernel 6, interpreted); the port runs the plain versions of its kernels.

Gradients are compared leaf by leaf through ``to_jax_variables``: each leaf
within 1e-3 of its own largest magnitude plus 1e-5 of the model's largest
gradient magnitude (measured worst: 5.5e-4 of a leaf for a PReLU slope of the
flagship, 2e-4 for its other leaves, 6e-5 on the single scale).

A gradient is a step function of the forward pass wherever the model takes a
decision: a ReLU6 / PReLU / ReLU unit on one side of its threshold, a
RoIPool bin's maximum at one pixel or another.  The two packages' float32
forward passes differ by rounding (up to 4e-5 after HarDNet's 40 train-mode
batch norms), so with plain random weights a few decisions among millions
fall differently, and three such flips in HarDNet's 4x4 blocks move every
leaf below them by 2%.  ``_settle`` removes the cause instead of allowing
for it: on the test's own images it shifts the backbone's batch-norm biases
(and the tail's conv bias) channel by channel until no pre-activation lies
within ``MARGIN`` of a threshold, and nudges the tail's depth-wise taps
until no two pixels of a channel of the pooled map are closer than
``MARGIN`` without being equal (equal ones come from all-zero windows, are
equal in both packages, and go to the first in row-major order in both).
The test asserts both margins on the port's side, 25 times the forward
difference, so both packages take the same decisions and the gradients
agree to rounding.  What stays undecided is the flagship's stem max pool
and the heads' ReLUs, whose flips move one leaf by less than the tolerance.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.core import unfreeze

from two_stage_object_detection_tpu.config import Config as JConfig
from two_stage_object_detection_tpu.nets.detector import FasterRCNN as JFasterRCNN
from two_stage_object_detection_tpu.nets.trainer import (
    make_optimizer as j_make_optimizer)
from two_stage_object_detection_tpu_torch.config import Config
from two_stage_object_detection_tpu_torch.models.hardnet import (
    ConvLayer, HarDNetFeatureExtraction)
from two_stage_object_detection_tpu_torch.models.resnet import Bottleneck
from two_stage_object_detection_tpu_torch.nets.detector import FasterRCNN
from two_stage_object_detection_tpu_torch.nets.trainer import (
    TrainState, create_train_state, eval_step, make_optimizer, predict_step,
    train_step)
from two_stage_object_detection_tpu_torch.utils.jax_weights import (
    load_jax_variables, to_jax_variables)

COMMON = dict(input_size=(64, 64), num_classes=3, batch_size=2, max_gt_boxes=4,
              n_train_pre_nms=128, n_train_post_nms=32, n_test_pre_nms=64,
              n_test_post_nms=16, roi_n_sample=8, rpn_n_sample=32,
              max_detections=8, grad_accum_steps=2, compute_dtype="float32")
MODELS = {
    # 64x64 -> a 4x4 map, 144 anchors: the whole-table proposal route
    "single_scale": dict(COMMON, roi_bwd="pallas"),
    # 1,023 anchors, 6 * 128 <= 1,023: the cut + greedy NMS route
    "flagship": dict(COMMON, fpn=True, backbone="resnet50", loc_normalize=True,
                     fpn_channels=32, fpn_fc_dim=64),
}
# the RoI pooling routes without a hand kernel, whose detectors
# tests/test_torch_roi_routes.py holds against JAX with this file's checks
ROUTES = {
    "single_align": dict(COMMON, roi_pool_mode="align"),
    "single_mean": dict(COMMON, roi_pool_mode="mean"),
    "flagship_dense": dict(MODELS["flagship"], fpn_roi_window=0),
}
JAX_EXTRA = {"single_scale": dict(pallas="on"), "flagship": {},
             "single_align": dict(pallas="on"),
             "single_mean": dict(pallas="on"), "flagship_dense": {}}
STEPS_PER_EPOCH = 4          # t_max = 5 * 4 // 2 = 10 updates


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several test processes on one CPU; torch's own thread
    pool in each would oversubscribe it many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fill(shapes, rng):
    """Seeded numpy values for a flax variable tree of ``ShapeDtypeStruct``s:
    kernels ~ N(0, 1/fan_in), biases and batch-norm mean ~ 0.1 N(0, 1),
    batch-norm scale and var ~ U(0.5, 1.5), PReLU slopes 0.25."""
    out = {}
    for k, v in shapes.items():
        if not hasattr(v, "shape"):
            out[k] = _fill(v, rng)
        elif k == "kernel":
            fan_in = int(np.prod(v.shape[:-1]))
            out[k] = (rng.randn(*v.shape) / np.sqrt(fan_in)).astype(np.float32)
        elif k in ("scale", "var"):
            out[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        elif k == "alpha":
            out[k] = np.full(v.shape, 0.25, np.float32)
        else:
            out[k] = (rng.randn(*v.shape) * 0.1).astype(np.float32)
    return out


def _batch(rng, b=2, g=4, size=64):
    """Images, 1..3 valid boxes of 12..40 px each, padded to ``g``."""
    side = rng.uniform(12.0, 40.0, size=(b, g, 2))
    xy = rng.rand(b, g, 2) * (size - side)
    boxes = np.concatenate([xy, xy + side], -1).astype(np.float32)
    valid = np.arange(g)[None] < rng.randint(1, g, size=(b, 1))
    boxes[~valid] = 0.0
    return {"image": rng.rand(b, size, size, 3).astype(np.float32),
            "boxes": boxes, "labels": rng.randint(0, 3, (b, g)).astype(np.int32),
            "valid": valid}


MARGIN = 1e-3


def _kink_sites(ext):
    """Where the backbone's activations have their thresholds: ``(module,
    hook on its "in"put or "out"put, thresholds, the bias that shifts the
    tensor there at the module's n-th call)``."""
    if isinstance(ext, HarDNetFeatureExtraction):
        return ([(m.norm, "out", (0.0, 6.0), [m.norm.bias])
                 for m in ext.modules() if isinstance(m, ConvLayer)]
                + [(ext.tail0, "out", (0.0,), [ext.tail0.bias])])
    return ([(ext.relu, "in", (0.0,), [ext.bn1.bias])]
            + [(m.relu, "in", (0.0,), [m.bn1.bias, m.bn2.bias, m.bn3.bias])
               for m in ext.modules() if isinstance(m, Bottleneck)])


def _clear_shift(v, thresholds, margin):
    """For ``v [N, C, H, W]``, the per-channel shift of least magnitude (a
    multiple of ``margin / 2``) that leaves no value within ``margin`` of a
    threshold."""
    flat = v.transpose(0, 1).flatten(1).double()

    def clearance(shift):
        return torch.stack([(flat + shift[:, None] - t).abs().amin(1)
                            for t in thresholds]).amin(0)

    shift = torch.zeros(len(flat), dtype=torch.float64)
    todo = clearance(shift) < margin
    k = 0
    while todo.any():
        k += 1
        assert k < 1000, "no clear shift below 0.5"
        for step in (0.5 * k * margin, -0.5 * k * margin):
            cand = torch.where(todo, torch.full_like(shift, step), shift)
            found = todo & (clearance(cand) >= margin)
            shift = torch.where(found, cand, shift)
            todo &= ~found
    return shift.float()


def _pool_gaps(ext, r):
    """The least non-zero distance between two pixels of one image, for each
    channel of the map that RoIPool max reads, from ``r = relu(tail0)``."""
    v = ext.tail2(ext.tail1(r)).flatten(2).double().sort(dim=2).values
    gap = v[..., 1:] - v[..., :-1]
    return torch.where(gap == 0, torch.full_like(gap, 1.0), gap).amin((0, 2))


@torch.no_grad()
def _settle(model, image, adjust=True, margin=MARGIN):
    """One train-mode forward of the backbone on ``image [B, H, W, 3]``
    that moves its weights, in place, away from every decision (module
    docstring).  Returns the least distance to a threshold and the least
    pool gap that remain; ``adjust=False`` only measures."""
    ext = model.extractor
    least = {"kink": float("inf"), "pool_gap": float("inf")}
    hooks, seen = [], {}

    for mod, where, thresholds, biases in _kink_sites(ext):
        def clear(v, mod=mod, thresholds=thresholds, biases=biases):
            n = seen[mod] = seen.get(mod, -1) + 1
            if adjust:
                shift = _clear_shift(v, thresholds, margin)
                biases[n].add_(shift)
                v = v + shift.view(1, -1, 1, 1)
            least["kink"] = min(least["kink"], *(
                float((v - t).abs().min()) for t in thresholds))
            return v

        hooks.append(
            mod.register_forward_hook(lambda m, i, o, f=clear: f(o))
            if where == "out" else
            mod.register_forward_pre_hook(lambda m, i, f=clear: (f(i[0]),)))
    pooled = isinstance(ext, HarDNetFeatureExtraction) and not ext.pyramid
    if pooled:
        hooks.append(ext.tail1.register_forward_pre_hook(
            lambda m, i: seen.update(r=i[0])))
    ext.train()
    ext(image.permute(0, 3, 1, 2).contiguous())
    ext.eval()
    for h in hooks:
        h.remove()
    if pooled:
        rng = np.random.RandomState(1)
        w1, w2 = ext.tail1.weight, ext.tail2.weight     # [2C,1,3,3], [C,2,1,1]
        for k in range(1, 200 if adjust else 1):
            bad = (_pool_gaps(ext, seen["r"]) < margin).nonzero().flatten()
            if not len(bad):
                break
            src = torch.cat([2 * bad, 2 * bad + 1])
            keep1, keep2 = w1[src].clone(), w2[bad].clone()
            w1[src] += 0.01 * k * torch.from_numpy(
                rng.randn(*keep1.shape).astype(np.float32))
            w2[bad] += 0.01 * k * torch.from_numpy(
                rng.randn(*keep2.shape).astype(np.float32))
            still = _pool_gaps(ext, seen["r"])[bad] < margin
            w1[src[still.repeat(2)]] = keep1[still.repeat(2)]
            w2[bad[still]] = keep2[still]
        least["pool_gap"] = float(_pool_gaps(ext, seen["r"]).min())
    return least


class Pair:
    """One model in both packages with the same seeded weights, and the
    jitted JAX ``train_forward`` value-and-grad."""

    def __init__(self, name):
        kw = {**MODELS, **ROUTES}[name]
        self.cfg = Config(**kw, device="cpu")
        self.jcfg = JConfig(**kw, **JAX_EXTRA[name])
        self.jm = JFasterRCNN(self.jcfg)
        shapes = unfreeze(jax.eval_shape(self.jm.init, jax.random.PRNGKey(0),
                                         jnp.zeros((1, 64, 64, 3))))
        rng = np.random.RandomState(0)
        self.params = _fill(shapes["params"], rng)
        self.stats = _fill(shapes["batch_stats"], rng)
        # small RPN deltas, so proposals stay inside the image and overlap
        self.params["rpn_head"]["loc"]["kernel"] *= 0.1
        # the batch of the gradient test, and weights that decide nothing
        # within MARGIN on it
        self.batch = _batch(np.random.RandomState(2))
        model = self.port_model()
        _settle(model, torch.from_numpy(self.batch["image"]))
        self.params, _ = to_jax_variables(model)

        def loss_fn(params, stats, batch):
            out, mut = self.jm.apply(
                {"params": params, "batch_stats": stats}, batch["image"],
                batch["boxes"], batch["labels"], batch["valid"],
                method="train_forward", mutable=["batch_stats"])
            return out["losses"]["total"], (mut["batch_stats"], out["losses"])

        self.jax_step = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))

    def port_model(self):
        model = FasterRCNN(self.cfg, device="cpu")
        return load_jax_variables(model, self.params, self.stats)


@pytest.fixture(scope="module", params=list(MODELS))
def pair(request):
    return Pair(request.param)


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), np.asarray(v)


def test_train_forward_and_gradients_match_jax(pair):
    """``train_forward(train=True)``: the four losses within 2e-5 * (1 +
    |loss|) (measured: up to 1.5e-5 on a loss of 1.5 after ResNet-50's 53
    float32 conv layers), every gradient leaf, backbone included, within the
    tolerance of the module docstring on weights that keep ``MARGIN`` from
    every decision, the new running statistics within 1e-5; and the
    trainer-parity predictions."""
    check_train_forward_and_gradients(pair)


def check_train_forward_and_gradients(pair):
    """The checks of :func:`test_train_forward_and_gradients_match_jax` on
    ``pair``."""
    batch = pair.batch
    (_, (j_stats, j_losses)), j_grads = pair.jax_step(pair.params, pair.stats,
                                                      batch)
    model = pair.port_model()
    least = _settle(model, torch.from_numpy(batch["image"]), adjust=False)
    assert least["kink"] >= 0.9 * MARGIN and least["pool_gap"] >= 0.9 * MARGIN
    model = pair.port_model()
    t = {k: torch.from_numpy(v) for k, v in batch.items()}
    out = model.train_forward(t["image"], t["boxes"], t["labels"], t["valid"])
    assert model.training
    for name in ("rpn_loc", "rpn_cls", "roi_loc", "roi_cls", "total"):
        np.testing.assert_allclose(float(out["losses"][name]),
                                   float(j_losses[name]), rtol=2e-5, atol=2e-5,
                                   err_msg=name)
    assert float(j_losses["roi_loc"]) > 0 and float(j_losses["rpn_loc"]) > 0
    out["losses"]["total"].backward()

    grads, _ = to_jax_variables(model, grads=True)
    want = dict(_leaves(unfreeze(j_grads)))
    got = dict(_leaves(grads))
    assert set(got) == set(want)
    top = max(np.abs(w).max() for w in want.values())
    assert top > 1e-3
    assert 100 < sum(n.startswith("extractor/") for n in want) < len(want) - 4
    for name, w in want.items():
        tol = 1e-3 * np.abs(w).max() + 1e-5 * top
        np.testing.assert_allclose(got[name], w, rtol=0, atol=tol,
                                   err_msg=name)

    _, stats = to_jax_variables(model)
    want_stats = dict(_leaves(unfreeze(j_stats)))
    got_stats = dict(_leaves(stats))
    assert set(got_stats) == set(want_stats)
    moved = 0
    for name, w in want_stats.items():
        np.testing.assert_allclose(got_stats[name], w, rtol=1e-4, atol=1e-5,
                                   err_msg=name)
        moved += int(not np.array_equal(w, dict(_leaves(pair.stats))[name]))
    assert moved == len(want_stats)

    assert out["boxes_pred"].shape == (2, 8, 4)
    assert out["classes_pred"].shape == out["pred_valid"].shape == (2, 8)
    assert torch.equal(out["gt_labels"], t["labels"] + 1)


def test_eval_forward_matches_jax_and_moves_nothing(pair):
    """``train_forward(train=False)`` (running statistics, the test-time
    proposal counts): losses within 2e-5 * (1 + |loss|), predictions equal,
    no statistic moved; ``predict`` afterwards runs in eval mode."""
    batch = pair.batch
    want = jax.jit(lambda p, s, b: pair.jm.apply(
        {"params": p, "batch_stats": s}, b["image"], b["boxes"], b["labels"],
        b["valid"], train=False, method="train_forward"))(
            pair.params, pair.stats, batch)
    model = pair.port_model()
    state = TrainState(pair.cfg, model, *make_optimizer(
        pair.cfg, model.parameters()))
    before = copy.deepcopy(model.state_dict())
    out = eval_step(state, batch)
    assert not model.training
    for name, w in want["losses"].items():
        np.testing.assert_allclose(float(out["losses"][name]), float(w),
                                   rtol=2e-5, atol=2e-5, err_msg=name)
    np.testing.assert_array_equal(out["pred_valid"].numpy(),
                                  np.asarray(want["pred_valid"]))
    np.testing.assert_array_equal(out["classes_pred"].numpy(),
                                  np.asarray(want["classes_pred"]))
    np.testing.assert_allclose(out["boxes_pred"].numpy(),
                               np.asarray(want["boxes_pred"]), rtol=1e-4,
                               atol=1e-4)
    after = model.state_dict()
    assert all(torch.equal(before[k], after[k]) for k in before)
    boxes, scores, labels, valid = predict_step(state, batch["image"])
    assert boxes.shape == (2, 8, 4) and not model.training


def test_two_accumulation_cycles_match_optax(pair):
    """Four ``train_step`` micro-steps with ``grad_accum_steps=2`` against
    the JAX package's ``make_optimizer`` (AdamW + cosine + MultiSteps),
    which the test drives with the port's own micro-gradients so that both
    optimisers see the same numbers: the parameters stay put after micro-
    steps 1 and 3 and equal optax's after 2 and 4, within 1e-5 + 1e-5 * |p|
    (a hundredth of one step of ``lr``); the running statistics move at
    every micro-step.  Where two micro-gradients cancel to something as
    small as AdamW's ``eps``, the direction ``m / (sqrt(v) + eps)`` turns
    the rounding of their mean (a sum halved here, a running mean in optax)
    into a different step of up to ``lr``: at most one element in 10,000 of
    a leaf (or two elements) may do that, and none may differ by more than
    two steps of ``lr``."""
    rng = np.random.RandomState(3)
    batches = [_batch(rng) for _ in range(4)]
    model = pair.port_model()
    opt, lr_of = make_optimizer(pair.cfg, model.parameters(), STEPS_PER_EPOCH)
    state = TrainState(pair.cfg, model, opt, lr_of)
    tx = j_make_optimizer(pair.jcfg, STEPS_PER_EPOCH)
    j_params = jax.tree.map(jnp.asarray, pair.params)
    opt_state = tx.init(j_params)
    apply = jax.jit(lambda g, s, p: (lambda u, s2: (optax.apply_updates(p, u),
                                                    s2))(*tx.update(g, s, p)))
    for i, batch in enumerate(batches):
        # the micro-gradient the port is about to compute, on a copy
        twin = copy.deepcopy(model)
        twin.zero_grad(set_to_none=True)
        t = {k: torch.from_numpy(v) for k, v in batch.items()}
        twin.train_forward(t["image"], t["boxes"], t["labels"],
                           t["valid"])["losses"]["total"].backward()
        micro, _ = to_jax_variables(twin, grads=True)
        j_params, opt_state = apply(jax.tree.map(jnp.asarray, micro),
                                    opt_state, j_params)

        p_before, s_before = to_jax_variables(model)
        state, losses = train_step(state, batch)
        assert all(np.isfinite(float(v)) for v in losses.values())
        p_after, s_after = to_jax_variables(model)
        assert state.step == i + 1 and state.updates == (i + 1) // 2
        want = dict(_leaves(jax.tree.map(np.asarray, j_params)))
        for name, got in _leaves(p_after):
            if i % 2 == 0:
                np.testing.assert_array_equal(
                    got, dict(_leaves(p_before))[name], err_msg=name)
            diff = np.abs(got - want[name])
            off = diff > 1e-5 + 1e-5 * np.abs(want[name])
            assert off.sum() <= max(2, 1e-4 * off.size), (name, i, off.sum())
            assert diff.max() <= 2.1 * pair.cfg.lr, (name, i, diff.max())
        assert any(not np.array_equal(a, b) for (_, a), (_, b)
                   in zip(_leaves(s_before), _leaves(s_after)))
    changed = sum(int(not np.array_equal(a, b)) for (_, a), (_, b) in zip(
        _leaves(p_after), _leaves(pair.params)))
    assert changed == len(list(_leaves(pair.params)))


def test_learning_rate_schedule_matches_optax():
    """The rate of update 0 (the full ``lr``), 1, ``t_max`` (0) and
    ``t_max + 1`` (climbing back) equals the JAX package's, read off its
    optimiser on a one-element tree with a constant gradient of 1 and no
    weight decay (AdamW's direction is then exactly 1)."""
    kw = dict(COMMON, lr=2e-3, weight_decay=0.0)
    _, lr_of = make_optimizer(Config(**kw, device="cpu"),
                              [torch.nn.Parameter(torch.zeros(1))],
                              STEPS_PER_EPOCH)
    tx = j_make_optimizer(JConfig(**kw), STEPS_PER_EPOCH)
    p = {"w": jnp.zeros(1)}
    s = tx.init(p)
    rates = []
    for i in range(2 * 12):
        u, s = tx.update({"w": jnp.ones(1)}, s, p)
        if i % 2:
            rates.append(-float(u["w"][0]))     # the cycle's one update
        else:
            assert float(u["w"][0]) == 0.0
    for t in (0, 1, 10, 11):
        np.testing.assert_allclose(lr_of(t), rates[t], rtol=1e-5, atol=1e-9,
                                   err_msg=f"update {t}")
    assert lr_of(0) == 2e-3 and lr_of(10) < 1e-12 and lr_of(11) > 1e-5


def test_train_state_surface_and_unported_options():
    """``create_train_state`` builds the model in eval mode on the device
    asked for, seeded; ``train_step`` takes u8 images and a generator, and
    with ``device_augment`` augments on the device and takes a finite step
    (``tests/test_torch_device_transforms.py`` holds it against JAX)."""
    cfg = Config(**MODELS["single_scale"], device="cpu")
    model, state = create_train_state(cfg, seed=3, steps_per_epoch=4,
                                      init_image_size=(64, 64))
    again, _ = create_train_state(cfg, seed=3)
    other, _ = create_train_state(cfg, seed=4)
    assert not model.training and state.model is model and state.step == 0
    assert torch.equal(model.roi_head.score.weight, again.roi_head.score.weight)
    assert not torch.equal(model.roi_head.score.weight,
                           other.roi_head.score.weight)
    batch = _batch(np.random.RandomState(5))
    batch["image"] = np.round(batch["image"] * 255).astype(np.uint8)
    gen = torch.Generator().manual_seed(0)
    state, losses = train_step(state, batch, generator=gen)
    assert model.training and np.isfinite(float(losses["total"]))
    assert set(losses) == {"rpn_loc", "rpn_cls", "roi_loc", "roi_cls", "total"}
    state, aug_losses = train_step(state, batch, generator=gen,
                                   device_augment=True)
    assert np.isfinite(float(aug_losses["total"])) and state.step == 2
    params, stats = to_jax_variables(model)
    twin, _ = create_train_state(cfg, seed=9)
    load_jax_variables(twin, params, stats)
    assert all(torch.equal(a, b) for a, b in zip(model.state_dict().values(),
                                                 twin.state_dict().values()))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        create_train_state(Config(**MODELS["single_scale"]))


@pytest.mark.parametrize("kw", [dict(remat_backbone=True),
                                dict(freeze_bn=True),
                                dict(backbone="hardnet85")])
def test_train_options(kw):
    """``remat_backbone`` gives the gradients and running statistics of the
    plain run (each block's second forward leaves the statistics alone);
    ``freeze_bn`` keeps the trunk's statistics and still trains its weights;
    HarDNet-85 drops activations from the generator in train mode only."""
    cfg = Config(**{**MODELS["single_scale"], **kw}, device="cpu")
    batch = {k: torch.from_numpy(v)
             for k, v in _batch(np.random.RandomState(6)).items()}

    def run(c, generator=None):
        m = FasterRCNN(c, device="cpu", seed=0)
        out = m.train_forward(batch["image"], batch["boxes"], batch["labels"],
                              batch["valid"], generator=generator)
        out["losses"]["total"].backward()
        return m, out

    model, out = run(cfg, torch.Generator().manual_seed(1))
    assert np.isfinite(float(out["losses"]["total"]))
    fresh = FasterRCNN(cfg, device="cpu", seed=0)
    stats = {n: b for n, b in model.named_buffers() if "running" in n}
    moved = [not torch.equal(b, dict(fresh.named_buffers())[n])
             for n, b in stats.items()]
    if "remat_backbone" in kw:
        plain, _ = run(cfg.replace(remat_backbone=False),
                       torch.Generator().manual_seed(1))
        for (n, p), q in zip(model.named_parameters(), plain.parameters()):
            assert torch.equal(p.grad, q.grad), n
        for (n, b), c in zip(model.named_buffers(), plain.buffers()):
            assert torch.equal(b, c), n
        assert all(moved)
    elif "freeze_bn" in kw:
        assert not any(moved) and not model.extractor.training
        assert model.extractor.stem0.conv.weight.grad.abs().max() > 0
    else:
        other, _ = run(cfg, torch.Generator().manual_seed(2))
        assert not torch.equal(model.roi_head.score.weight.grad,
                               other.roi_head.score.weight.grad)
        with torch.no_grad():
            a = model.set_mode(False).features(batch["image"])
            b = model.features(batch["image"], torch.Generator().manual_seed(5))
        assert torch.equal(a, b)
