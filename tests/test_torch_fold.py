"""PyTorch port, the backbones' folded predict route on the CPU
(``models/layers.py``: ``fold_route``, ``fold_norm``, ``cached_fold``).

Each module's folded function, called directly, with the epilogue's plain
version (``ops/conv_epilogue.py``) in float32, against the module's own
forward; when the route engages and when it falls back, read from
``utils.profiling.counters``; and the cache's rebuilds after each event
that changes a folded tensor's sources.  HarDNet's store route (each
depth-wise conv stored into every buffer that reads it,
``ops/depthwise_store.py``'s plain version here) against its ``torch.cat``
route, and its destination tables against ``torch.cat``'s channel order.
The kernels themselves are held in ``tests/test_torch_kernels.py`` on the
card.
"""

import threading
import types
from unittest import mock

import pytest
import torch

from two_stage_object_detection_tpu_torch import quantize
from two_stage_object_detection_tpu_torch.config import Config
from two_stage_object_detection_tpu_torch.models import hardnet, resnet
from two_stage_object_detection_tpu_torch.models.hardnet import (
    CombConvLayer, ConvLayer, DWConvLayer, HarDBlock, HarDNetFeatureExtraction)
from two_stage_object_detection_tpu_torch.models import layers
from two_stage_object_detection_tpu_torch.models.layers import (
    BatchNorm, fold_route, init_weights)
from two_stage_object_detection_tpu_torch.models.resnet import (
    BasicBlock, Bottleneck, ResNetFeatureExtraction)
from two_stage_object_detection_tpu_torch.nets.detector import FasterRCNN
from two_stage_object_detection_tpu_torch.ops.depthwise_store import (
    depthwise_conv_reference, depthwise_store)
from two_stage_object_detection_tpu_torch.parallel import spatial
from two_stage_object_detection_tpu_torch.utils.profiling import counters


def _randomise(module, seed=0):
    """Seeded weights, batch-norm scales, shifts and running statistics
    away from 1 / 0, and PReLU slopes of 0.2, so that no fold is the
    identity; eval mode."""
    gen = torch.Generator().manual_seed(seed)
    init_weights(module, gen)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, BatchNorm):
                c = m.weight.shape[0]
                m.weight.copy_(torch.rand(c, generator=gen) + 0.5)
                m.bias.copy_(torch.randn(c, generator=gen) * 0.3)
                m.running_mean.copy_(torch.randn(c, generator=gen) * 0.3)
                m.running_var.copy_(torch.rand(c, generator=gen) * 1.5 + 0.5)
            elif type(m).__name__ == "PReLU":
                m.weight.fill_(0.2)
    return module.eval()


def _resnet_stem(m, x):
    return m._stem_folded(x), m.relu(m.bn1(m.conv1(x)))


def _route_passed(m):
    """The trunk's route check passed, as on a CUDA tensor, while inside:
    its folded route on the CPU.  Enter it from one thread only:
    ``mock.patch`` is not thread-safe, and two threads' patches can restore
    each other's, leaving the check passed for the rest of the process."""
    module = hardnet if isinstance(m, HarDNetFeatureExtraction) else resnet
    return mock.patch.object(module, "fold_route", lambda trunk, x: True)


def _folded_trunk(m, x):
    with _route_passed(m):
        return m(x)


def _trunk_case(m, x):
    return _folded_trunk(m, x), m(x)


# name: (module, input channels, folded and unfolded outputs of (m, x));
# a deferred bias is added to the folded output, a pending one to x
CASES = {
    "ConvLayer 3x3 s2": (lambda: ConvLayer(6, 10, 3, 2), 6,
                         lambda m, x: (m._folded(x), m(x))),
    "ConvLayer 1x1, input bias pending": (
        lambda: ConvLayer(6, 10, 1), 6,
        lambda m, x: (m._folded(x, _pending(6)),
                      m(x + _pending(6)[:, None, None]))),
    "DWConvLayer, bias added": (lambda: DWConvLayer(10, 2), 10,
                                lambda m, x: (m._folded(x)[0], m(x))),
    "DWConvLayer, bias deferred": (lambda: DWConvLayer(10), 10,
                                   lambda m, x: (_plus(*m._folded(
                                       x, defer=True)), m(x))),
    "CombConvLayer": (lambda: CombConvLayer(6, 12), 6,
                      lambda m, x: (_plus(*m._run_folded(
                          x, m._fold(_pending(6)))),
                                    m(x + _pending(6)[:, None, None]))),
    "HarDBlock": (lambda: HarDBlock(12, 6, 1.6, 8), 12,
                  lambda m, x: (_plus(*m._folded(x, _pending(12))),
                                m(x + _pending(12)[:, None, None]))),
    "Bottleneck": (lambda: Bottleneck(32, 8), 32,
                   lambda m, x: (m._folded(x), m(x))),
    "Bottleneck with downsample": (lambda: Bottleneck(16, 8, 2, True), 16,
                                   lambda m, x: (m._folded(x), m(x))),
    "BasicBlock": (lambda: BasicBlock(8, 8), 8,
                   lambda m, x: (m._folded(x), m(x))),
    "BasicBlock with downsample": (lambda: BasicBlock(8, 16, 2, True), 8,
                                   lambda m, x: (m._folded(x), m(x))),
    "ResNet stem": (lambda: ResNetFeatureExtraction("basic", (1,)), 3,
                    _resnet_stem),
    "HarDNet-39 trunk": (lambda: HarDNetFeatureExtraction(39), 3,
                         _trunk_case),
    "HarDNet-39 pyramid": (lambda: HarDNetFeatureExtraction(
        39, strided=True, pyramid=True), 3, _trunk_case),
    "HarDNet-68 trunk": (lambda: HarDNetFeatureExtraction(68), 3,
                         _trunk_case),
    "ResNet pyramid trunk": (lambda: ResNetFeatureExtraction(
        "bottleneck", (1, 2, 1), pyramid=True), 3, _trunk_case),
}


def _pending(c):
    return torch.linspace(-0.5, 0.7, c)


def _plus(y, pending):
    return y if pending is None else y + pending[:, None, None]


@pytest.mark.parametrize("case", sorted(CASES))
def test_folded_route_matches_the_modules(case):
    """The folded function of each module type, with batch norm folded
    into the conv weights (and a depth-wise bias deferred into the 1x1
    convs after it where it is), equals the module's forward in float32
    within 1e-5 of the output's largest magnitude."""
    make, c, run = CASES[case]
    m = _randomise(make())
    x = torch.randn(2, c, 32, 24, generator=torch.Generator().manual_seed(1))
    with torch.inference_mode():
        got, want = run(m, x)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert float((g - w).abs().max()) <= 1e-5 * float(w.abs().max())


class _Predict(torch.nn.Module):
    def __init__(self, trunk):
        super().__init__()
        self.trunk = trunk

    @torch.inference_mode()
    def forward(self, x):
        return self.trunk(x)


def _trunk(kind):
    if kind == "hardnet":
        return _randomise(HarDNetFeatureExtraction(39))
    return _randomise(ResNetFeatureExtraction("bottleneck", (1, 1)))


@pytest.mark.parametrize("kind", ["hardnet", "resnet"])
@pytest.mark.parametrize("reason", ["train", "grad", "freeze_bn", "compile",
                                    "spatial", "int8", "hooks", "cpu"])
def test_fold_route_falls_back(kind, reason):
    """The trunk's forward takes the unfolded route and counts its reason,
    and no folded call, in train mode, with gradients on, in a
    ``freeze_bn`` training forward (eval-mode trunk, gradients on), with
    ``quantize.quantized`` convs, under ``quantize.calibrate``'s hooks, and
    on the CPU: there, with every other condition met, the route would
    engage on a CUDA tensor.  ``torch.export`` of a predict (inference mode
    inside) traces the unfolded route too.  A row shard is no reason: on
    one, the CPU tensor is what keeps the route unfolded."""
    m = _trunk(kind)
    x = torch.randn(1, 3, 64, 64, generator=torch.Generator().manual_seed(2))
    counted = {"freeze_bn": "grad", "spatial": "cpu"}.get(reason, reason)
    counters.clear()
    if reason == "train":
        m.train()
        with torch.no_grad():
            m(x)
    elif reason == "grad":
        m(x)
    elif reason == "freeze_bn":
        cfg = Config(input_size=(64, 64), num_classes=3, freeze_bn=True,
                     compute_dtype="float32",
                     **({} if kind == "hardnet" else
                        {"backbone": "resnet10", "backbone_channels": 256}))
        model = FasterRCNN(cfg, device="cpu").set_mode(True)
        assert not model.extractor.training
        model.features(x.permute(0, 2, 3, 1))
    elif reason == "compile":
        torch.export.export(_Predict(m), (x,), strict=False)
    elif reason == "spatial":
        shard = spatial.Shard(spatial.ThreadGroup(1).transport(0), 64, 64)
        with torch.no_grad(), spatial.sharded(shard):
            m(x)
    elif reason == "int8":
        path = next(iter(quantize.eligible_convs(m)))
        with torch.no_grad(), quantize.quantized(m, {path: 3.0}):
            m(x)
    elif reason == "hooks":
        with torch.no_grad():
            scales = quantize.calibrate(m, [x], method="forward")
        assert scales
    else:
        with torch.no_grad():
            m(x)
    assert counters["fold.folded"] == 0 and counters["fold.epilogue"] == 0
    assert counters[f"fold.fallback.{counted}"] >= 1
    assert sum(v for k, v in counters.items()
               if k.startswith("fold.fallback.")) == counters[
                   f"fold.fallback.{counted}"]


@pytest.mark.parametrize("kind", ["hardnet", "resnet"])
def test_folded_route_on_row_shards_matches_the_whole_map(kind):
    """Two row shards (``parallel/spatial.py``, one thread each) run the
    trunk's folded route, each conv with its folded weight on the shard's
    rows and their halo: the shards' rows of each output, stacked, equal
    the unsharded trunk's unfolded output in float32 within 1e-5 of its
    largest magnitude, and the pairs ran folded (the shards' threads share
    the counter, whose increments two threads may interleave: it reads at
    least one trunk's pairs and at most both).  The route's check is passed
    from this thread, and is the route's own again afterwards."""
    m = _trunk(kind)
    x = torch.randn(1, 3, 64, 64, generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        want = m(x)
    want = want if isinstance(want, tuple) else (want,)
    n, group, got, errors = 2, spatial.ThreadGroup(2), [None] * 2, []

    def work(i):
        try:
            shard = spatial.Shard(group.transport(i), 64, 64)
            with torch.inference_mode(), spatial.sharded(shard):
                out = m(shard.own_rows(x, x))
            got[i] = out if isinstance(out, tuple) else (out,)
        except Exception as e:                             # noqa: BLE001
            errors.append(e)
            group.abort()

    counters.clear()
    threads = [threading.Thread(target=work, args=(i,)) for i in range(n)]
    with _route_passed(m):
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
    assert not errors, errors
    pairs = sum(isinstance(b, BatchNorm) for b in m.modules())
    assert pairs <= counters["fold.folded"] <= n * pairs
    for level, w in enumerate(want):
        g = torch.cat([out[level] for out in got], 2)
        assert g.shape == w.shape
        assert float((g - w).abs().max()) <= 1e-5 * float(w.abs().max())
    # the check is the route's own again for every later test
    assert hardnet.fold_route is fold_route and resnet.fold_route is fold_route


def test_fold_route_engages_only_on_cuda_tensors():
    """With every other condition met, only the device decides: the check
    returns False for a CPU tensor and counts ``cpu``."""
    m = _trunk("resnet")
    counters.clear()
    with torch.inference_mode():
        assert not fold_route(m, torch.zeros(1, 3, 8, 8))
    assert dict(counters) == {"fold.fallback.cpu": 1}


def _change(event, m, x):
    """Change a source of ``m``'s folded tensors as ``event`` does."""
    if event == "load_state_dict":
        other = _randomise(Bottleneck(16, 8, 2, True), seed=5)
        m.load_state_dict(other.state_dict())
    elif event == "optimiser_step":
        opt = torch.optim.SGD(m.parameters(), lr=0.1)
        m(x).square().mean().backward()
        opt.step()
    else:
        m.train()
        with torch.no_grad():
            m(x)
        m.eval()


@pytest.mark.parametrize("event", ["load_state_dict", "optimiser_step",
                                   "train_forward"])
def test_fold_cache_rebuilds_when_its_sources_change(event):
    """The folded tensors are built once and reused; after
    ``load_state_dict``, an optimiser step, or a train-mode forward that
    moves the running statistics, the cache rebuilds once and the folded
    output follows the module's new forward."""
    m = _randomise(Bottleneck(16, 8, 2, True))
    x = torch.randn(2, 16, 16, 12, generator=torch.Generator().manual_seed(3))
    counters.clear()
    with torch.no_grad():
        before = m._folded(x)
        m._folded(x)
    assert counters["fold.rebuild"] == 1
    _change(event, m, x)
    with torch.no_grad():
        got, want = m._folded(x), m(x)
        m._folded(x)
    assert counters["fold.rebuild"] == 2
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
    assert not torch.allclose(got, before)


# ------------------------------------------------------------ store route
def test_depthwise_conv_reference_is_the_conv():
    """The store route's plain depth-wise conv (its own order of taps, in
    float32) equals ``F.conv2d`` in float64 within float32's rounding of
    nine products and a bias, at both strides and on odd map sizes; and
    :func:`depthwise_store` on CPU tensors writes it into each
    destination's channel slice and nothing else."""
    gen = torch.Generator().manual_seed(7)
    for stride, h, w in ((1, 9, 7), (2, 9, 7), (2, 10, 12)):
        x = torch.randn(2, 6, h, w, generator=gen)
        wt = torch.randn(6, 1, 3, 3, generator=gen)
        bias = torch.randn(6, generator=gen)
        got = depthwise_conv_reference(x, wt, stride, bias)
        want = torch.nn.functional.conv2d(x.double(), wt.double(),
                                          bias.double(), stride, 1, 1, 6)
        assert got.dtype == torch.float32 and got.shape == want.shape
        assert float((got - want).abs().max()) <= 1e-5 * float(
            want.abs().max())
        bufs = [torch.full((2, 10, *got.shape[2:]), float("nan"))
                for _ in range(2)]
        depthwise_store(x, wt, stride, bias, [(bufs[0], 0), (bufs[1], 4)])
        assert torch.equal(bufs[0][:, :6], got)
        assert torch.equal(bufs[1][:, 4:], got)
        assert bufs[0][:, 6:].isnan().all() and bufs[1][:, :4].isnan().all()


@pytest.mark.parametrize("args", [(48, 16, 1.6, 4, False),
                                  (96, 20, 1.6, 16, False),
                                  (640, 160, 1.6, 4, False),
                                  (12, 6, 1.7, 8, True),
                                  (24, 24, 1.7, 3, False)])
def test_store_table_follows_torch_cat(args):
    """Each buffer of a block's destination table, filled by storing every
    output into its ``(buffer, channel offset)`` pairs, is ``torch.cat`` of
    the outputs the block route concatenates there: a layer's ``links``
    and the block's kept outputs, in that order; each buffer's first
    source is its lowest, and an output is taken alone exactly where a
    layer's links are that one output."""
    in_ch, gr, grmul, n_layers, keep_base = args
    blk = HarDBlock(in_ch, gr, grmul, n_layers, keep_base=keep_base)
    buffers, dests, alone = blk.stores
    outs = [torch.arange(c, dtype=torch.float32).add(1000 * j)[None, :,
                                                                None, None]
            for j, c in enumerate(blk.out_chs)]
    got = {key: torch.full((1, c, 1, 1), -1.0)
           for key, (c, _) in buffers.items()}
    for j, places in enumerate(dests):
        for key, off in places:
            got[key][:, off:off + blk.out_chs[j]] = outs[j]
    parts = {t: link for t, link in enumerate(blk.links) if len(link) > 1}
    parts["out"] = blk._keep(len(outs))
    assert set(got) == set(parts)
    for key, idx in parts.items():
        assert torch.equal(got[key], torch.cat([outs[j] for j in idx], 1))
        assert buffers[key][1] == min(idx)
    assert alone == [[j] in blk.links for j in range(len(outs))]
    assert buffers["out"][0] == blk.out_channels


def _same_depthwise():
    """Every depth-wise 3x3 :class:`~.layers.Conv` computed as the store
    route's plain version computes it (:func:`depthwise_conv_reference`,
    channels-last like the card's), so that the two routes reach the 1x1
    convs with the same depth-wise values; other convs as they are."""
    conv_forward = layers.Conv.forward

    def forward(conv, x, weight=None):
        w = conv.weight if weight is None else weight
        c = x.shape[1]
        if w.shape[2:] != (3, 3) or conv.groups != c or w.shape[0] != c:
            return conv_forward(conv, x, weight)
        dt = conv.compute_dtype
        bias = None if weight is not None or conv.bias is None else conv.bias
        y = depthwise_conv_reference(x.to(dt), w.to(dt), conv.stride, bias)
        return y.to(dt).contiguous(memory_format=torch.channels_last)

    return mock.patch.object(layers.Conv, "forward", forward)


def _cat_route():
    """The trunk's folded route keeps ``torch.cat``, as under a row shard,
    while every conv runs on the whole map: the trunk's check for a shard
    sees one, :class:`~.layers.Conv`'s sees none."""
    return mock.patch.object(hardnet, "spatial", types.SimpleNamespace(
        current=lambda: object()))


LAYOUTS = {"reference": {}, "strided": {"strided": True},
           "pyramid": {"strided": True, "pyramid": True}}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("arch", [39, 68, 85])
def test_store_route_equals_the_cat_route(arch, layout):
    """HarDNet-39/68/85 in each layout, float32, channels-last: the store
    route's features equal the ``torch.cat`` route's bit for bit when both
    reach the 1x1 convs with the same depth-wise values (each conv's input
    is then the same tensor); the store route stores every depth-wise
    layer once and copies only block inputs that a transition made, into
    each buffer that reads them (none in HarDNet-39); ``hardnet.cat``
    counts the cat route's ``torch.cat``s (20 for HarDNet-39)."""
    cl = torch.channels_last
    m = _randomise(HarDNetFeatureExtraction(arch, **LAYOUTS[layout]))
    m = m.to(memory_format=cl)
    x = torch.randn(1, 3, 64, 64, generator=torch.Generator().manual_seed(8)
                    ).contiguous(memory_format=cl)
    blocks = [getattr(m, f"block{i}") for i in range(m.n_blocks)]
    cats = sum(1 + sum(len(link) > 1 for link in b.links) for b in blocks)
    copies = sum(len(b.stores[1][0]) for i, b in enumerate(blocks)
                 if i and not hasattr(m, f"down{i - 1}"))
    n_dw = sum(isinstance(d, DWConvLayer) for d in m.modules())
    with _route_passed(m), _same_depthwise(), torch.inference_mode(), \
            mock.patch.object(hardnet, "depthwise_store",
                              wraps=depthwise_store) as stored:
        counters.clear()
        got = m(x)
        assert counters["hardnet.cat"] == copies
        assert stored.call_count == n_dw
        with _cat_route():
            counters.clear()
            want = m(x)
        assert counters["hardnet.cat"] == cats
        assert stored.call_count == n_dw
    if arch == 39:
        assert (copies, cats, n_dw) == (0, 20, 36 + (layout == "pyramid"))
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_row_shard_keeps_the_cat_route():
    """On a row shard the folded trunk keeps ``torch.cat`` (its depth-wise
    convs read a halo :class:`~.layers.Conv` exchanges) and stores
    nothing: HarDNet-39 counts its 20 ``torch.cat``s."""
    m = _randomise(HarDNetFeatureExtraction(39))
    x = torch.randn(1, 3, 64, 64, generator=torch.Generator().manual_seed(9))
    shard = spatial.Shard(spatial.ThreadGroup(1).transport(0), 64, 64)
    with _route_passed(m), torch.inference_mode(), spatial.sharded(shard), \
            mock.patch.object(hardnet, "depthwise_store") as stored:
        counters.clear()
        m(x)
    assert counters["hardnet.cat"] == 20 and stored.call_count == 0
    assert counters["fold.folded"] == sum(
        isinstance(b, BatchNorm) for b in m.modules())
