"""PyTorch port, the Swin-T trunk (``models/swin.py``) and Swin-T Mask R-CNN
on the CPU, against the benchmark's plain reference
(``port_bench/reference/swin.py``, ``swin_mask_rcnn.py``) on seeded
weights: a plain and a shifted block, patch merging, the trunk's taps,
predict, one training step, the mask cache, the spans and counters, the
routes that refuse the trunk, the published state-dict names, export, the
FLOP counts and the benchmark cell at a tiny size.

Both sides run float32 on the CPU.  The port computes attention through
``F.scaled_dot_product_attention`` on tokens ``[B, H, W, C]``, the
reference writes ``softmax(q k^T * scale + B + M) v`` out on token
sequences, as the published code does: the two sum in other orders, so
they agree to a few float32 roundings of each tensor's largest magnitude
(``REL``, 2e-5 of it; the largest gaps read 1e-6-5e-6 of it).  A bfloat16
LayerNorm or softmax is off by 2^-9 of the magnitude (2e-3), a hundred
times that; dropping the shift mask or the bias moves a block's output by
more than a tenth of its magnitude (asserted below on the block's own
weights), so each of those fails the block tests.
"""

import os
import sys
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from port_bench import counts_swin, harness  # noqa: E402
from port_bench.reference import config as ref_config  # noqa: E402
from port_bench.reference import swin as ref_swin  # noqa: E402
from port_bench.reference.mask_rcnn import init_mask_head  # noqa: E402
from port_bench.reference.swin_mask_rcnn import (  # noqa: E402
    init_swin_detector, swin_detector)
from port_bench.runner import Run  # noqa: E402
from tests.bench_ticks import ticking_driver  # noqa: E402
from two_stage_object_detection_tpu_torch.config import Config  # noqa: E402
from two_stage_object_detection_tpu_torch.models import swin  # noqa: E402
from two_stage_object_detection_tpu_torch.models.registry import (  # noqa: E402
    build_backbone)
from two_stage_object_detection_tpu_torch.nets.detector import (  # noqa: E402
    FasterRCNN)
from two_stage_object_detection_tpu_torch.utils.profiling import (  # noqa: E402
    counters)

REL = 2e-5
KW = dict(fpn=True, backbone="swin_t", input_size=(64, 96), num_classes=3,
          max_detections=5, compute_dtype="float32", n_train_pre_nms=256,
          n_train_post_nms=64, n_test_pre_nms=128, n_test_post_nms=32,
          roi_n_sample=16, rpn_n_sample=32, max_gt_boxes=4,
          loc_normalize=True, grad_accum_steps=1, fpn_channels=32,
          fpn_fc_dim=64)
MASK_KW = dict(mask_roi_size=14, mask_dim=16, mask_convs=2)
IMG = (64, 96)


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _close(got, want, rel=REL):
    scale = max(float(want.abs().max()), 1e-6)
    err = float((got.float() - want.float()).abs().max())
    assert err <= rel * scale, (err, scale)


def _ref_config(**kw):
    names = {f.name for f in ref_config.dataclasses.fields(ref_config.Config)}
    return ref_config.Config(**{k: v for k, v in {**KW, **kw}.items()
                                if k in names})


def _peaky(module, seed):
    """Draw every parameter of ``module`` so that attention is peaked and
    the bias matters: linear weights of std 0.25 (attention logits of std
    ~4 at 64 channels), bias tables of std 2, LayerNorm affine near 1 and
    0, biases of std 0.1."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            if name.endswith("relative_position_bias_table"):
                p.copy_(torch.randn(p.shape, generator=g) * 2.0)
            elif p.dim() == 2:
                p.copy_(torch.randn(p.shape, generator=g) * 0.25)
            elif "norm" in name and name.endswith("weight"):
                p.copy_(1.0 + 0.1 * torch.randn(p.shape, generator=g))
            else:
                p.copy_(0.1 * torch.randn(p.shape, generator=g))


# ------------------------------------------------------------ the blocks
@pytest.mark.parametrize("shift", [0, 3])
def test_block_matches_reference(shift):
    """One plain and one shifted block on a 10x12 token grid (padded to
    14x14: the pad, the roll and the mask all act), 64 channels, 2 heads."""
    h, w, c = 10, 12, 64
    ref = ref_swin.SwinTransformerBlock(c, 2, 7, shift, 4, torch.float32)
    _peaky(ref, 3 + shift)
    port = swin.SwinBlock(c, 2, 7, shift, 4, torch.float32)
    port.load_state_dict(ref.state_dict())
    x = torch.randn(2, h, w, c, generator=torch.Generator().manual_seed(5))
    stage = ref_swin.BasicLayer(c, 2, 2, 7, 4, False, torch.float32)
    mask = stage.attn_mask(h, w, "cpu")
    with torch.no_grad():
        want = ref(x.reshape(2, h * w, c), h, w, mask).reshape(2, h, w, c)
        got = port(x)
        _close(got, want)
        # what the tolerance rules out: the bias, and in a shifted block
        # the shift mask, each move the output by over a tenth of its
        # magnitude
        scale = float(want.abs().max())
        table = ref.attn.relative_position_bias_table
        kept = table.clone()
        table.zero_()
        no_bias = ref(x.reshape(2, h * w, c), h, w, mask).reshape(2, h, w, c)
        table.copy_(kept)
        assert float((no_bias - want).abs().max()) > 0.1 * scale
        if shift:
            no_mask = ref(x.reshape(2, h * w, c), h, w,
                          torch.zeros_like(mask)).reshape(2, h, w, c)
            assert float((no_mask - want).abs().max()) > 0.1 * scale


def test_patch_merging_at_odd_sides():
    """5x7 tokens: padded to 6x8, gathered (0, 0), (1, 0), (0, 1), (1, 1),
    normed and reduced as published; the pad counted in
    ``swin.pad_tokens``."""
    ref = ref_swin.PatchMerging(8, torch.float32)
    _peaky(ref, 11)
    port = swin.PatchMerging(8, torch.float32)
    port.load_state_dict(ref.state_dict())
    x = torch.randn(2, 5, 7, 8, generator=torch.Generator().manual_seed(2))
    counters.clear()
    with torch.no_grad():
        got = port(x)
        want = ref(x.reshape(2, 35, 8), 5, 7).reshape(2, 3, 4, 16)
    _close(got, want)
    assert counters["swin.pad_tokens"] == 2 * (6 * 8 - 5 * 7)
    # the gather's order: the token at (row 1, column 0) of each 2x2 is the
    # second group of channels
    probe = torch.zeros(1, 2, 2, 8)
    probe[0, 1, 0] = 1.0
    with torch.no_grad():
        port.norm.weight.fill_(1.0)
        port.norm.bias.zero_()
        port.reduction.weight.copy_(torch.eye(16, 32))
        out = port(probe)
    assert int(out[0, 0, 0].argmax()) == 8


def _trunks(seed=0):
    ref = ref_swin.SwinFeatureExtraction(**ref_swin.SWIN_T)
    ref_swin.init_swin(ref, seed)
    port, channels = build_backbone("swin_t", torch.float32, pyramid=True)
    port.load_state_dict(ref.state_dict())
    return port, ref, channels


def test_trunk_taps_match_reference():
    """The Swin-T trunk at its published widths on a 62x90 image: the
    patch embedding pads to 64x92, stage 1 is 16x23 tokens (padded to 21x28
    in each block, its odd side padded by the merging), then 8x12, 4x6 and
    2x3; the four taps NCHW, 96-768 wide."""
    port, ref, channels = _trunks()
    assert channels == (96, 192, 384, 768)
    x = torch.rand(2, 3, 62, 90, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        got, want = port(x), ref(x)
    assert [tuple(t.shape) for t in got] == [
        (2, 96, 16, 23), (2, 192, 8, 12), (2, 384, 4, 6), (2, 768, 2, 3)]
    for g, r in zip(got, want):
        _close(g, r)


def test_single_scale_swin_raises():
    with pytest.raises(ValueError, match="FPN only"):
        build_backbone("swin_t", pyramid=False)
    with pytest.raises(ValueError, match="FPN only"):
        FasterRCNN(Config(**{**KW, "fpn": False}, device="cpu"))


# ------------------------------------------------------------- detector
def _models(mask: bool = True, seed: int = 7):
    """``(port, reference)``: the reference's seeded weights (the trunk as
    published, the rest as the benchmark draws it; with ``mask`` the mask
    head from ``seed + 2``, its predictor scaled by 4 so that masks span
    (0, 1)) loaded into the port."""
    ref = swin_detector(_ref_config(), "cpu", MASK_KW if mask else None)
    init_swin_detector(ref, seed, seed + 1)
    if mask:
        init_mask_head(ref.mask_head, seed + 2)
        with torch.no_grad():
            ref.mask_head.predictor.weight.mul_(4.0)
    kw = {**KW, **MASK_KW, "mask_head": True} if mask else KW
    port = FasterRCNN(Config(**kw, device="cpu"))
    port.load_state_dict(ref.state_dict())
    return port, ref


@pytest.fixture(scope="module")
def images():
    return torch.rand(2, *IMG, 3, generator=torch.Generator().manual_seed(3))


def test_mask_rcnn_predict_matches_reference(images):
    """``predict`` of a tiny ``swin_t`` Mask R-CNN: the same detections
    (valid slots and labels exactly, boxes and masks to ``REL`` of their
    largest magnitude)."""
    port, ref = _models()
    got = port.predict(images)
    want = ref.predict(images)
    assert len(got) == 5
    boxes, _, labels, valid, masks = got
    assert int(valid.sum()) > 0
    assert torch.equal(valid, want[3])
    assert torch.equal(labels.long(), want[2].long())
    _close(boxes, want[0])
    _close(masks, want[4])


def test_train_forward_matches_reference(images):
    """One ``train_forward`` of a tiny ``swin_t`` Faster R-CNN (first-k
    sampling on both sides) and its backward: every loss to ``REL``, every
    trunk gradient leaf to 1e-4 of its largest magnitude (the gradient sums
    the forward's rounding over the batch's tokens: 1e-6-2e-5 read).  The
    bias tables train: their gradient is not zero."""
    port, ref = _models(mask=False)
    gt_boxes = torch.tensor([[[5.0, 6.0, 40.0, 50.0], [50.0, 10.0, 90.0, 40.0]],
                             [[10.0, 20.0, 30.0, 60.0], [0.0, 0.0, 0.0, 0.0]]])
    gt_labels = torch.tensor([[0, 2], [1, 0]])
    gt_valid = torch.tensor([[True, True], [True, False]])
    counters.clear()
    out = port.train_forward(images, gt_boxes, gt_labels, gt_valid)
    want = ref.train_forward(images, gt_boxes, gt_labels, gt_valid)
    for k in ("rpn_loc", "rpn_cls", "roi_loc", "roi_cls", "total"):
        _close(out["losses"][k].detach(), want["losses"][k].detach())
    out["losses"]["total"].backward()
    want["losses"]["total"].backward()
    # the masks are built inside the graph on every training call
    assert counters["swin.mask_build"] == 12
    grads = dict(ref.named_parameters())
    n = 0
    for name, p in port.named_parameters():
        if not name.startswith("extractor."):
            continue
        g_ref = grads[name].grad
        assert p.grad is not None, name
        _close(p.grad, g_ref, 1e-4)
        n += 1
    assert n == len(list(port.extractor.parameters()))
    table = port.extractor.layers[0].blocks[1].attn.relative_position_bias_table
    assert float(table.grad.abs().max()) > 0


def test_mask_cache_and_counters(images):
    """``swin.mask_build`` counts the 12 blocks' masks on the first
    predict and 0 on the second; a table changed in place (as
    ``load_state_dict`` or an optimiser step changes it) is rebuilt.
    ``swin.windows`` counts windows on the padded grids (64x96 -> stage
    grids 16x24, 8x12, 4x6, 2x3, each one window row and 1-4 columns
    padded up), ``swin.pad_tokens`` the tokens padded."""
    port, _ = _models(mask=False)
    counters.clear()
    port.predict(images)
    assert counters["swin.mask_build"] == 12
    windows = 2 * (2 * (3 * 4) + 2 * (2 * 2) + 6 * 1 + 2 * 1)
    assert counters["swin.windows"] == windows
    pad = 2 * (2 * (21 * 28 - 16 * 24) + 2 * (14 * 14 - 8 * 12)
               + 6 * (7 * 7 - 4 * 6) + 2 * (7 * 7 - 2 * 3))
    assert counters["swin.pad_tokens"] == pad
    counters.clear()
    port.predict(images)
    assert counters["swin.mask_build"] == 0
    attn = port.extractor.layers[2].blocks[3].attn
    with torch.no_grad():
        attn.relative_position_bias_table.add_(1.0)
    counters.clear()
    port.predict(images)
    assert counters["swin.mask_build"] == 1


def test_window_attention_span(images):
    """Each block's attention, from the partition to the reverse, is the
    span ``tsod.window_attention`` while a profiler records."""
    port, _ = _models(mask=False)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        port.predict(images[:1])
    n = sum(e.count for e in prof.key_averages()
            if e.key == "tsod.window_attention")
    assert n == 12


@pytest.mark.parametrize("route", ["spatial", "int8", "quantized",
                                   "calibrate", "tensor_parallel",
                                   "model_axis"])
@pytest.mark.parametrize("mask", [False, True])
def test_swin_refuses_other_routes(route, mask):
    """The row-shard, int8 and tensor-parallel routes (and a model axis in
    training) raise a ``ValueError`` giving the reason, with or without
    the mask head (which has no such route either, and may be named
    first)."""
    from two_stage_object_detection_tpu_torch import quantize
    from two_stage_object_detection_tpu_torch.nets.trainer import (
        create_train_state)
    from two_stage_object_detection_tpu_torch.parallel import mesh, sharding
    from two_stage_object_detection_tpu_torch.serving import Predictor
    kw = {**KW, **MASK_KW, "mask_head": True} if mask else KW
    cfg = Config(**kw, device="cpu")
    match = "mask_head|swin_t" if mask else "swin_t.*no .* route: "
    if route in ("tensor_parallel", "model_axis"):
        model, state = create_train_state(cfg, device="cpu")
    else:
        model = FasterRCNN(cfg)
    with pytest.raises(ValueError, match=match):
        if route == "spatial":
            Predictor(cfg, model, spatial=True)
        elif route == "int8":
            Predictor(cfg, model, int8_scales={"neck/lateral0": 1.0})
        elif route == "quantized":
            with quantize.quantized(model, {"neck/lateral0": 1.0}):
                pass
        elif route == "calibrate":
            quantize.calibrate(model, [])
        elif route == "tensor_parallel":
            sharding.shard_train_state(state, None)
        else:
            fake = SimpleNamespace(group=object(), model_group=object(),
                                   device=model.device, processes=1)
            mesh.place_train_state(state, fake)


# --------------------------------------------------------------- import
def _published(prefix="backbone.", norms=True, seed=4):
    """A state dict with the published detection backbone's names and
    shapes (the reference trunk's, plus its ``relative_position_index``
    buffers, which a published dict holds), seeded values, and a neck key
    the converter does not read."""
    ref = ref_swin.SwinFeatureExtraction(**ref_swin.SWIN_T)
    ref_swin.init_swin(ref, seed)
    sd = {f"{prefix}{k}": v for k, v in ref.state_dict().items()
          if norms or not k.startswith("norm")}
    for name, m in ref.named_modules():
        if isinstance(m, ref_swin.WindowAttention):
            sd[f"{prefix}{name}.relative_position_index"] = (
                m.relative_position_index.clone())
    sd["neck.lateral_convs.0.conv.weight"] = torch.zeros(256, 96, 1, 1)
    if not norms:
        sd["norm.weight"] = torch.ones(768)
        sd["head.weight"] = torch.zeros(1000, 768)
    return sd, ref


@pytest.mark.parametrize("prefix", ["backbone.", ""])
def test_published_swin_names_load(prefix):
    """A detector's dict (``backbone.`` keys) and a bare backbone's load
    into the port's trunk by name, bit for bit; the neck keeps its
    values; the bias-table rows are recomputed, not read."""
    from two_stage_object_detection_tpu_torch.utils import torch_import
    sd, ref = _published(prefix)
    sd[f"{prefix}layers.0.blocks.0.attn.relative_position_index"] = (
        torch.zeros(49, 49, dtype=torch.long))
    port = FasterRCNN(Config(**KW, device="cpu"))
    neck = {k: v.clone() for k, v in port.neck.state_dict().items()}
    torch_import.load_swin_backbone(sd, port)
    for k, v in ref.state_dict().items():
        assert torch.equal(port.extractor.state_dict()[k], v), k
    for k, v in port.neck.state_dict().items():
        assert torch.equal(v, neck[k])
    idx = port.extractor.layers[0].blocks[0].attn.relative_position_index
    assert torch.equal(idx, swin.relative_position_index(7))


def test_imagenet_swin_dict_loads_with_fresh_output_norms():
    """An ImageNet classifier's dict has no ``norm0..norm3``: they start at
    1 and 0; its ``norm`` and ``head`` are not read."""
    from two_stage_object_detection_tpu_torch.utils import torch_import
    sd, _ = _published("", norms=False)
    port = FasterRCNN(Config(**KW, device="cpu"))
    with torch.no_grad():
        port.extractor.norm2.weight.fill_(3.0)
    torch_import.load_swin_backbone(sd, port)
    assert torch.equal(port.extractor.norm2.weight, torch.ones(384))
    assert torch.equal(port.extractor.norm3.bias, torch.zeros(768))


def test_published_swin_dict_errors_name_the_key():
    from two_stage_object_detection_tpu_torch.utils import torch_import
    port = FasterRCNN(Config(**KW, device="cpu"))
    sd, _ = _published()
    del sd["backbone.layers.2.blocks.5.mlp.fc2.weight"]
    with pytest.raises(KeyError, match="layers.2.blocks.5.mlp.fc2.weight"):
        torch_import.load_swin_backbone(sd, port)
    sd, _ = _published()
    sd["backbone.layers.1.downsample.reduction.weight"] = torch.zeros(1, 1)
    with pytest.raises(ValueError, match="layers.1.downsample.reduction"):
        torch_import.load_swin_backbone(sd, port)


# --------------------------------------------------------------- export
def test_export_matches_eager(tmp_path, images):
    """``serving.export_program`` takes the roll, the padding and SDPA: the
    portable program of a tiny ``swin_t`` Faster R-CNN gives eager's
    detections bit for bit, and the tracing leaves no mask cached."""
    from two_stage_object_detection_tpu_torch.serving import (
        export_program, load_exported)
    port, _ = _models(mask=False)
    cfg = Config(**KW, device="cpu")
    export_program(cfg, port, str(tmp_path / "swin.pt2"), batch_size=2,
                   portable=False)
    assert not any(m.__dict__.get("_mask_cache")
                   for m in port.modules()
                   if isinstance(m, swin.WindowAttention))
    run = load_exported(str(tmp_path / "swin.pt2"))
    got = run(images)
    want = port.predict(images)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


# --------------------------------------------------------------- counts
def test_flops_at_the_published_widths():
    """At 800x1088 the trunk takes 161.87 GFLOP an image (the hand count:
    blocks 155.3, patch merging 6.0, the embedding 0.5), the attention core
    5.26 of it; the served model 472.9 with the mask head's 106.0."""
    rcfg = ref_config.Config(fpn=True, backbone="swin_t",
                             input_size=(800, 1088), num_classes=80,
                             n_test_post_nms=1000, max_detections=100)
    grids = counts_swin.stage_grids((800, 1088))
    assert grids == [(200, 272), (100, 136), (50, 68), (25, 34)]
    hand = 2.0 * 200 * 272 * 48 * 96                 # the embedding
    for i, ((h, w), depth) in enumerate(zip(grids, (2, 2, 6, 2))):
        c = 96 * 2 ** i
        hp, wp = -(-h // 7) * 7, -(-w // 7) * 7
        block = (2.0 * hp * wp * c * 4 * c            # qkv and proj
                 + 4.0 * hp * wp * 49 * c             # q k^T and attn v
                 + 2.0 * h * w * c * 8 * c)           # fc1 and fc2
        hand += depth * block
        if i < 3:
            hand += 2.0 * (h // 2) * (w // 2) * 4 * c * 2 * c
    trunk = counts_swin.trunk_flops(rcfg)
    assert trunk == pytest.approx(hand, rel=1e-9)
    assert trunk == pytest.approx(161.87e9, rel=1e-4)
    core = sum(counts_swin.attention_work(c, 1)[0]
               for c in counts_swin.attention_calls((800, 1088)))
    assert core == pytest.approx(5.257e9, rel=1e-3)
    total = counts_swin.model_flops(
        rcfg, dict(mask_roi_size=14, mask_dim=256, mask_convs=4))
    assert total == pytest.approx(472.86e9, rel=1e-4)


# ------------------------------------------------------------ the cell
def test_benchmark_cell_runs_tiny_on_the_cpu():
    """The new cell's driver at a tiny size on the CPU, Swin-T at its
    published widths: requests served, the boxes and the masks compared
    with the Swin reference, ``correct``.  Both sides compute in float32,
    so ``miss_share`` is the scores' float32 rounding (2e-6 read; under
    1e-4) and ``mask_gap`` the float16 wire's rounding alone (2^-12 a bin
    over a mean ``|p_ref - 0.5|`` near 0.25: under 2e-3).  The driver's clock
    ticks (``tests/bench_ticks.py``), so its window holds 4 requests
    whatever the load."""
    cell = harness.Cell(ROOT, "mask_swin_t.serve.u8_bulk64_swin_masks")
    cell.traffic = {**cell.traffic, "images_per_request": 4,
                    "pool_requests": 2, "check_images": 4,
                    "batch_sizes": [1, 2]}
    tiny = dict(input_size=IMG, num_classes=3, n_test_pre_nms=64,
                n_test_post_nms=16, max_detections=8, compute_dtype="float32",
                fpn_channels=32, mask_dim=16, fpn_fc_dim=64)
    run = Run(ROOT, cell, 2 ** 33 + 7, 2.0, 0, time.time(), "cpu",
              overrides=tiny)
    res = ticking_driver(cell, run.seconds, 4).drive(run)
    assert res["correct"] and res["attempted"] == 4
    assert set(res["checks"]) == {"miss_share", "mask_gap"}
    assert res["checks"]["miss_share"]["value"] <= 1e-4
    assert res["checks"]["mask_gap"]["value"] <= 2e-3
    assert res["metrics"]["serve_img_per_s"] > 0
    assert np.isfinite(res["metrics"]["setup_s"])
