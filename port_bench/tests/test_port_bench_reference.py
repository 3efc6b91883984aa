"""The frozen reference against the port's plain route, at a tiny size.

The reference is the port's plain code, copied: on the CPU, with the same
weights, both give the same predictions and the same losses and
gradients.  The reference imports nothing of the port.
"""

import subprocess
import sys

import pytest
import torch

from bench_tiny import ROOT, TINY
from port_bench.reference import config as rc
from port_bench.reference import detector as rd
from port_bench.reference.layers import init_weights
from two_stage_object_detection_tpu_torch.config import Config
from two_stage_object_detection_tpu_torch.nets.detector import FasterRCNN

MODELS = {"fpn": dict(fpn=True, backbone="resnet10", loc_normalize=True),
          "single": dict()}


def _pair(kind):
    kw = {**TINY, **MODELS[kind]}
    ref = rd.FasterRCNN(rc.Config(**kw))
    init_weights(ref, 3, {"roi_head.score": 3.0})
    prog = FasterRCNN(Config(device="cpu", **kw), device="cpu")
    prog.load_state_dict(ref.state_dict(), strict=True)
    return ref, prog


@pytest.mark.parametrize("kind", sorted(MODELS))
def test_predict_equals_the_port(kind):
    ref, prog = _pair(kind)
    x = torch.rand(2, 64, 64, 3, generator=torch.Generator().manual_seed(0))
    for a, b in zip(ref.predict(x), prog.predict(x)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("kind", sorted(MODELS))
def test_train_forward_and_gradients_equal_the_port(kind):
    ref, prog = _pair(kind)
    x = torch.rand(2, 64, 64, 3, generator=torch.Generator().manual_seed(1))
    boxes = torch.tensor([[[5., 5., 40., 40.], [10, 20, 60, 50],
                           [0, 0, 0, 0], [0, 0, 0, 0]]] * 2)
    labels = torch.tensor([[0, 2, 0, 0]] * 2)
    valid = torch.tensor([[1, 1, 0, 0]] * 2, dtype=torch.bool)
    outs = []
    for m in (ref, prog):
        g = torch.Generator().manual_seed(5)
        out = m.train_forward(x, boxes, labels, valid, generator=g)
        out["losses"]["total"].backward()
        outs.append(({k: v.detach() for k, v in out["losses"].items()},
                     {n: p.grad for n, p in m.named_parameters()}))
    (la, ga), (lb, gb) = outs
    for k in la:
        assert torch.equal(la[k], lb[k]), k
    for n in ga:
        if ga[n] is None:
            assert gb[n] is None
        else:
            assert torch.allclose(ga[n], gb[n], rtol=0, atol=1e-6), n


def test_reference_and_counts_import_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import port_bench.reference.detector, port_bench.reference.trainer\n"
            "import port_bench.reference.wire, port_bench.counts\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0].startswith("
            "'two_stage_object_detection_tpu')))\n") % ROOT
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True)
    assert out.stdout.strip() == "[]"


def test_weights_repeat_from_the_seed_and_the_boost_scales_one_layer():
    kw = {**TINY, **MODELS["single"]}
    a, b, c = (rd.FasterRCNN(rc.Config(**kw)) for _ in range(3))
    init_weights(a, 9)
    init_weights(b, 9)
    init_weights(c, 9, {"roi_head.score": 3.0})
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    for k in sa:
        assert torch.equal(sa[k], sb[k])
        if k == "roi_head.score.weight":
            assert torch.allclose(sc[k], 3.0 * sa[k])
        else:
            assert torch.equal(sa[k], sc[k])
