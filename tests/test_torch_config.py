"""PyTorch port, config: the same fields and defaults as the JAX ``Config``
(except ``device``), the same properties, and ``load_config``."""

import dataclasses
import json

import pytest
import torch

from two_stage_object_detection_tpu.config import Config as JConfig
from two_stage_object_detection_tpu_torch.config import (
    MASK_FIELDS, Config, compute_dtype, load_config, resolve_device,
    use_kernels)


def test_fields_and_defaults_match_jax():
    """Every JAX field, in its order and with its default; then the port's
    own mask fields, last, the branch off."""
    jf = {f.name: f.default for f in dataclasses.fields(JConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(Config)}
    assert list(tf) == list(jf) + list(MASK_FIELDS)
    assert tf["mask_head"] is False
    for name in MASK_FIELDS:
        del tf[name]
    assert {k: v for k, v in tf.items() if k != "device"} == {
        k: v for k, v in jf.items() if k != "device"}
    assert Config().device == "cuda"


@pytest.mark.parametrize("kw", [{}, {"input_size": (64, 96)},
                                {"anchor_scales": (8.0,)}])
def test_properties_match_jax(kw):
    j, t = JConfig(**kw), Config(**kw)
    for name in ("n_anchors_per_cell", "feat_size", "num_anchors"):
        assert getattr(t, name) == getattr(j, name)
    assert t.mask_size == 2 * t.mask_roi_size
    assert t.replace(lr=0.5).lr == 0.5


def test_load_config_reads_json_but_not_its_device(tmp_path):
    p = tmp_path / "c.json"
    p.write_text(json.dumps({"lr": 0.25, "device": "tpu", "fpn": True,
                             "unknown": 1}))
    cfg = load_config(str(p), batch_size=3)
    assert (cfg.lr, cfg.fpn, cfg.batch_size, cfg.device) == (0.25, True, 3, "cuda")
    assert load_config().device == "cuda"


def test_device_dtype_and_kernel_switch():
    assert resolve_device("cpu") == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA"):
            resolve_device("cuda")
    assert compute_dtype(Config()) == torch.bfloat16
    assert compute_dtype(Config(compute_dtype="float32")) == torch.float32
    assert use_kernels(Config()) and use_kernels(Config(pallas="on"))
    assert not use_kernels(Config(pallas="off"))
    with pytest.raises(ValueError):
        use_kernels(Config(pallas="maybe"))
