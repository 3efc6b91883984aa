"""PyTorch port, int8 post-training quantization (``quantize.py``) against
the JAX package's: the calibration's keys and values on both models, the
int8 conv (its int32 accumulators and its requantized output) on convs of
the flagship's kinds, and the ``Predictor``'s ``int8_scales``.  float32 on
the CPU, where the accumulation is the plain float64 convolution of the int8
values (the card's ``torch._int_mm`` route is held against it in
``tests/test_torch_kernels.py`` and ``chip_smoke.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn
from jax import lax

from tests.test_torch_serving import KW, fill, jax_model
from two_stage_object_detection_tpu import quantize as jquantize
from two_stage_object_detection_tpu_torch.config import Config
from two_stage_object_detection_tpu_torch.models.layers import Conv
from two_stage_object_detection_tpu_torch.quantize import (
    calibrate, conv_int32, eligible_convs, filter_scales, int8_conv,
    quantize_input, quantize_weight, quantized)
from two_stage_object_detection_tpu_torch.serving import Predictor
from two_stage_object_detection_tpu_torch.utils.jax_weights import (
    load_jax_variables)

# the single scale of Config() (HarDNet-39, with its depthwise convs) at 64x64
SINGLE = dict(input_size=(64, 64), num_classes=3, n_test_post_nms=16,
              max_detections=8, score_thresh=0.0, compute_dtype="float32")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def flagship():
    jm, v = jax_model()
    from two_stage_object_detection_tpu_torch.nets.detector import FasterRCNN
    model = load_jax_variables(FasterRCNN(Config(**KW, device="cpu")),
                               v["params"], v["batch_stats"])
    return jm, v, model


@pytest.mark.parametrize("name", ["flagship", "single-scale"])
def test_calibrate_equals_jax(flagship, rng, name):
    """The same convs are eligible (dense ones: HarDNet's depthwise convs
    are left out), under the same ``/`` paths, and each records its input's
    absmax within 1e-5 relative of JAX's over two batches."""
    if name == "flagship":
        jm, v, model = flagship
    else:
        from two_stage_object_detection_tpu_torch.nets.detector import (
            FasterRCNN)
        jm, v = jax_model(SINGLE, seed=1)
        model = load_jax_variables(FasterRCNN(Config(**SINGLE, device="cpu")),
                                   v["params"], v["batch_stats"])
    batches = [rng.rand(2, 64, 64, 3).astype(np.float32) for _ in range(2)]
    want = jquantize.calibrate(jm, v, [jnp.asarray(b) for b in batches],
                               method="predict")
    got = calibrate(model, [torch.from_numpy(b) for b in batches])
    assert sorted(got) == sorted(want) == sorted(eligible_convs(model))
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-5), k
    if name == "single-scale":
        assert any(m.groups > 1 for m in model.modules()
                   if isinstance(m, Conv))


# (in, out, kernel, stride, padding, bias): the flagship's stem (K=147), a
# 3x3 body conv and a strided 1x1 projection with a bias
CONVS = {"stem": (3, 16, 7, 2, 3, False), "3x3": (16, 24, 3, 1, 1, False),
         "1x1_s2_bias": (24, 8, 1, 2, 0, True)}


@pytest.mark.parametrize("shape", list(CONVS))
def test_int8_conv_equals_jax_quantized_conv(rng, shape):
    """The int8 conv against JAX's ``_quantized_conv`` on the same weights
    and input: int32 accumulators equal, and the requantized output equal
    bit for bit."""
    cin, cout, k, s, p, bias = CONVS[shape]
    jconv = nn.Conv(cout, (k, k), strides=(s, s), padding=((p, p), (p, p)),
                    use_bias=bias)
    x = rng.randn(2, 20, 18, cin).astype(np.float32)
    shapes = jax.eval_shape(jconv.init, jax.random.PRNGKey(0), x)
    params = fill(shapes["params"], rng)
    bound = jconv.bind({"params": params})
    s_x = float(np.abs(x).max()) * 0.8 / 127.0      # some inputs clip
    want = np.asarray(jquantize._quantized_conv(bound, jnp.asarray(x), s_x))

    conv = Conv(cin, cout, k, s, p, bias=bias)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(params["kernel"].transpose(3, 2, 0, 1)))
        if bias:
            conv.bias.copy_(torch.from_numpy(params["bias"]))
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy())
    got = int8_conv(conv, xt, s_x).detach().numpy().transpose(0, 2, 3, 1)
    np.testing.assert_array_equal(got, want)

    # the accumulators, JAX's from its own quantization steps
    w = params["kernel"]
    s_w = jnp.maximum(jnp.max(jnp.abs(w), axis=(0, 1, 2)) / 127.0, 1e-12)
    w_q = jnp.round(w / s_w).astype(jnp.int8)
    x_q = jnp.round(jnp.clip(jnp.asarray(x) / s_x, -127.0, 127.0)).astype(
        jnp.int8)
    acc = np.asarray(lax.conv_general_dilated(
        x_q, w_q, (s, s), ((p, p), (p, p)),
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32))
    tq, ts_w = quantize_weight(conv.weight)
    np.testing.assert_array_equal(ts_w.detach().numpy(), np.asarray(s_w))
    tacc = conv_int32(quantize_input(xt, s_x), tq, s, p)
    assert tacc.dtype == torch.int32
    np.testing.assert_array_equal(tacc.numpy().transpose(0, 2, 3, 1), acc)


def test_filter_scales_prefix():
    scales = {"extractor/c1": 1.0, "rpn_head/loc": 2.0}
    assert filter_scales(scales) == {"extractor/c1": 1.0}
    assert filter_scales(scales, "rpn") == {"rpn_head/loc": 2.0}


def test_quantized_predictor_and_restore(flagship, rng):
    """``Predictor(int8_scales=)``: the backbone's convs run in int8 (the
    answer moves, within int8 error of the float one), the output contract
    holds, and the model's convs are float again after the call."""
    _, _, model = flagship
    x = rng.rand(2, 64, 64, 3).astype(np.float32)
    scales = filter_scales(calibrate(model, [torch.from_numpy(x)]))
    assert scales and all(k.startswith("extractor") for k in scales)
    plain = Predictor(model.cfg, model, batch_sizes=(2,))
    want = plain(x)
    got = Predictor(model.cfg, model, batch_sizes=(2,), int8_scales=scales)(x)
    assert all(got[k].shape == want[k].shape for k in want)
    assert np.isfinite(got["boxes"]).all() and np.isfinite(got["scores"]).all()
    assert not np.array_equal(got["scores"], want["scores"])
    assert not any("forward" in vars(m) for m in eligible_convs(model).values())
    for k in want:
        np.testing.assert_array_equal(plain(x)[k], want[k])
    with quantized(model, {"extractor/conv1": 0.0}):     # 0: left float
        assert "forward" not in vars(eligible_convs(model)["extractor/conv1"])
