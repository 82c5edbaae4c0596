"""int8 post-training quantization: the port against the JAX package on the CPU.

  * one fused conv layer: the port's ``QuantizedConvBN`` against the
    reference's int8 conv on the same int8 operands (its
    ``lax.conv_general_dilated(..., preferred_element_type=int32)``) - the
    int32 accumulators equal, the outputs within 1e-6 relative in float32;
  * calibration and weights on yolov8n at 128 px (seeded weights, float32,
    the reference's synthetic calibration): equal layer keys, amax within
    1e-6 relative, int8 weights and scales bit-equal on the same fused tree;
    ``calibrate`` on real frames likewise;
  * the whole forward of yolov8n at 128 with synthetic PTQ: decoded boxes
    and scores against the JAX int8 forward within a tenth of the
    int8-vs-float gap that tests/test_quant.py::test_outputs_close_to_fp
    allows (0.8 px and 0.005).

The JAX int8 reference is computed once per module; rich640d's QAT
checkpoint is held in tests/test_torch_port_quant_qat.py.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from rtmodt_tpu.config.loader import DetectionConfig as JaxDetectionConfig
from rtmodt_tpu.detection.detector import Detector as JaxDetector
from rtmodt_tpu.models import weights as jax_weights
from rtmodt_tpu.models.yolov8 import ConvBN as JaxConvBN
from rtmodt_tpu.models.yolov8 import build_model as jax_build
from rtmodt_tpu.models.yolov8 import decode_predictions
from rtmodt_tpu.quant import ptq as jax_ptq
from rtmodt_tpu_torch.config.loader import DetectionConfig
from rtmodt_tpu_torch.detection.detector import Detector
from rtmodt_tpu_torch.models.yolov8 import ConvBN
from rtmodt_tpu_torch.ops.int8_conv import int8_conv2d, int8_mm_reference
from rtmodt_tpu_torch.quant import ptq
from tests.test_torch_port_threads import torch_threads  # noqa: F401 (autouse)

# a tenth of tests/test_quant.py::test_outputs_close_to_fp's int8-vs-float gap
BOX_TOL, SCORE_TOL = 0.8, 0.005
SCALE_RTOL = 1e-6


def _qconv_equal(got: ptq.QuantConv, want: jax_ptq.QuantConv, where: str) -> None:
    for field in want._fields:
        a, b = getattr(got, field).numpy(), np.asarray(getattr(want, field))
        assert a.dtype == b.dtype and a.shape == b.shape, (where, field)
        assert np.array_equal(a, b), (where, field)


@pytest.mark.parametrize("cin,cout,k,stride,hw", [
    (16, 24, 1, 1, (9, 11)), (8, 16, 3, 1, (10, 7)), (16, 32, 3, 2, (13, 12)),
    (24, 8, 3, 2, (8, 8)),
])
def test_quantized_conv_matches_the_reference_layer(cin, cout, k, stride, hw):
    rng = np.random.default_rng(cin * 7 + k * 3 + stride)
    kernel = (rng.standard_normal((k, k, cin, cout)) / np.sqrt(k * k * cin)).astype(np.float32)
    bias = rng.standard_normal(cout).astype(np.float32)
    x = (rng.standard_normal((2, *hw, cin)) * 2).astype(np.float32)
    amax = float(np.abs(x).max())

    ref_mod = JaxConvBN(cout, k, stride, dtype=jnp.float32, fused=True)
    params = {"params": {"conv": {"kernel": jnp.asarray(kernel), "bias": jnp.asarray(bias)}}}
    want_q = jax_ptq.quantize_convs(params, {"": amax})[""]
    want = np.asarray(jax_ptq.QuantizedModel(ref_mod, {"": want_q}).apply(params, jnp.asarray(x)))

    mod = ConvBN(cin, cout, k, stride, fused=True)
    with torch.no_grad():
        mod.conv.weight.copy_(torch.from_numpy(kernel.transpose(3, 2, 0, 1)))
        mod.conv.bias.copy_(torch.from_numpy(bias))
    q = ptq.quantize_convs(mod, {"": amax}, skip=())[""]
    _qconv_equal(q, want_q, "layer")
    qmod = ptq.QuantizedConvBN(q, k, stride)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)

    # the int8 operands and the int32 accumulators, as the reference computes them
    inv_a = (1.0 / want_q.ascale).astype(jnp.float32)
    want_xq = jnp.clip(jnp.round(jnp.asarray(x) * inv_a), -127, 127).astype(jnp.int8)
    pad = k // 2
    want_acc = np.asarray(lax.conv_general_dilated(
        want_xq, want_q.qkernel, window_strides=(stride, stride),
        padding=((pad, pad), (pad, pad)), dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32))
    xq = qmod.quantize_input(xt)
    assert np.array_equal(xq.permute(0, 2, 3, 1).numpy(), np.asarray(want_xq))
    acc = int8_conv2d(xq, qmod.qweight, k, stride)
    assert acc.dtype == torch.int32
    assert np.array_equal(acc.permute(0, 2, 3, 1).numpy(), want_acc)
    plain = int8_conv2d(xq, qmod.qweight, k, stride, mm=int8_mm_reference)
    assert np.array_equal(plain.permute(0, 2, 3, 1).numpy(), want_acc.astype(np.int64))

    with torch.no_grad():
        got = qmod(xt).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * np.abs(want).max())


def _recording(monkeypatch, module, into: list) -> None:
    """Wrap ``module.collect_act_scales`` to keep what each call returns."""
    inner = module.collect_act_scales

    def wrapped(*a, **kw):
        into.append(inner(*a, **kw))
        return into[-1]

    monkeypatch.setattr(module, "collect_act_scales", wrapped)


@pytest.fixture(scope="module")
def n128(tmp_path_factory):
    """yolov8n at 128 px from seeded flax weights, float32, int8 with the
    synthetic calibration, in both packages: (jax detector, its scales, port
    detector, its scales)."""
    path = str(tmp_path_factory.mktemp("w") / "n128.npz")
    model = jax_build("yolov8n", 80, dtype=jnp.float32)
    init = jax.jit(lambda key: model.init(key, jnp.zeros((1, 128, 128, 3)), train=False))
    jax_weights.save_npz(init(jax.random.PRNGKey(3)), path)
    common = dict(model="yolov8n", input_size=128, conf_threshold=0.01, nms_candidates=64,
                  max_detections=20, classes=None, quant="int8", half=False, weights=path)
    jax_scales, port_scales = [], []
    with pytest.MonkeyPatch.context() as mp:
        _recording(mp, jax_ptq, jax_scales)
        _recording(mp, ptq, port_scales)
        ref = JaxDetector(JaxDetectionConfig(**common), warmup=False)
        port = Detector(DetectionConfig(**common), device="cpu", warmup=False)
    return ref, jax_scales[-1], port, port_scales[-1]


def assert_int8_forward_close(ref, port, batch: int) -> tuple[float, float]:
    """Decoded boxes and scores of the port's int8 forward against the JAX
    int8 forward (``apply`` op by op) on seeded inputs, within BOX_TOL /
    SCORE_TOL; and the port's int8 heads differ from its float ones."""
    size = ref.cfg.input_size
    img = np.random.default_rng(5).random((batch, size, size, 3)).astype(np.float32)
    bd, cl = ref.model.apply(ref.params, jnp.asarray(img), train=False)
    want_b, want_s = decode_predictions(bd, cl, size)
    with torch.no_grad():
        pbd, pcl = port.model(torch.from_numpy(img).permute(0, 3, 1, 2))
        fbd, _ = port._float_model(torch.from_numpy(img).permute(0, 3, 1, 2))
    got_b, got_s = decode_predictions(jnp.asarray(pbd.numpy()), jnp.asarray(pcl.numpy()), size)
    b_err = float(np.abs(np.asarray(got_b) - np.asarray(want_b)).max())
    s_err = float(np.abs(np.asarray(got_s) - np.asarray(want_s)).max())
    assert b_err <= BOX_TOL and s_err <= SCORE_TOL, (b_err, s_err)
    # the quantized layers ran: the int8 heads are not the float ones
    assert float((fbd - pbd).abs().max()) > 1e-3 * float(fbd.abs().max())
    return b_err, s_err


def _assert_scales_close(got: dict, want: dict) -> None:
    assert set(got) == set(want) and len(want) > 50
    rel = max(abs(got[k] - want[k]) / want[k] for k in want)
    assert rel <= SCALE_RTOL, rel


def test_act_scales_and_int8_weights_equal_the_reference(n128):
    ref, jax_scales, port, port_scales = n128
    _assert_scales_close(port_scales, jax_scales)
    # the same scales on the same fused tree: int8 weights and scales bit-equal
    want = ref.model._qtree
    got = ptq.quantize_convs(port._float_model, jax_scales)
    assert set(got) == set(want) and "stem" not in got
    for path in want:
        _qconv_equal(got[path], want[path], path)
    # the deployed model holds one QuantizedConvBN per quantized layer
    swapped = [n for n, m in port.model.named_modules() if isinstance(m, ptq.QuantizedConvBN)]
    assert sorted(n.replace(".", "/") for n in swapped) == sorted(want)


def test_int8_forward_matches_the_jax_int8_forward(n128):
    """The JAX int8 forward as tests/test_quant.py runs it (``apply`` op by
    op, at the calibration's batch of one, whose ops are compiled).  Under
    ``jax.jit`` XLA fuses the requantization's multiply-add into one
    rounding: a product moves by an ulp, an int8 rounding flips and the flip
    grows through the layers, so no second implementation can be held to the
    jitted program at this bar (tests/test_torch_port_quant_qat.py).
    Measured here: boxes within 1.1e-4 px, scores 3.1e-6."""
    ref, _, port, _ = n128
    assert_int8_forward_close(ref, port, batch=1)


def test_calibrate_on_real_frames_equals_the_reference(n128, monkeypatch):
    ref, _, port, _ = n128
    frames = [np.random.default_rng(i).integers(0, 255, (160, 200, 3), np.uint8)
              for i in range(2)]
    jax_scales, port_scales = [], []
    _recording(monkeypatch, jax_ptq, jax_scales)
    _recording(monkeypatch, ptq, port_scales)
    ref.calibrate(frames)
    port.calibrate(frames)
    _assert_scales_close(port_scales[-1], jax_scales[-1])
    assert not np.array_equal(sorted(port_scales[-1].values()),
                              sorted(n128[3].values()))     # real frames moved them
    got = ptq.quantize_convs(port._float_model, jax_scales[-1])
    for path, want in ref.model._qtree.items():
        _qconv_equal(got[path], want, path)
