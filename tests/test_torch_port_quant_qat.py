"""rich640d's QAT checkpoint in int8 on the CPU: ``qat_final.npz`` (BN
folded) with its frozen ``qat_act_scales.npz`` at 256 px, float32, in both
packages.

  * the int8 forward against the JAX int8 forward as tests/test_quant.py
    runs it (``apply`` op by op), decoded boxes and scores within a tenth of
    the int8-vs-float gap that tests/test_quant.py::test_outputs_close_to_fp
    allows (0.8 px and 0.005).  Measured here: 6.1e-5 px, 1.2e-7.  The
    jitted JAX program differs from the op-by-op one by up to 0.38 on the
    heads (boxes ~6 px): XLA fuses the requantization's multiply-add into
    one rounding, an ulp flips an int8 rounding and the flip grows through
    the layers; the port rounds as the op-by-op forward does;
  * the float forward of the BN-folded checkpoint against the JAX package's,
    below 1e-4 on the heads (tests/test_torch_port_model.py's bar).

The offline tool's ``--quant int8``: tests/test_torch_port_quant_tool.py.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtmodt_tpu.config.loader import DetectionConfig as JaxDetectionConfig
from rtmodt_tpu.detection.detector import Detector as JaxDetector
from rtmodt_tpu.models.yolov8 import build_model as jax_build
from rtmodt_tpu_torch.config.loader import DetectionConfig
from rtmodt_tpu_torch.detection.detector import Detector
from tests.test_torch_port_quant import assert_int8_forward_close
from tests.test_torch_port_threads import torch_threads  # noqa: F401 (autouse)

CKPT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "checkpoints", "rich640d")
INT8 = {"weights": os.path.join(CKPT, "qat_final.npz"), "quant": "int8",
        "quant_scales": os.path.join(CKPT, "qat_act_scales.npz")}


@pytest.fixture(scope="module")
def qat256():
    common = dict(model="yolov8s", input_size=256, num_classes=8, half=False, classes=None,
                  **INT8)
    return (JaxDetector(JaxDetectionConfig(**common), warmup=False),
            Detector(DetectionConfig(**common), device="cpu", warmup=False))


def test_qat_int8_forward_matches_the_jax_int8_forward(qat256):
    assert_int8_forward_close(*qat256, batch=2)


def test_qat_checkpoint_float_forward_matches_jax(qat256):
    """The BN-folded qat_final.npz in float32 (no int8): the port's fused
    model against the JAX package's ``apply`` on the same input."""
    ref, port = qat256
    img = np.random.default_rng(6).random((1, 256, 256, 3)).astype(np.float32)
    model = jax_build("yolov8s", 8, dtype=jnp.float32, fused=True)
    bd, cl = jax.jit(lambda p, x: model.apply(p, x, train=False))(ref.params, jnp.asarray(img))
    with torch.no_grad():
        pbd, pcl = port._float_model(torch.from_numpy(img).permute(0, 3, 1, 2))
    np.testing.assert_allclose(pbd.numpy(), np.asarray(bd), rtol=0, atol=1e-4)
    np.testing.assert_allclose(pcl.numpy(), np.asarray(cl), rtol=0, atol=1e-4)
