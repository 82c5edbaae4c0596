"""The BGR letterbox and the ``Detector`` facade against the JAX package's.

Letterbox in float32: a 2x downscale, a non-integer scale and an upscale
(and a case without resize) on seeded random frames; the geometry must be
equal and the pixels within 1e-5 (measured: 0 for the 2x cases, at most
1.7e-6 otherwise - the two frameworks compute the bilinear sample positions
in a different order).  In bf16 both cast before the resize, so they round
differently; the gap is bounded at 0.02 (5 levels of 8 bits; measured
0.0117).  ``Detector.detect`` runs the repository's trained rich640d
weights at 256 px in float32 on both sides: equal counts and classes,
scores within 1e-5, boxes within 1e-4 px (the DFL softmax's ulp-level
difference, see tests/test_torch_port_nms.py).
"""

from __future__ import annotations

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtmodt_tpu.config.loader import DetectionConfig as JaxDetectionConfig
from rtmodt_tpu.detection.detector import Detector as JaxDetector
from rtmodt_tpu.ops.letterbox import letterbox as jax_letterbox
from rtmodt_tpu.ops.letterbox import unletterbox_boxes as jax_unletterbox
from rtmodt_tpu_torch.config.loader import DetectionConfig
from rtmodt_tpu_torch.detection.detector import Detections, Detector
from rtmodt_tpu_torch.ops.letterbox import letterbox, unletterbox_boxes
from rtmodt_tpu_torch.utils.synthetic import moving_boxes_frame
from tests.test_torch_port_threads import torch_threads  # noqa: F401 (autouse)

WEIGHTS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "checkpoints", "rich640d", "ema_final.npz")
LETTERBOX_F32_ATOL = 1e-5
LETTERBOX_BF16_ATOL = 0.02
BOX_ATOL = 1e-4


@pytest.mark.parametrize("h,w,size", [
    (512, 512, 256),     # 2x downscale, square
    (288, 512, 256),     # 2x downscale, letterboxed
    (300, 500, 256),     # non-integer scale 0.512
    (100, 60, 256),      # upscale 2.56x
    (37, 53, 64),        # odd sizes, non-integer upscale
    (256, 256, 256),     # no resize
])
def test_letterbox_matches_jax(h, w, size):
    frame = np.random.default_rng(h * w).integers(0, 256, (h, w, 3), dtype=np.uint8)
    want, wmeta = jax_letterbox(jnp.asarray(frame), size, dtype=jnp.float32)
    got, meta = letterbox(torch.from_numpy(frame), size, dtype=torch.float32)
    assert meta == wmeta and got.shape == (size, size, 3) and got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=LETTERBOX_F32_ATOL)
    want16, _ = jax_letterbox(jnp.asarray(frame), size, dtype=jnp.bfloat16)
    got16, _ = letterbox(torch.from_numpy(frame), size, dtype=torch.bfloat16)
    assert got16.dtype == torch.bfloat16
    gap = np.abs(got16.float().numpy() - np.asarray(want16, np.float32)).max()
    assert gap <= LETTERBOX_BF16_ATOL
    boxes = np.random.default_rng(1).uniform(-20, size + 20, (16, 4)).astype(np.float32)
    np.testing.assert_allclose(unletterbox_boxes(torch.from_numpy(boxes), meta).numpy(),
                               np.asarray(jax_unletterbox(jnp.asarray(boxes), wmeta)),
                               rtol=1e-6, atol=1e-5)


@pytest.fixture(scope="module")
def detectors():
    common = {"model": "yolov8s", "num_classes": 8, "input_size": 256, "weights": WEIGHTS,
              "half": False, "conf_threshold": 0.3, "classes": [0, 1, 2, 3, 5, 7]}
    return (Detector(DetectionConfig(**common), device="cpu", warmup=False),
            JaxDetector(JaxDetectionConfig(**common), warmup=False))


@pytest.mark.parametrize("t", [0, 7])
def test_detect_matches_jax_detector(detectors, t):
    port, ref = detectors
    frame, _ = moving_boxes_frame(t, 288, 512, 6, seed=1)
    got, want = port.detect(frame), ref.detect(frame)
    assert len(got) == len(want) > 0
    assert got.class_names == want.class_names
    np.testing.assert_array_equal(got.class_id, want.class_id)
    np.testing.assert_allclose(got.confidence, want.confidence, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.xyxy, want.xyxy, rtol=0, atol=BOX_ATOL)
    assert got.xyxy.dtype == np.float32 and got.class_id.dtype == np.int32


def test_detect_device_is_fixed_shape_and_empty_frames_are_empty(detectors):
    port, _ = detectors
    res = port.detect_device(np.zeros((288, 512, 3), np.uint8))
    assert res.boxes.shape == (100, 4) and res.valid.shape == (100,)
    d = port.detect(np.zeros((288, 512, 3), np.uint8))
    assert len(d) == 0 and d.xyxy.shape == (0, 4)
    assert len(Detections.empty()) == 0


def test_int8_calibration_is_not_ported(detectors):
    """``calibrate`` outside int8 raises as the reference's does (int8 itself:
    tests/test_torch_port_quant.py)."""
    with pytest.raises(ValueError, match="int8") as port_err:
        detectors[0].calibrate([np.zeros((64, 64, 3), np.uint8)])
    with pytest.raises(ValueError, match="int8") as ref_err:
        detectors[1].calibrate([np.zeros((64, 64, 3), np.uint8)])
    assert str(port_err.value) == str(ref_err.value)
