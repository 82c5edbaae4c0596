"""``tools/train_torch.py`` with ``parallel.num_devices: 2`` over two CPU
ranks (gloo), against the same run in one process: yolov8n at 64 px, B = 2
(one image a rank), float32, 3 steps (lr 0, 1e-3, 2e-3) with validation
and a checkpoint at step 2.

Rank 0 alone draws the loader's batches (the reference's one random
stream), so both runs see the same images; they differ only in the order of
float32 sums, which AdamW's normalised update turns into parameter gaps of
up to its step size where a gradient is near 0.  Measured here:
``ema_final.npz`` arrays 1.5e-4 apart at worst [bar 2e-3, one update at lr
2e-3; tests/test_torch_port_train_sharded.py holds the step itself to
float32 rounding].  Rank 0 alone validates, writes the checkpoints and
``ema_final.npz``, which the JAX ``Detector`` loads and detects with as the
port's does (tests/test_torch_port_train_tools.py's bars).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from rtmodt_tpu.config.loader import DetectionConfig as JaxDetectionConfig
from rtmodt_tpu.detection.detector import Detector as JaxDetector
from rtmodt_tpu_torch.config.loader import DetectionConfig
from rtmodt_tpu_torch.detection.detector import Detector
from rtmodt_tpu_torch.training import synth_data
from tests.test_torch_port_threads import child_env, torch_threads  # noqa: F401 (autouse)
from tests.test_torch_port_train_tools import ROOT, _config


def _train(cfg: str) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "tools/train_torch.py", "-c", cfg, "--max-steps", "3",
                           "--device", "cpu"], cwd=ROOT, capture_output=True, text=True,
                          timeout=300, env=child_env())


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ranks")
    data = str(tmp / "rich")
    synth_data.make_synthetic_rich(data, 6, 2, 128, 160, 4, seed=0)
    out = {"data": data}
    for n in (1, 2):
        d = tmp / f"n{n}"
        d.mkdir()
        proc = _train(_config(d, data, precision="fp32", parallel={"num_devices": n}))
        assert proc.returncode == 0, proc.stderr[-3000:]
        out[n] = {"ckpt": str(d / "ckpt"), "log": proc.stderr + proc.stdout}
    return out


def test_two_cpu_ranks_train_as_one_process(runs):
    log = runs[2]["log"]
    assert "rank 0 of 2 (cpu)" in log and "rank 1 of 2 (cpu)" in log
    assert log.count("val @ step 2: mAP50=") == 1            # rank 0 alone validates
    assert sorted(os.listdir(runs[2]["ckpt"])) == sorted(os.listdir(runs[1]["ckpt"]))
    with np.load(os.path.join(runs[1]["ckpt"], "ema_final.npz")) as one, \
            np.load(os.path.join(runs[2]["ckpt"], "ema_final.npz")) as two:
        assert sorted(one.files) == sorted(two.files)
        worst = max(float(np.abs(one[k].astype(np.float64) - two[k]).max()) for k in one.files)
    assert worst <= 2e-3, worst


def test_the_ranks_ema_final_loads_into_the_jax_detector(runs):
    weights = os.path.join(runs[2]["ckpt"], "ema_final.npz")
    common = dict(model="yolov8n", num_classes=4, input_size=64, weights=weights,
                  half=False, classes=None, conf_threshold=0.001, max_detections=50)
    ref = JaxDetector(JaxDetectionConfig(**common), warmup=False)
    port = Detector(DetectionConfig(**common), device="cpu", warmup=False)
    with open(os.path.join(runs["data"], "val_coco_gt.json")) as f:
        gt = json.load(f)
    import cv2

    for im in gt["images"]:
        frame = cv2.imread(os.path.join(runs["data"], "images", "val", im["file_name"]))
        want, got = ref.detect(frame), port.detect(frame)
        assert len(got) == len(want) > 0
        np.testing.assert_array_equal(got.class_id, want.class_id)
        np.testing.assert_allclose(got.confidence, want.confidence, rtol=0, atol=1e-5)
        np.testing.assert_allclose(got.xyxy, want.xyxy, rtol=0, atol=1e-4)
