"""The port's validation NMS, training checkpoints and ``tools/train_torch.py``
against the JAX package on the CPU.

  * ``ops/nms.py::batched_nms_fixed`` (training validation's NMS, K1 at
    K = 1000) against the reference's on random decoded frames: counts and
    classes equal, scores within 1e-6, boxes within 1e-3 px (measured: 0);
  * ``training/checkpoint.py::CheckpointManager`` keeps the steps the
    reference's orbax manager keeps for the same saves and metrics (best 5
    by mAP50, a save without metrics ranking as 0.0), and restores every
    tensor and int bit for bit;
  * ``tools/train_torch.py`` on a tiny config (yolov8n, 4 classes, 64 px,
    B = 2, bf16, mosaic, mixup, copy-paste): it validates, checkpoints and
    writes ``ema_final.npz``, which the JAX ``Detector`` loads and with
    which it gives the port's ``Detector``'s detections (counts and classes
    equal, boxes within 1e-4 px, scores within 1e-5); ``--resume`` continues
    from the last step with the saved state; ``--qat-steps`` writes the
    files the int8 path loads; ``parallel.num_devices: 2`` is refused.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from rtmodt_tpu.config.loader import DetectionConfig as JaxDetectionConfig
from rtmodt_tpu.detection.detector import Detector as JaxDetector
from rtmodt_tpu.ops.nms import batched_nms_fixed as jax_nms_fixed
from rtmodt_tpu.training.checkpoint import CheckpointManager as JaxCheckpointManager
from rtmodt_tpu_torch.config.loader import DetectionConfig
from rtmodt_tpu_torch.detection.detector import Detector
from rtmodt_tpu_torch.ops.nms import batched_nms_fixed
from rtmodt_tpu_torch.training import synth_data
from rtmodt_tpu_torch.training.checkpoint import CheckpointManager
from tests.test_torch_port_threads import child_env, torch_threads  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("seed,n,c", [(0, 1344, 4), (1, 2100, 8), (2, 500, 2)])
def test_batched_nms_fixed_matches_the_reference(seed, n, c):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 600, (n, 2))
    wh = rng.uniform(4, 120, (n, 2))
    boxes = np.concatenate([xy, xy + wh], 1).astype(np.float32)
    scores = rng.beta(0.3, 3.0, (n, c)).astype(np.float32)
    scores[rng.random(n) < 0.05] = scores[0]            # exact ties across rows
    want = jax_nms_fixed(jnp.asarray(boxes), jnp.asarray(scores), 0.001, 0.6, 300, 1000)
    got = batched_nms_fixed(torch.from_numpy(boxes), torch.from_numpy(scores), 0.001, 0.6,
                            300, 1000)
    assert int(got.count) == int(want.count) > 0
    np.testing.assert_array_equal(got.classes.numpy(), np.asarray(want.classes))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.boxes.numpy(), np.asarray(want.boxes), rtol=0, atol=1e-3)


SAVES = [(1, {"map50": 0.2}), (2, {}), (3, {"map50": 0.5}), (4, {"map50": 0.1}), (5, {}),
         (6, {"map50": 0.5}), (7, {"map50": 0.3}), (8, {}), (9, {"map50": 0.7}),
         (10, {"map50": 0.05}), (11, {"map50": 0.3}), (12, {})]


@pytest.mark.parametrize("keep", [3, 5])
def test_checkpoint_retention_matches_orbax(tmp_path, keep):
    ref = JaxCheckpointManager(str(tmp_path / "ref"), max_to_keep=keep)
    port = CheckpointManager(str(tmp_path / "port"), max_to_keep=keep)
    for step, metrics in SAVES:
        ref.save(step, {"w": np.zeros(2, np.float32)}, metrics=metrics)
        port.save(step, {"w": torch.zeros(2)}, metrics)
        assert port.all_steps() == list(ref._mgr.all_steps()), step
        assert port.latest_step == ref.latest_step
    ref.close()
    again = CheckpointManager(str(tmp_path / "port"), max_to_keep=keep)
    assert again.all_steps() == port.all_steps()


def test_checkpoint_restores_bit_equal(tmp_path):
    g = torch.Generator().manual_seed(0)
    state = {"step": 7, "model": {"a.weight": torch.randn(3, 4, generator=g),
                                  "a.bn.num_batches_tracked": torch.tensor(3)},
             "opt": {"count": 7, "mu": {"a": torch.randn(5, generator=g)}},
             "ema": None}
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(7, state, {"map50": 0.25})
    back = CheckpointManager(str(tmp_path)).restore()
    assert back["step"] == 7 and back["opt"]["count"] == 7 and back["ema"] is None
    assert torch.equal(back["model"]["a.weight"], state["model"]["a.weight"])
    assert torch.equal(back["opt"]["mu"]["a"], state["opt"]["mu"]["a"])
    assert back["model"]["a.bn.num_batches_tracked"].dtype == torch.int64


def _config(tmp_path, data_root, **over) -> str:
    cfg = {
        "model": "yolov8n", "num_classes": 4, "input_size": 64,
        "data": {"root": data_root, "train_split": "train", "val_split": "val",
                 "max_boxes": 8},
        "epochs": 3, "batch_size": 2, "steps_per_epoch": 2,
        "optimizer": {"lr0": 0.002, "lrf": 0.05, "weight_decay": 0.0005,
                      "warmup_epochs": 1, "clip_norm": 10.0},
        "loss": {"box": 7.5, "cls": 0.5, "dfl": 1.5},
        "augmentation": {"mosaic": 1.0, "mixup": 0.5, "copy_paste": 0.5},
        "precision": "bf16", "ema_decay": 0.9999,
        "checkpoint": {"dir": str(tmp_path / "ckpt"), "save_period": 1, "resume": False},
        "patience": 0, "val_interval": 1, "parallel": {"num_devices": 0},
    }
    for k, v in over.items():
        cfg[k] = v
    path = str(tmp_path / "train.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


def _train(*args: str) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "tools/train_torch.py", *args, "--device", "cpu"],
                          cwd=ROOT, capture_output=True, text=True, timeout=300,
                          env=child_env())


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """Two steps of train_torch, a resumed third step, then one QAT step."""
    tmp = tmp_path_factory.mktemp("train")
    data = str(tmp / "rich")
    synth_data.make_synthetic_rich(data, 6, 2, 128, 160, 4, seed=0)
    cfg = _config(tmp, data)
    first = _train("-c", cfg, "--max-steps", "2")
    assert first.returncode == 0, first.stderr[-3000:]
    ckpt = str(tmp / "ckpt")
    saved = CheckpointManager(ckpt).restore(2)
    resumed = _train("-c", cfg, "--resume", "--max-steps", "3", "--qat-steps", "1")
    assert resumed.returncode == 0, resumed.stderr[-3000:]
    return {"ckpt": ckpt, "saved2": saved, "first": first, "resumed": resumed, "data": data}


def test_train_tool_validates_checkpoints_and_resumes(trained):
    log = trained["first"].stderr + trained["first"].stdout
    assert "val @ step 2: mAP50=" in log and "checkpoint saved @ step 2" in log
    saved = trained["saved2"]
    assert saved["step"] == 2 and saved["opt"]["count"] == 2
    assert set(saved["ema"]) == {k for k in saved["model"] if "running" not in k
                                 and "num_batches" not in k}
    log = trained["resumed"].stderr + trained["resumed"].stdout
    assert "resumed from step 2" in log and "checkpoint saved @ step 3" in log
    third = CheckpointManager(trained["ckpt"]).restore(3)
    assert third["step"] == 3 and third["opt"]["count"] == 3
    # the resumed run started from the saved state: the moments moved on from it
    assert any(not torch.equal(third["opt"]["mu"][k], v) for k, v in saved["opt"]["mu"].items())


def test_ema_final_loads_into_the_jax_detector(trained):
    weights = os.path.join(trained["ckpt"], "ema_final.npz")
    common = dict(model="yolov8n", num_classes=4, input_size=64, weights=weights,
                  half=False, classes=None, conf_threshold=0.001, max_detections=50)
    ref = JaxDetector(JaxDetectionConfig(**common), warmup=False)
    port = Detector(DetectionConfig(**common), device="cpu", warmup=False)
    with open(os.path.join(trained["data"], "val_coco_gt.json")) as f:
        gt = json.load(f)
    import cv2

    for im in gt["images"]:
        frame = cv2.imread(os.path.join(trained["data"], "images", "val", im["file_name"]))
        want, got = ref.detect(frame), port.detect(frame)
        assert len(got) == len(want) > 0
        np.testing.assert_array_equal(got.class_id, want.class_id)
        np.testing.assert_allclose(got.confidence, want.confidence, rtol=0, atol=1e-5)
        np.testing.assert_allclose(got.xyxy, want.xyxy, rtol=0, atol=1e-4)


def test_qat_outputs_load_through_the_int8_path(trained):
    ckpt = trained["ckpt"]
    with np.load(os.path.join(ckpt, "qat_act_scales.npz")) as z:
        keys = z.files
    assert len(keys) == 57 and all("/" not in k for k in keys) and "stem" in keys
    det = Detector(DetectionConfig(model="yolov8n", num_classes=4, input_size=64,
                                   weights=os.path.join(ckpt, "qat_final.npz"), half=False,
                                   classes=None, quant="int8",
                                   quant_scales=os.path.join(ckpt, "qat_act_scales.npz"),
                                   conf_threshold=0.001),
                   device="cpu", warmup=False)
    frame = np.random.default_rng(0).integers(0, 256, (128, 160, 3), dtype=np.uint8)
    assert len(det.detect(frame)) > 0


def test_several_cards_are_refused(tmp_path):
    from rtmodt_tpu_torch.training.trainer import Trainer, load_train_config

    cfg = load_train_config(_config(tmp_path, str(tmp_path / "none"),
                                    parallel={"num_devices": 2}))
    # one Trainer is one rank: several cards need their ranks (trainer.train)
    with pytest.raises(ValueError, match="trains in 2 ranks"):
        Trainer(cfg, "cpu")
