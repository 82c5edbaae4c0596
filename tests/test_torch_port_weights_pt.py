"""Ultralytics ``.pt`` checkpoints, ``save_npz`` and ``verify_parity_torch``
on the CPU.

An ultralytics-named state dict is built inside the test (no checkpoint is
downloaded), as tests/test_detector.py::_fake_ultralytics_state builds one,
here by inverting the port's own ``_LAYER_MAP`` copy against the port's
module names; its values are seeded.  Then:

  * the port's ``convert_ultralytics_state_dict`` equals the reference's bit
    for bit (keys, dtypes, values);
  * a ``torch.save``d ``.pt`` of plain tensors, and one holding a pickled
    model of classes that cannot be imported when it loads (the tolerant
    unpickler's route, as a real ``yolov8s.pt`` pickles ultralytics'
    ``DetectionModel``), give the detector the same detections as the
    converted ``.npz``, bit for bit;
  * ``save_npz`` writes what the JAX package's ``Detector`` loads, with the
    same detections (float32 bars of tests/test_torch_port_detector.py);
  * ``tools/verify_parity_torch.py`` runs on rich640d's ``.npz`` at 256 px
    and skips with exit 0 when no weights exist.
"""

from __future__ import annotations

import json
import os
import sys
import types

import numpy as np
import pytest
import torch

from rtmodt_tpu.config.loader import DetectionConfig as JaxDetectionConfig
from rtmodt_tpu.detection.detector import Detector as JaxDetector
from rtmodt_tpu.models import weights as jax_weights
from rtmodt_tpu_torch.config.loader import DetectionConfig
from rtmodt_tpu_torch.detection.detector import Detector
from rtmodt_tpu_torch.models import weights
from rtmodt_tpu_torch.models.yolov8 import build_model
from rtmodt_tpu_torch.utils.synthetic import moving_boxes_frame
from tests.test_torch_port_threads import torch_threads  # noqa: F401 (autouse)

NC, SIZE = 8, 128
WEIGHTS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "checkpoints", "rich640d", "ema_final.npz")
BOX_ATOL, SCORE_ATOL = 1e-4, 1e-5


def _ultralytics_key(name: str) -> str:
    """A port parameter / buffer name -> its ultralytics state-dict key."""
    inv = {v: k for k, v in weights._LAYER_MAP.items()}
    top, *rest = name.split(".")
    if top == "head":
        branch, leaf = rest[0], rest[1:]               # box0_1, [conv, weight]
        kind, lvl, j = branch[:3], branch[3], branch[5]
        return ".".join(["model.22", "cv2" if kind == "box" else "cv3", lvl, j, *leaf])
    parts = []
    for p in rest:
        parts += ["m", p[1:]] if p[0] == "m" and p[1:].isdigit() else [p]
    return ".".join([f"model.{inv[top]}", *parts])


def fake_ultralytics_state(seed: int = 0) -> dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    state = {}
    for name, t in build_model("yolov8n", NC).state_dict().items():
        key = _ultralytics_key(name)
        if name.endswith("num_batches_tracked"):
            state[key] = np.asarray(0, np.int64)
        elif name.endswith("running_var"):
            state[key] = (np.abs(rng.standard_normal(t.shape)) + 0.5).astype(np.float32)
        elif t.ndim == 4:
            fan_in = int(np.prod(t.shape[1:]))
            state[key] = (rng.standard_normal(t.shape) / np.sqrt(fan_in)).astype(np.float32)
        else:
            state[key] = (rng.standard_normal(t.shape) * 0.5).astype(np.float32)
    state["model.22.dfl.conv.weight"] = np.arange(16, dtype=np.float32).reshape(1, 16, 1, 1)
    return state


def _pickled_model(state: dict[str, np.ndarray], path: str) -> None:
    """torch.save a {"model": DetectionModel} whose module classes live in a
    module that is gone when the file is loaded."""
    mod = types.ModuleType("vanished_yolo_tasks")

    class DetectionModel(torch.nn.Module):
        pass

    class Block(torch.nn.Module):
        pass

    for cls in (DetectionModel, Block):
        cls.__module__, cls.__qualname__ = mod.__name__, cls.__name__
        setattr(mod, cls.__name__, cls)
    root = DetectionModel()
    for key, value in state.items():
        *path_parts, leaf = key.split(".")
        m = root
        for p in path_parts:
            if p not in m._modules:
                m.add_module(p, Block())
            m = m._modules[p]
        t = torch.from_numpy(np.ascontiguousarray(value))
        if leaf.startswith(("running_", "num_batches")):
            m.register_buffer(leaf, t)
        else:
            m.register_parameter(leaf, torch.nn.Parameter(t, requires_grad=False))
    sys.modules[mod.__name__] = mod
    try:
        torch.save({"model": root, "epoch": 3}, path)
    finally:
        del sys.modules[mod.__name__]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("weights")
    state = fake_ultralytics_state()
    flat = weights.convert_ultralytics_state_dict(state)
    np.savez(d / "converted.npz", **flat)
    torch.save({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in state.items()},
               d / "plain.pt")
    _pickled_model(state, str(d / "pickled.pth"))
    return state, d


def test_conversion_equals_the_reference_bit_for_bit(files):
    from flax import traverse_util

    state, _ = files
    got = weights.convert_ultralytics_state_dict(state)
    want = traverse_util.flatten_dict(jax_weights.convert_ultralytics_state_dict(state),
                                      sep="/")
    assert set(got) == set(want) and len(got) > 200
    for k, v in want.items():
        assert got[k].dtype == np.asarray(v).dtype and np.array_equal(got[k], v), k
    with pytest.raises(ValueError, match="not consumed"):
        weights.convert_ultralytics_state_dict({**state, "model.23.extra.weight": state[
            "model.0.conv.weight"]})


def _detector(path: str, **kw) -> Detector:
    cfg = dict(model="yolov8n", num_classes=NC, input_size=SIZE, weights=path, half=False,
               conf_threshold=0.05, classes=None)
    return Detector(DetectionConfig(**{**cfg, **kw}), device="cpu", warmup=False)


def _frames() -> list[np.ndarray]:
    return [moving_boxes_frame(t, 144, 256, 6)[0] for t in (0, 5)]


def _same(a, b) -> bool:
    return (np.array_equal(a.xyxy, b.xyxy) and np.array_equal(a.confidence, b.confidence)
            and np.array_equal(a.class_id, b.class_id))


@pytest.mark.parametrize("name", ["plain.pt", "pickled.pth"])
def test_pt_weights_detect_as_the_converted_npz(files, name):
    _, d = files
    want = _detector(str(d / "converted.npz"))
    got = _detector(str(d / name))
    assert weights.load_params(str(d / name)).keys() == weights.load_npz(
        str(d / "converted.npz")).keys()
    n = 0
    for frame in _frames():
        a, b = got.detect(frame), want.detect(frame)
        assert _same(a, b)
        n += len(a)
    assert n > 0


def test_save_npz_loads_into_the_jax_detector(files, tmp_path):
    """The round trip is exact (the ``.pt``'s weights come back as the
    converted ``.npz``), and rich640d written by ``save_npz`` detects in the
    JAX ``Detector`` as in the port's."""
    _, d = files
    out = str(tmp_path / "saved.npz")
    weights.save_npz(_detector(str(d / "plain.pt"), fuse_bn=False).model, out)
    saved, converted = weights.load_npz(out), weights.load_npz(str(d / "converted.npz"))
    assert saved.keys() == converted.keys()
    assert all(np.array_equal(saved[k], converted[k]) for k in saved)

    trained = dict(model="yolov8s", num_classes=NC, input_size=256, half=False,
                   conf_threshold=0.3, classes=None)
    port = Detector(DetectionConfig(weights=WEIGHTS, fuse_bn=False, **trained), device="cpu",
                    warmup=False)
    out = str(tmp_path / "rich640d.npz")
    weights.save_npz(port.model, out)
    ref = JaxDetector(JaxDetectionConfig(weights=out, **trained), warmup=False)
    n = 0
    for t in (0, 9):
        frame = moving_boxes_frame(t, 288, 512, 8)[0]
        a, b = port.detect(frame), ref.detect(frame)
        assert len(a) == len(b) and np.array_equal(a.class_id, b.class_id)
        np.testing.assert_allclose(a.xyxy, b.xyxy, rtol=0, atol=BOX_ATOL)
        np.testing.assert_allclose(a.confidence, b.confidence, rtol=0, atol=SCORE_ATOL)
        n += len(a)
    assert n > 4
    with pytest.raises(ValueError, match="quantized"):
        weights.save_npz(_detector(str(d / "plain.pt"), quant="int8", calib_frames=1).model,
                         str(tmp_path / "q.npz"))


def test_verify_parity_tool_runs_and_skips(tmp_path, capsys):
    from tools.verify_parity_torch import main

    out = tmp_path / "parity.json"
    assert main(["--weights", WEIGHTS, "--num-classes", str(NC), "--input-size", "256",
                 "--out", str(out), "--cpu"]) == 0
    report = json.loads(out.read_text())
    assert report["n_images"] == 6
    fused = report["diffs"][0]
    assert fused["b"] == "fp32_bn_fused" and fused["total_unmatched"] == 0
    assert fused["max_box_delta_px"] < 0.05
    assert "unavailable" in report["ultralytics_parity"]
    assert "verify_parity_torch: OK" in capsys.readouterr().out
    assert main(["--weights", str(tmp_path / "missing.npz"), "--cpu"]) == 0
    assert "SKIP" in capsys.readouterr().out


def test_orbax_directories_and_unknown_formats_are_refused(tmp_path):
    with pytest.raises(ValueError, match="orbax"):
        weights.load_params(str(tmp_path))
    with pytest.raises(ValueError, match="unrecognized"):
        weights.load_params(str(tmp_path / "w.onnx"))
