"""The offline tool ``tools/run_inference_torch.py`` and its host modules on
the CPU, against the JAX package's.

``tracking/postprocess.py``, ``evaluation/coco_eval.py`` and
``evaluation/metrics.py`` are numpy copies: on seeded rows and boxes their
results must equal the reference's exactly.  The tool's ``track`` and
``detect`` subcommands run the trained rich640d weights at 256 px on both
sides (``--cpu`` for the port), in float32, on a dense synthetic image
sequence with its ground truth.  ``track`` rows: the same frames and ids,
boxes within 1e-3 px plus one step of the file's 0.01 px rounding (a box that differs by the
DFL softmax's ulp, ~3e-5 px, can round to the other side of a 0.005
boundary); the metrics of ``--gt-mot``: counts equal, rates within 1e-3.
``detect`` predictions: ids and categories equal, boxes within 1e-4 px,
scores within 1e-5 (``tests/test_torch_port_detector.py``).
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import pytest

from rtmodt_tpu.evaluation import coco_eval as jax_coco
from rtmodt_tpu.evaluation import metrics as jax_metrics
from rtmodt_tpu.tracking import postprocess as jax_post
from rtmodt_tpu_torch.evaluation import coco_eval, metrics
from rtmodt_tpu_torch.tracking import postprocess
from rtmodt_tpu_torch.utils.synthetic import dense_moving_scene

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHTS = os.path.join(ROOT, "checkpoints", "rich640d", "ema_final.npz")
H, W, N_FRAMES, N_OBJECTS = 288, 512, 12, 10
ROW_BOX_ATOL = 1e-3 + 0.01     # one flip of the file's .2f rounding: 1 of 476 values measured
BOX_ATOL, SCORE_ATOL = 1e-4, 1e-5


def _mot_rows(seed: int) -> list[tuple]:
    """Seeded MOT rows: 6 ids over 40 frames, each with random gaps."""
    rng = np.random.default_rng(seed)
    rows = []
    for tid in range(1, 7):
        frames = np.sort(rng.choice(np.arange(1, 41), size=rng.integers(5, 30), replace=False))
        for f in frames:
            x, y = rng.uniform(0, 500, 2)
            rows.append((int(f), tid, float(x), float(y), float(rng.uniform(5, 80)),
                         float(rng.uniform(5, 80)), float(rng.uniform(0.1, 1.0))))
    rng.shuffle(rows)
    return rows


@pytest.mark.parametrize("seed,max_gap", [(0, 20), (1, 5), (2, 1), (3, 40)])
def test_interpolate_mot_rows_equals_reference(seed, max_gap):
    rows = _mot_rows(seed)
    got = postprocess.interpolate_mot_rows(rows, max_gap=max_gap)
    assert got == jax_post.interpolate_mot_rows(rows, max_gap=max_gap)
    assert len(got) > len(rows) or max_gap == 1


def test_mot_row_files_equal_reference(tmp_path):
    rows = _mot_rows(4)
    postprocess.write_mot_rows(str(tmp_path / "port.txt"), rows)
    jax_post.write_mot_rows(str(tmp_path / "ref.txt"), rows)
    assert (tmp_path / "port.txt").read_text() == (tmp_path / "ref.txt").read_text()
    assert (postprocess.load_mot_rows(str(tmp_path / "port.txt"))
            == jax_post.load_mot_rows(str(tmp_path / "ref.txt")))


def _coco(seed: int, crowd: bool) -> tuple[dict, list[dict]]:
    """Seeded COCO GT (3 categories with a gap in the ids, 5 images) and
    predictions: jittered copies of most GT boxes plus false positives."""
    rng = np.random.default_rng(seed)
    cats = [1, 3, 7]
    gt = {"images": [{"id": i, "file_name": f"{i}.jpg"} for i in range(1, 6)],
          "categories": [{"id": c, "name": str(c)} for c in cats], "annotations": []}
    preds = []
    for img in range(1, 6):
        for _ in range(rng.integers(2, 9)):
            x, y, w, h = *rng.uniform(0, 400, 2), *rng.uniform(10, 120, 2)
            c = int(rng.choice(cats))
            gt["annotations"].append({"id": len(gt["annotations"]) + 1, "image_id": img,
                                      "category_id": c, "bbox": [x, y, w, h],
                                      "iscrowd": int(crowd and rng.random() < 0.15)})
            if rng.random() < 0.8:
                j = rng.normal(0, 6, 4)
                preds.append({"image_id": img, "category_id": c,
                              "bbox": [x + j[0], y + j[1], w + j[2], h + j[3]],
                              "score": float(rng.uniform(0.05, 1.0))})
        for _ in range(rng.integers(0, 4)):
            preds.append({"image_id": img, "category_id": int(rng.choice(cats)),
                          "bbox": [*rng.uniform(0, 400, 2), *rng.uniform(10, 120, 2)],
                          "score": float(rng.uniform(0.05, 1.0))})
    return gt, preds


@pytest.mark.parametrize("seed,crowd,iou", [(0, False, 0.5), (1, True, 0.5), (2, True, 0.75),
                                            (3, False, None), (4, True, None)])
def test_coco_eval_equals_reference(seed, crowd, iou):
    gt, preds = _coco(seed, crowd)
    got = coco_eval.COCODetEval(gt, preds).evaluate(iou)
    want = jax_coco.COCODetEval(gt, preds).evaluate(iou)
    assert got == want and 0 < got["mAP"] < 1


def test_metric_functions_equal_reference(tmp_path):
    gt, preds = _coco(5, True)
    (tmp_path / "gt.json").write_text(json.dumps(gt))
    (tmp_path / "pred.json").write_text(json.dumps(preds))
    assert (metrics.evaluate_detection(str(tmp_path / "gt.json"), str(tmp_path / "pred.json"))
            == jax_metrics.evaluate_detection(str(tmp_path / "gt.json"),
                                              str(tmp_path / "pred.json")))
    rows = _mot_rows(6)
    postprocess.write_mot_rows(str(tmp_path / "gt.txt"), rows)
    postprocess.write_mot_rows(str(tmp_path / "pred.txt"),
                               postprocess.interpolate_mot_rows(rows[::2], max_gap=4))
    assert (metrics.evaluate_tracking(str(tmp_path / "gt.txt"), str(tmp_path / "pred.txt"))
            == jax_metrics.evaluate_tracking(str(tmp_path / "gt.txt"),
                                             str(tmp_path / "pred.txt")))
    rng = np.random.default_rng(7)
    g, p = rng.integers(-1, 6, 200), rng.integers(0, 7, 200)
    np.testing.assert_array_equal(metrics.build_confusion_matrix(g, p, 5),
                                  jax_metrics.build_confusion_matrix(g, p, 5))
    cg = {i: [tuple(rng.integers(0, 500, 2)) for _ in range(8)] for i in range(4)}
    cp = {i: [tuple(rng.integers(0, 500, 2)) for _ in range(6)] for i in range(1, 6)}
    assert (metrics.measure_tracking_drift(cg, cp)
            == jax_metrics.measure_tracking_drift(cg, cp))


# -- the tool against tools/run_inference.py ----------------------------------------


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """A dense image sequence with its MOT15 GT and a COCO GT json."""
    import cv2

    d = tmp_path_factory.mktemp("scene")
    img_dir = d / "img"
    img_dir.mkdir()
    gt_rows = []
    coco = {"images": [], "annotations": [],
            "categories": [{"id": c + 1, "name": str(c)} for c in range(8)]}
    for t in range(N_FRAMES):
        frame, boxes, labels, ids = dense_moving_scene(t, H, W, n_objects=N_OBJECTS, seed=5)
        cv2.imwrite(str(img_dir / f"{t + 1:06d}.png"), frame)
        coco["images"].append({"id": t + 1, "file_name": f"{t + 1:06d}.png"})
        for (x1, y1, x2, y2), c, i in zip(boxes, labels, ids):
            gt_rows.append((t + 1, int(i) + 1, x1, y1, x2 - x1, y2 - y1, 1.0))
            coco["annotations"].append({"id": len(coco["annotations"]) + 1,
                                        "image_id": t + 1, "category_id": int(c) + 1,
                                        "bbox": [float(x1), float(y1), float(x2 - x1),
                                                 float(y2 - y1)], "iscrowd": 0})
    postprocess.write_mot_rows(str(d / "gt.txt"), gt_rows)
    (d / "gt.json").write_text(json.dumps(coco))
    return d


@pytest.fixture()
def float32(monkeypatch):
    """Both tools' detectors in float32: they run bf16 by default
    (``detection.half``), whose CPU rounding differs between XLA and
    PyTorch by far more than the float32 tolerances."""
    import rtmodt_tpu.config
    import rtmodt_tpu.config.loader
    import rtmodt_tpu_torch.config
    import rtmodt_tpu_torch.config.loader

    for pkg, loader in ((rtmodt_tpu.config, rtmodt_tpu.config.loader),
                        (rtmodt_tpu_torch.config, rtmodt_tpu_torch.config.loader)):
        inner = pkg.load_config

        def load(path=None, overrides=None, inner=inner, loader=loader):
            return inner(path, loader._deep_merge(overrides or {},
                                                  {"detection": {"half": False}}))

        monkeypatch.setattr(pkg, "load_config", load)
        monkeypatch.setattr(loader, "DetectionConfig", dataclasses.make_dataclass(
            "DetectionConfig", [("half", bool, False)], bases=(loader.DetectionConfig,)))


def _run_both(args: list[str], tmp_path, capsys) -> tuple[dict, dict, str, str]:
    """``args`` through the port's tool (``--cpu``) and the reference's, each
    writing its own ``--out``; returns both printed metric dicts and outputs."""
    from tools import run_inference as ref_tool
    from tools.run_inference_torch import main

    ext = ".json" if args[0] == "detect" else ".txt"
    port_out, ref_out = str(tmp_path / f"port{ext}"), str(tmp_path / f"ref{ext}")
    capsys.readouterr()
    assert main([*args, "--out", port_out, "--cpu"]) == 0
    port_json = json.loads(capsys.readouterr().out)
    ref_tool.main.main(args=[*args, "--out", ref_out], standalone_mode=False)
    ref_json = json.loads(capsys.readouterr().out)
    return port_json, ref_json, port_out, ref_out


def test_track_equals_reference(scene, tmp_path, capsys, float32):
    args = ["track", "--video", str(scene / "img"), "--weights", WEIGHTS,
            "--num-classes", "8", "--input-size", "256", "--track-thresh", "0.3",
            "--interpolate", "5", "--gt-mot", str(scene / "gt.txt")]
    got_m, want_m, port_out, ref_out = _run_both(args, tmp_path, capsys)
    got, want = postprocess.load_mot_rows(port_out), postprocess.load_mot_rows(ref_out)
    assert len(got) == len(want) > N_FRAMES
    assert [r[:2] for r in got] == [r[:2] for r in want]
    np.testing.assert_allclose([r[2:6] for r in got], [r[2:6] for r in want],
                               rtol=0, atol=ROW_BOX_ATOL)
    np.testing.assert_allclose([r[6] for r in got], [r[6] for r in want], rtol=0, atol=1e-3)
    assert set(got_m) == set(want_m) and want_m["idf1"] > 0.5
    for k, v in want_m.items():
        if isinstance(v, int):
            assert got_m[k] == v, k
        else:
            assert abs(got_m[k] - v) <= 1e-3, k


def test_detect_equals_reference(scene, tmp_path, capsys, float32):
    args = ["detect", "--images", str(scene / "img"), "--gt-json", str(scene / "gt.json"),
            "--weights", WEIGHTS, "--num-classes", "8", "--input-size", "256",
            "--conf", "0.25", "--evaluate"]
    got_m, want_m, port_out, ref_out = _run_both(args, tmp_path, capsys)
    with open(port_out) as f:
        got = json.load(f)
    with open(ref_out) as f:
        want = json.load(f)
    assert len(got) == len(want) > N_FRAMES
    assert [(p["image_id"], p["category_id"]) for p in got] == \
        [(p["image_id"], p["category_id"]) for p in want]
    np.testing.assert_allclose([p["bbox"] for p in got], [p["bbox"] for p in want],
                               rtol=0, atol=BOX_ATOL)
    np.testing.assert_allclose([p["score"] for p in got], [p["score"] for p in want],
                               rtol=0, atol=SCORE_ATOL)
    assert set(got_m) == set(want_m) and want_m["mAP"] > 0.3
    for k, v in want_m.items():
        assert abs(got_m[k] - v) <= 1e-6, k


@pytest.mark.parametrize("args,match", [
    (["detect", "--images", ".", "--quant", "int8"], "ROADMAP item 10"),
    (["detect", "--images", ".", "--quant-scales", "s.npz"], "requires --quant int8"),
])
def test_unported_options_exit_nonzero(args, match):
    from tools.run_inference_torch import main

    with pytest.raises(SystemExit) as exc:
        main([*args, "--cpu"])
    assert match in str(exc.value.code)
