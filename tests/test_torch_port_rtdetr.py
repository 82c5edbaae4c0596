"""RT-DETR-L in the port (``models/rtdetr.py``) on the CPU, in float32.

* A narrow build (HGNetv2 at a sixteenth of the widths, hd 64, 2 heads, 2
  decoder layers, 60 queries, input 160) on seeded weights
  (``perfbench/archs/rtdetr.py::seeded_weights``, Ultralytics' names)
  against the plain reference ``perfbench/reference/rtdetr.py`` on random
  images, before the gate: the encoder's class scores over every anchor,
  the selected anchors, and every decoder layer's boxes and logits within
  1e-4 (both sides compute in float32 with different summation orders and
  the program folds BN: their gaps are ~1e-6, a hundredth of the
  tolerance), with BN folded and not, over the whole input and inside a
  letterbox's content box.  Then the output step's ``NMSResult`` against
  the reference's ``detect``.
* Weights under Ultralytics' names from the seeded ``.npz`` and from a
  ``.pt`` checkpoint load alike; a missing leaf is refused.
* The published build: its parameter count (Ultralytics' 32,970,476), its
  state dict against the harness's layer list, the configuration file's
  widths against ``RTDETR_VARIANTS``, and ``forward_flops``.
* One chunk of 2 streams x T 2 through ``MultiStreamPipeline`` equals
  ``Pipeline.detect_chunk`` on the same planes, and its detections enter
  the tracker.
* The spans and counters with the span recorder on, none with it off.
* int8, training and export refuse RT-DETR; a YOLOv8 pipeline imports
  neither ``models/rtdetr.py`` nor ``ops/msdeform.py``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from perfbench.archs import rtdetr as arch
from perfbench.reference import rtdetr as ref
from rtmodt_tpu_torch.config import load_config
from rtmodt_tpu_torch.models import rtdetr
from rtmodt_tpu_torch.ops.yuv import pack_chunk, packed_meta
from rtmodt_tpu_torch.parallel.multistream import MultiStreamPipeline
from rtmodt_tpu_torch.profiling import spans
from rtmodt_tpu_torch.runtime.pipeline import Pipeline
from rtmodt_tpu_torch.utils.synthetic import moving_boxes_frame
from tests.test_torch_port_threads import child_env, torch_threads  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "perfbench", "configs", "rtdetr-l-640.json")
ATOL = 1e-4
SIZE = 160
SMALL = {"nc": 8, "stem": [8, 16],
         "blocks": [[8, 16, 3, False, False], [16, 32, 3, False, False],
                    [16, 64, 5, True, False], [16, 64, 5, True, True],
                    [16, 64, 5, True, True], [32, 128, 5, True, False]],
         "block_convs": 2, "neck": 32, "aifi_ffn": 64, "aifi_heads": 2, "repc3": 1,
         "hidden_dim": 64, "num_queries": 60, "num_heads": 2, "num_levels": 3,
         "num_points": 4, "num_decoder_layers": 2, "dim_feedforward": 128,
         "pipeline": {"detection": {"input_size": SIZE}}}
SPEC_KEYS = ("block_convs", "neck", "aifi_ffn", "aifi_heads", "repc3", "hidden_dim",
             "num_queries", "num_heads", "num_points", "num_decoder_layers", "dim_feedforward")


def spec_of(conf: dict) -> rtdetr.RTDETRSpec:
    return rtdetr.RTDETRSpec(stem=tuple(conf["stem"]),
                             blocks=tuple(tuple(b) for b in conf["blocks"]),
                             **{k: conf[k] for k in SPEC_KEYS})


FULL = (0.0, 0.0, 1.0, 1.0)
LETTERBOX = rtdetr.content_box(0, 40, SIZE, 80, SIZE)      # 160 x 80 content


def plain_model(path: str, content=FULL) -> ref.PlainRTDETR:
    return ref.PlainRTDETR(path, torch.device("cpu"), SMALL["num_heads"], SMALL["aifi_heads"],
                           SMALL["num_queries"], content)


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    path = arch.seeded_weights(SMALL, 5, str(tmp_path_factory.mktemp("w") / "small"), "cpu")
    model = rtdetr.RTDETR(SMALL["nc"], spec_of(SMALL))
    rtdetr.load_state(model, dict(np.load(path)))
    x = torch.rand(3, 3, SIZE, SIZE, generator=torch.Generator().manual_seed(11))
    want: dict = {}
    plain = plain_model(path)
    plain.forward(x, want)
    return model.eval(), x, want, plain, path


@pytest.mark.parametrize("fused,content", [(False, FULL), (True, FULL), (True, LETTERBOX)])
def test_small_build_matches_the_plain_reference_before_the_gate(small, fused, content):
    model, x, want, _, path = small
    if fused:
        model = rtdetr.RTDETR(SMALL["nc"], spec_of(SMALL))
        model.load_state_dict(small[0].state_dict())
        model.eval().fuse_bn()
    if content != FULL:
        want = {}
        plain_model(path, content).forward(x, want)
        # no query from the padding rows (anchor centres outside the content)
        a, _ = rtdetr.anchors_logit(((20, 20), (10, 10), (5, 5)), torch.device("cpu"), content)
        cy = torch.sigmoid(a[want["topk"], 1])
        assert ((cy > 0.25) & (cy < 0.75)).all()
    got: dict = {}
    with torch.no_grad():
        boxes, logits = model(x, got, content)
    assert got["enc_scores"].shape == (3, 20 * 20 + 10 * 10 + 5 * 5, SMALL["nc"])
    torch.testing.assert_close(got["enc_scores"], want["enc_scores"], atol=ATOL, rtol=0)
    assert torch.equal(got["topk"].sort(1).values, want["topk"].sort(1).values)
    assert len(got["layers"]) == len(want["layers"]) == SMALL["num_decoder_layers"]
    for (gb, gl), (wb, wl) in zip(got["layers"], want["layers"]):
        torch.testing.assert_close(gb, wb, atol=ATOL, rtol=0)
        torch.testing.assert_close(gl, wl, atol=ATOL, rtol=0)
    assert torch.equal(boxes, got["layers"][-1][0]) and torch.equal(logits, got["layers"][-1][1])


def test_small_build_output_step_matches_the_reference(small):
    model, x, want, plain, _ = small
    with torch.no_grad():
        boxes, logits = model(x)
    # a gate that a few queries a frame clear, and a cut below the kept count
    probs = torch.sigmoid(want["layers"][-1][1]).amax(-1)
    det = {"conf_threshold": float(probs.flatten().sort().values[-12]), "max_detections": 5,
           "classes": None}
    got = rtdetr.detections(boxes, logits, SIZE, det["conf_threshold"], det["max_detections"])
    exp = ref.detect(plain, x, det)
    assert int(got.count.sum()) == int(exp["valid"].sum()) > 0
    assert torch.equal(got.valid, exp["valid"])
    assert torch.equal(got.classes.long(), exp["classes"].long())
    torch.testing.assert_close(got.scores, exp["scores"], atol=1e-5, rtol=0)
    torch.testing.assert_close(got.boxes, exp["boxes"], atol=SIZE * ATOL, rtol=0)
    assert torch.equal(got.count, got.valid.sum(1).int())
    # classes as a mask on the best class, padding past the queries
    keep = int(exp["classes"][exp["valid"]][0])
    mask = torch.zeros(SMALL["nc"], dtype=torch.bool)
    mask[keep] = True
    only = rtdetr.detections(boxes, logits, SIZE, det["conf_threshold"], 70, mask)
    exp = ref.outputs(*plain.forward(x), SIZE, {**det, "classes": [keep], "max_detections": 70})
    assert only.boxes.shape == (3, 70, 4) and torch.equal(only.valid, exp["valid"])
    assert (only.classes[only.valid] == keep).all() and (only.classes[~only.valid] == -1).all()


def test_weights_load_from_npz_and_pt_under_ultralytics_names(small, tmp_path):
    from rtmodt_tpu_torch.models.weights import load_rtdetr_state

    model, x, _, _, path = small
    pt = str(tmp_path / "rtdetr-small.pt")
    torch.save({"model": {k: v.clone() for k, v in model.state_dict().items()}}, pt)
    with torch.no_grad():
        want = model(x)
    for f in (path, pt):
        other = rtdetr.RTDETR(SMALL["nc"], spec_of(SMALL))
        rtdetr.load_state(other, load_rtdetr_state(f))
        with torch.no_grad():
            got = other.eval()(x)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    with pytest.raises(ValueError, match="missing"):
        rtdetr.load_state(other, {k: v for k, v in load_rtdetr_state(path).items()
                                  if "dec_score_head" not in k})


def test_published_build_sizes():
    conf = json.load(open(CONFIG))
    assert spec_of(conf) == rtdetr.RTDETR_VARIANTS["rtdetr-l"] and conf["num_levels"] == 3
    model = rtdetr.build_model("rtdetr-l", conf["nc"])
    assert sum(p.numel() for p in model.parameters()) == 32_970_476
    own = {k: tuple(v.shape) for k, v in model.state_dict().items()
           if not k.endswith("num_batches_tracked")}
    assert own == dict(arch.leaves(conf))
    assert arch.forward_flops(conf) == 109_591_347_200
    with pytest.raises(KeyError, match="unknown model"):
        rtdetr.build_model("rtdetr-x")


def _frames(n: int, s: int, h: int, w: int) -> np.ndarray:
    return np.stack([np.stack([moving_boxes_frame(t + 3 * i, h, w, 6, seed=i + 1)[0]
                               for i in range(s)]) for t in range(n)])


def test_multistream_chunk_equals_detect_chunk():
    h, w, s, t = 288, 512, 2, 2
    cfg = load_config(overrides={
        "system": {"device": "cpu"},
        "detection": {"model": "rtdetr-l", "num_classes": 80, "input_size": SIZE,
                      "half": False, "conf_threshold": 0.2},
        "events": {"enabled": False}, "visualization": {"enabled": False},
        "profiling": {"per_stage": False, "log_interval": 0}})
    msp = MultiStreamPipeline(cfg, num_streams=s, seed=3)
    (y, u, v), _ = pack_chunk(_frames(t, s, h, w).reshape(t * s, h, w, 3), SIZE)
    outs, got = msp.submit_chunk_packed(tuple(p.reshape(t, s, *p.shape[1:]) for p in (y, u, v)),
                                        h, w)
    pipe = Pipeline(cfg, device="cpu", seed=3)
    want = pipe.detect_chunk(*(torch.from_numpy(p) for p in (y, u, v)), packed_meta(h, w, SIZE))
    assert got.boxes.shape == (t, s, cfg.detection.max_detections, 4)
    for g, e in zip(got, want):
        torch.testing.assert_close(g.reshape(e.shape), e, atol=0, rtol=0)
    assert outs.visible.shape == (t, s, msp.tracker.cfg.max_tracks)
    assert msp.tracker.eager_chunks == {"device": 1}


def test_detector_and_run_chunked_take_rtdetr():
    h, w = 288, 512
    cfg = load_config(overrides={
        "system": {"device": "cpu"},
        "detection": {"model": "rtdetr-l", "num_classes": 80, "input_size": SIZE,
                      "half": False, "conf_threshold": 0.02, "classes": None},
        "events": {"enabled": False}, "visualization": {"enabled": False},
        "profiling": {"per_stage": False, "log_interval": 0},
        "parallel": {"chunk_size": 2, "pipeline_depth": 1}})
    frames = [f[0] for f in _frames(4, 1, h, w)]
    pipe = Pipeline(cfg, device="cpu", seed=4)
    summary = pipe.run_chunked(frames, fps=25.0)
    assert summary["frames"] == 4 and summary["chunks"] == 2
    dets = pipe.detector.detect(frames[0])
    assert len(dets) > 0 and dets.xyxy.shape == (len(dets), 4)
    assert (dets.xyxy[:, [0, 2]] <= w).all() and (dets.xyxy[:, [1, 3]] <= h).all()
    # the per-frame path picks the same queries as the chunk path
    y, u, v = (torch.from_numpy(p) for p in pack_chunk(frames[0][None], SIZE)[0])
    chunk = pipe.detect_chunk(y, u, v, packed_meta(h, w, SIZE))
    assert int(chunk.count[0]) == len(dets)


def test_spans_and_counters_with_the_recorder_on_and_off(small):
    model, x = small[:2]
    spans.drain()
    spans.drain_counts()
    with torch.no_grad():
        model(x)
    assert spans.drain() == [] and spans.drain_counts() == {}
    spans.enable()
    try:
        with torch.no_grad():
            model(x)
    finally:
        spans.disable()
    got = spans.drain()
    assert [(p.name, p.parent) for p in got] == [("backbone", None), ("encoder", None),
                                                 ("decoder", None)]
    n = SMALL["num_decoder_layers"]
    assert spans.drain_counts() == {
        "msdeform_launches": n,
        "msdeform_points": n * 3 * SMALL["num_queries"] * SMALL["num_heads"] * 3 * 4}


def test_int8_training_and_export_refuse_rtdetr(tmp_path):
    from rtmodt_tpu_torch.config.loader import DetectionConfig
    from rtmodt_tpu_torch.detection.detector import Detector
    from rtmodt_tpu_torch.training.trainer import Trainer
    from tools.export_model_torch import export

    with pytest.raises(ValueError, match="quantizes YOLOv8 only"):
        Detector(DetectionConfig(model="rtdetr-l", quant="int8", input_size=SIZE),
                 device="cpu", warmup=False)
    with pytest.raises(ValueError, match="covers YOLOv8 only"):
        Trainer({"model": "rtdetr-l", "num_classes": 80}, device="cpu")
    with pytest.raises(ValueError, match="export writes YOLOv8 only"):
        export("rtdetr-l", seed=0, out=str(tmp_path / "x.npz"), device="cpu")


def test_a_yolov8_pipeline_imports_no_rtdetr_module():
    probe = ("import json, sys\n"
             "from rtmodt_tpu_torch.config import load_config\n"
             "from rtmodt_tpu_torch.parallel.multistream import MultiStreamPipeline\n"
             "cfg = load_config(overrides={'system': {'device': 'cpu'}, 'detection': "
             "{'model': 'yolov8n', 'input_size': 64, 'half': False}})\n"
             "MultiStreamPipeline(cfg, num_streams=2)\n"
             "print(json.dumps(sorted(k for k in sys.modules if k.endswith(('rtdetr', "
             "'msdeform')) or k.split('.')[0] in ('jax', 'rtmodt_tpu'))))\n")
    env = {k: v for k, v in child_env().items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, capture_output=True,
                          text=True, timeout=240, env=env)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []
