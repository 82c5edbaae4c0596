"""The slice end to end: the port's live ``Pipeline.run`` on the CPU against
the JAX package.

One 25-fps clip written by ``write_synthetic_video`` (16 frames of 512x288)
goes through both packages with the repository's trained rich640d weights at
a 256 px input in float32, zone events and the renderer on:

  * per-stage (``profiling.per_stage: true``): the port's ``Pipeline.run``
    against the JAX package's own ``Pipeline.run``; their stages are the same
    functions (BGR letterbox, forward, NMS from logits, unletterbox,
    ByteTrack);
  * packed per-frame (``per_stage: false``, ``pipeline_depth`` 0 and 2): the
    port's ``run`` against the JAX composition over ``planar_letterbox`` of
    one packed frame at a time, the reference's tracker facade and its
    per-frame zone engine.  Not against the JAX ``step_packed``: that path
    runs the space-to-depth front, which differs on a 1-px border ring.

Per-frame visible track ids and classes must be identical, boxes within
1e-4 px, and the event JSONL identical less the wall-clock
``timestamp_utc`` with ``bbox_xyxy`` within 1e-4 px (the DFL softmax rounds
an ulp differently in XLA and PyTorch, tests/test_torch_port_nms.py).
"""

from __future__ import annotations

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rtmodt_tpu.config.loader import ByteTrackConfig as JaxByteTrackConfig
from rtmodt_tpu.config.loader import load_config as jax_load_config
from rtmodt_tpu.events.zone_engine import ZoneEventEngine as JaxZoneEventEngine
from rtmodt_tpu.ingestion.rtsp_reader import RTSPReader as JaxReader
from rtmodt_tpu.models.weights import fuse_bn as jax_fuse_bn
from rtmodt_tpu.models.weights import load_npz as jax_load_npz
from rtmodt_tpu.models.yolov8 import build_model as jax_build
from rtmodt_tpu.ops.nms import batched_nms_from_logits as jax_nms
from rtmodt_tpu.ops.yuv import pack_chunk as jax_pack_chunk
from rtmodt_tpu.ops.yuv import packed_meta as jax_packed_meta
from rtmodt_tpu.ops.yuv import planar_letterbox as jax_planar_letterbox
from rtmodt_tpu.ops.yuv import unletterbox_boxes_packed as jax_unletterbox
from rtmodt_tpu.runtime.pipeline import Pipeline as JaxPipeline
from rtmodt_tpu.tracking.tracker import MultiObjectTracker as JaxTracker
from rtmodt_tpu.utils.coco_names import COCO_NAMES
from rtmodt_tpu_torch.config import load_config
from rtmodt_tpu_torch.ops import nms_kernel
from rtmodt_tpu_torch.runtime.pipeline import Pipeline
from rtmodt_tpu_torch.utils.synthetic import write_synthetic_video

H, W, SIZE, N_FRAMES, FPS = 288, 512, 256, 16, 25.0
CLASSES = [0, 1, 2, 3, 5, 7]
BOX_ATOL = 1e-4
WEIGHTS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "checkpoints", "rich640d", "ema_final.npz")
ZONES = [
    {"name": "left_half", "polygon": [[0, 0], [256, 0], [256, 288], [0, 288]],
     "trigger": "intrusion", "dwell_time_sec": 0.12, "cooldown_sec": 0.2},
    {"name": "gate", "polygon": [[120, 0], [512, 0], [512, 288], [120, 288]],
     "trigger": "crossing", "cooldown_sec": 1.0},
]


def overrides(log_path: str, **profiling) -> dict:
    """Config shared by both packages' loaders."""
    return {
        "system": {"device": "cpu"},
        "detection": {"model": "yolov8s", "input_size": SIZE, "num_classes": 8,
                      "weights": WEIGHTS, "half": False, "classes": CLASSES},
        "events": {"zones": ZONES, "alert": {"backend": "json_file", "log_path": log_path}},
        "profiling": {"warmup_frames": 2, "log_interval": 0, **profiling},
        "visualization": {"enabled": True, "save_video": False},
    }


def record(tracker) -> list:
    """Wrap a facade's ``tracks_from_outputs`` (every per-frame path calls
    it once per frame) to keep each frame's visible (id, class, box)."""
    frames = []
    inner = tracker.tracks_from_outputs

    def wrapped(outputs, names):
        tracks = inner(outputs, names)
        frames.append([(t.track_id, t.class_id, np.asarray(t.xyxy, np.float32))
                       for t in tracks])
        return tracks

    tracker.tracks_from_outputs = wrapped
    return frames


def events(path: str) -> list[dict]:
    with open(path) as f:
        out = [json.loads(line) for line in f]
    for e in out:
        e.pop("timestamp_utc")
    return out


def assert_same_run(got_frames, got_log, want_frames, want_log):
    assert len(got_frames) == len(want_frames) == N_FRAMES
    n_visible = 0
    for g, w in zip(got_frames, want_frames):
        assert [(tid, cls) for tid, cls, _ in g] == [(tid, cls) for tid, cls, _ in w]
        for (_, _, gb), (_, _, wb) in zip(g, w):
            np.testing.assert_allclose(gb, wb, rtol=0, atol=BOX_ATOL)
        n_visible += len(g)
    assert n_visible > N_FRAMES
    got, want = events(got_log), events(want_log)
    assert len(want) > 0 and len(got) == len(want)
    got_boxes = np.array([e.pop("bbox_xyxy") for e in got])
    want_boxes = np.array([e.pop("bbox_xyxy") for e in want])
    assert got == want
    np.testing.assert_allclose(got_boxes, want_boxes, rtol=0, atol=BOX_ATOL)


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("clip") / "clip25.mp4")
    write_synthetic_video(path, frames=N_FRAMES, h=H, w=W, n_objects=6, fps=FPS, seed=1)
    return path


@pytest.fixture(scope="module")
def jax_per_stage(clip, tmp_path_factory):
    log = str(tmp_path_factory.mktemp("ev") / "jax.jsonl")
    pipe = JaxPipeline(jax_load_config(overrides=overrides(log, per_stage=True)))
    frames = record(pipe.tracker)
    pipe.run(clip)
    return frames, log, pipe.events.zone_counts()


@pytest.fixture(scope="module")
def jax_planar(clip, tmp_path_factory):
    """The JAX composition over ``planar_letterbox``, one packed frame at a
    time, with the reference's facade and per-frame zone engine."""
    log = str(tmp_path_factory.mktemp("ev") / "jax_planar.jsonl")
    model = jax_build("yolov8s", num_classes=8, dtype=jnp.float32, fused=True)
    params = jax_fuse_bn(jax.device_get(jax_load_npz(WEIGHTS)))
    mask = jnp.asarray(np.isin(np.arange(8), CLASSES))
    geom = jax_packed_meta(H, W, SIZE)

    @jax.jit
    def detect(y, u, v):
        img = jax_planar_letterbox(y[0], u[0], v[0], SIZE, geom.pad_left, geom.pad_top,
                                   dtype=jnp.float32)
        box_dist, cls = model.apply(params, img[None], train=False)
        res = jax_nms(box_dist[0], cls[0], SIZE, 0.35, 0.45, 100, 300, mask)
        return res._replace(boxes=jax_unletterbox(res.boxes, geom))

    tracker = JaxTracker("bytetrack", trail_length=30, bytetrack=JaxByteTrackConfig())
    cfg = jax_load_config(overrides=overrides(log))
    engine = JaxZoneEventEngine.from_config(cfg.events, trail_length=30)
    names = list(COCO_NAMES)[:8]
    frames = record(tracker)
    with JaxReader(clip) as reader:
        last = 0
        while True:
            frame, fid, ts = reader.read_new(last, timeout=5.0)
            if frame is None:
                assert reader.is_eof
                break
            last = fid
            (y, u, v), _ = jax_pack_chunk(frame[None], SIZE)
            res = detect(jnp.asarray(y), jnp.asarray(u), jnp.asarray(v))
            tracker.state, outputs = tracker._step(tracker.state, res.boxes, res.scores,
                                                   res.classes, res.valid)
            engine.process(tracker.tracks_from_outputs(outputs, names), fid, ts)
    return frames, log, engine.zone_counts()


def test_per_stage_run_matches_the_jax_pipeline(clip, jax_per_stage, tmp_path):
    log = str(tmp_path / "port.jsonl")
    pipe = Pipeline(load_config(overrides=overrides(log, per_stage=True)))
    assert pipe.device.type == "cpu"                 # system.device: cpu
    frames = record(pipe.tracker)
    before = nms_kernel.launches
    summary = pipe.run(clip, max_frames=0)           # 0: no limit
    assert nms_kernel.launches == before             # the CPU runs the plain version
    assert pipe.profiler.frame_count == N_FRAMES
    assert {"preprocess_mean_ms", "inference_p95_ms", "nms_p99_ms", "tracking_mean_ms",
            "events_mean_ms", "visualization_mean_ms", "fps_mean"} <= set(summary)
    assert_same_run(frames, log, jax_per_stage[0], jax_per_stage[1])
    assert pipe.events.zone_counts() == jax_per_stage[2]


@pytest.mark.parametrize("depth", [0, 2])
def test_packed_per_frame_run_matches_the_jax_planar_composition(clip, jax_planar, tmp_path,
                                                                 depth):
    log = str(tmp_path / "port.jsonl")
    cfg = load_config(overrides={**overrides(log, per_stage=False),
                                 "parallel": {"pipeline_depth": depth}})
    pipe = Pipeline(cfg)
    frames = record(pipe.tracker)
    pipe.run(clip)
    assert pipe.chunks_submitted == N_FRAMES          # one program per frame
    assert_same_run(frames, log, jax_planar[0], jax_planar[1])
    assert pipe.events.zone_counts() == jax_planar[2]


def test_run_saves_the_annotated_video_and_stops_at_max_frames(clip, tmp_path):
    import cv2

    video = str(tmp_path / "out" / "annotated.mp4")
    cfg = load_config(overrides={**overrides(str(tmp_path / "ev.jsonl"), per_stage=True),
                                 "visualization": {"enabled": True, "save_video": True,
                                                   "save_path": video}})
    pipe = Pipeline(cfg)
    pipe.run(clip, max_frames=5)
    assert pipe.profiler.frame_count == 5
    cap = cv2.VideoCapture(video)
    n = 0
    while cap.read()[0]:
        n += 1
    assert n == 5 and cap.get(cv2.CAP_PROP_FPS) == FPS   # codec and fps from the reader
    cap.release()


def test_run_takes_the_chunked_path_when_nothing_per_frame_is_asked(clip, tmp_path):
    cfg = load_config(overrides={**overrides(str(tmp_path / "ev.jsonl"), per_stage=False),
                                 "visualization": {"enabled": False},
                                 "parallel": {"chunk_size": 4}})
    summary = Pipeline(cfg).run(clip)
    assert summary["frames"] == N_FRAMES and summary["chunks"] == N_FRAMES // 4


def test_warmup_leaves_no_tracks_behind(tmp_path):
    """Warmup's dummy frames leave no track: on a fresh pipeline the state
    stays empty, and a state that holds a real track (or one restored from
    a snapshot) is put back as warmup found it."""
    pipe = Pipeline(load_config(overrides=overrides(str(tmp_path / "ev.jsonl"),
                                                    per_stage=True)))
    pipe.warmup((H, W))
    assert not bool(pipe.tracker.state.active.any())
    assert int(pipe.tracker.state.next_id) == 1
    frame = np.full((H, W, 3), 30, np.uint8)
    frame[100:200, 150:260] = (40, 200, 90)
    pipe.step(frame, 1, 0.0)
    assert bool(pipe.tracker.state.active.any())
    found = [t.clone() for t in pipe.tracker.state]
    before = nms_kernel.launches
    pipe.warmup((H, W))
    assert all(bool((a == b).all()) for a, b in zip(pipe.tracker.state, found))
    assert nms_kernel.launches == before
