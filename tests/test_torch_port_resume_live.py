"""Kill-and-resume on the per-frame paths (``Pipeline.run``), the port against
its own and the JAX package's uninterrupted runs.

One 25-fps clip (16 frames of 512x288) with the trained rich640d weights at
256 px in float32, zone events on.  The port runs half of it with a snapshot
every 4 frames, then a fresh ``Pipeline`` restores the snapshot and runs the
rest of the file: its event log (and the per-frame tracks of the second
half) must equal the uninterrupted runs'.

  * Per stage (``profiling.per_stage: true``): against the port's and the
    JAX package's own uninterrupted ``Pipeline.run``.  This is the path on
    which the JAX package's resumed run differs from its uninterrupted one:
    its ``warmup`` on the first frame resets the tracker it has just
    restored.  The port's ``warmup`` puts the restored state back.
  * Packed per frame (``per_stage: false``, two frames in flight):
    against the port's uninterrupted run and the JAX composition over
    ``planar_letterbox`` of one packed frame at a time (as in
    tests/test_torch_port_live.py).

Logs: identical less the wall-clock ``timestamp_utc``, ``bbox_xyxy`` within
1e-4 px; ``zone_counts`` equal.
"""

from __future__ import annotations

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

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
from rtmodt_tpu_torch.runtime.pipeline import Pipeline
from rtmodt_tpu_torch.utils.synthetic import write_synthetic_video

H, W, SIZE, N_FRAMES, HALF, FPS = 288, 512, 256, 16, 8, 25.0
CLASSES = [0, 1, 2, 3, 5, 7]
BOX_ATOL = 1e-4
WEIGHTS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "checkpoints", "rich640d", "ema_final.npz")


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads while this module runs: the suite runs several
    workers on one host, and models at this size gain little from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def overrides(log_path: str, per_stage: bool, depth: int = 0) -> dict:
    return {
        "system": {"device": "cpu"},
        "detection": {"model": "yolov8s", "input_size": SIZE, "num_classes": 8,
                      "weights": WEIGHTS, "half": False, "classes": CLASSES},
        "events": {"zones": [
            {"name": "left_half", "polygon": [[0, 0], [256, 0], [256, 288], [0, 288]],
             "trigger": "intrusion", "dwell_time_sec": 0.12, "cooldown_sec": 0.2},
            {"name": "gate", "polygon": [[120, 0], [512, 0], [512, 288], [120, 288]],
             "trigger": "crossing", "direction": "left_to_right", "cooldown_sec": 1.0}],
            "alert": {"backend": "json_file", "log_path": log_path}},
        "profiling": {"per_stage": per_stage, "warmup_frames": 2, "log_interval": 0},
        "parallel": {"pipeline_depth": depth},
        "visualization": {"enabled": True, "save_video": False},
    }


def record(tracker) -> list:
    """Each frame's visible (id, class, box) through the facade."""
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


def assert_same(got_log: str, want_log: str, got_frames=None, want_frames=None) -> None:
    got, want = events(got_log), events(want_log)
    assert len(want) > 0 and len(got) == len(want)
    got_boxes = np.array([e.pop("bbox_xyxy") for e in got])
    want_boxes = np.array([e.pop("bbox_xyxy") for e in want])
    assert got == want
    np.testing.assert_allclose(got_boxes, want_boxes, rtol=0, atol=BOX_ATOL)
    if got_frames is not None:
        assert len(got_frames) == len(want_frames)
        for g, w in zip(got_frames, want_frames):
            assert [(tid, cls) for tid, cls, _ in g] == [(tid, cls) for tid, cls, _ in w]
            for (_, _, gb), (_, _, wb) in zip(g, w):
                np.testing.assert_allclose(gb, wb, rtol=0, atol=BOX_ATOL)


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("clip") / "clip25.mp4")
    write_synthetic_video(path, frames=N_FRAMES, h=H, w=W, n_objects=6, fps=FPS, seed=1)
    return path


def port_run(log: str, per_stage: bool, depth: int, clip: str):
    pipe = Pipeline(load_config(overrides=overrides(log, per_stage, depth)))
    frames = record(pipe.tracker)
    pipe.run(clip)
    return frames, pipe.events.zone_counts()


def port_resumed(tmp_path, per_stage: bool, depth: int, clip: str):
    """Half the clip with snapshots every 4 frames, then a fresh pipeline
    that restores the last and runs the rest: (log, tracks of the second
    half, zone_counts)."""
    log, snap = str(tmp_path / "resumed.jsonl"), str(tmp_path / "state.npz")
    first = Pipeline(load_config(overrides=overrides(log, per_stage, depth)))
    first.run(clip, max_frames=HALF, state_path=snap, state_interval=4)
    pipe = Pipeline(load_config(overrides=overrides(log, per_stage, depth)))
    skip = pipe.load_runtime_state(snap)
    assert skip == HALF
    restored_next_id = int(pipe.tracker.state.next_id)
    assert restored_next_id > 1
    frames = record(pipe.tracker)
    pipe.run(clip, state_path=snap, state_interval=4, skip_frames=skip)
    assert pipe.profiler.frame_count == N_FRAMES - HALF
    with np.load(snap) as z:
        assert json.loads(str(z["meta"]))["frames_done"] == N_FRAMES
    return log, frames, pipe.events.zone_counts()


@pytest.fixture(scope="module")
def jax_per_stage(clip, tmp_path_factory):
    log = str(tmp_path_factory.mktemp("ev") / "jax.jsonl")
    pipe = JaxPipeline(jax_load_config(overrides=overrides(log, per_stage=True)))
    frames = record(pipe.tracker)
    pipe.run(clip)
    return log, frames, pipe.events.zone_counts()


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
    cfg = jax_load_config(overrides=overrides(log, per_stage=False))
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
    return log, frames, engine.zone_counts()


def test_per_stage_resume_equals_the_uninterrupted_runs(clip, jax_per_stage, tmp_path):
    log, frames, counts = port_resumed(tmp_path, True, 0, clip)
    assert_same(log, jax_per_stage[0], frames, jax_per_stage[1][HALF:])
    assert counts == jax_per_stage[2]
    own_log = str(tmp_path / "own.jsonl")
    own_frames, own_counts = port_run(own_log, True, 0, clip)
    assert_same(log, own_log, frames, own_frames[HALF:])
    assert counts == own_counts


def test_packed_per_frame_resume_equals_the_uninterrupted_runs(clip, jax_planar, tmp_path):
    depth = 2
    log, frames, counts = port_resumed(tmp_path, False, depth, clip)
    assert_same(log, jax_planar[0], frames, jax_planar[1][HALF:])
    assert counts == jax_planar[2]
    own_log = str(tmp_path / "own.jsonl")
    own_frames, own_counts = port_run(own_log, False, depth, clip)
    assert_same(log, own_log, frames, own_frames[HALF:])
    assert counts == own_counts


def test_warmup_keeps_a_restored_state(clip, tmp_path):
    """``warmup`` runs the tracker on dummy frames and then puts back the
    state it found: on a fresh pipeline no track, on a restored one the
    restored slots, ids and GMC carry."""
    cfg = load_config(overrides={**overrides(str(tmp_path / "w.jsonl"), True),
                                 "tracking": {"gmc": {"method": "phase"}}})
    pipe = Pipeline(cfg)
    pipe.run(clip, max_frames=6, state_path=str(tmp_path / "w.npz"))
    fresh = Pipeline(cfg)
    fresh.warmup((H, W))
    assert not bool(fresh.tracker.state.active.any()) and int(fresh.tracker.state.next_id) == 1
    fresh.load_runtime_state(str(tmp_path / "w.npz"))
    before = [t.clone() for t in fresh.tracker.state]
    carry = tuple(t.clone() for t in fresh._gmc_carry)
    assert float(carry[1]) == 1.0                      # the carry came from the snapshot
    fresh.warmup((H, W))
    for a, b in zip(fresh.tracker.state, before):
        assert bool((a == b).all())
    assert all(bool((a == b).all()) for a, b in zip(fresh._gmc_carry, carry))
