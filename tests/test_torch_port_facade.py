"""The tracker facade and the per-frame zone engine against the JAX package's.

``MultiObjectTracker.update`` over a seeded scene (objects crossing, leaving
and returning, detection counts that change the power-of-two padding) must
give identical Track lists: ids, classes, names, ages, time since update and
trails exact, boxes and confidences within 1e-5 (float32).  The conversions
of given TrackOutputs (``tracks_from_outputs``, ``tracks_chunk_from_outputs``)
must be exact.  ``ZoneEventEngine.process`` fed identical Track lists must
write identical event JSONL (less the wall-clock ``timestamp_utc``) and
keep identical zone counts.
"""

from __future__ import annotations

import json

import numpy as np
import pytest

from rtmodt_tpu.config.loader import ByteTrackConfig as JaxByteTrackConfig
from rtmodt_tpu.detection.detector import Detections as JaxDetections
from rtmodt_tpu.events.zone_engine import ZoneEventEngine as JaxEngine
from rtmodt_tpu.tracking.bytetrack import TrackOutputs as JaxTrackOutputs
from rtmodt_tpu.tracking.tracker import MultiObjectTracker as JaxTracker
from rtmodt_tpu.tracking.tracker import Track as JaxTrack
from rtmodt_tpu_torch.config.loader import ByteTrackConfig
from rtmodt_tpu_torch.detection.detector import Detections
from rtmodt_tpu_torch.events.zone_engine import ZoneEventEngine
from rtmodt_tpu_torch.tracking.bytetrack import TrackOutputs
from rtmodt_tpu_torch.tracking.tracker import MultiObjectTracker, Track
from tests.test_torch_port_threads import torch_threads  # noqa: F401 (autouse)

NAMES = ["person", "bicycle", "car", "motorcycle"]
N_FRAMES, FPS = 40, 25.0


def scene(n_frames=N_FRAMES, n_obj=11, seed=3):
    """Per frame (boxes, conf, cls) of objects moving at constant speed with
    jitter; some leave for a few frames and come back."""
    rng = np.random.default_rng(seed)
    start = rng.uniform(0, 400, (n_obj, 2))
    vel = rng.uniform(-6, 12, (n_obj, 2))
    size = rng.uniform(30, 90, (n_obj, 2))
    cls = rng.integers(0, len(NAMES), n_obj)
    conf = rng.uniform(0.2, 0.95, n_obj)
    out = []
    for t in range(n_frames):
        keep = [i for i in range(n_obj) if not (i % 4 == 1 and 10 <= t < 13 + i % 3)]
        xy = start[keep] + vel[keep] * t + rng.normal(0, 1.0, (len(keep), 2))
        boxes = np.concatenate([xy, xy + size[keep]], 1).astype(np.float32)
        c = np.clip(conf[keep] + rng.normal(0, 0.05, len(keep)), 0.05, 1.0).astype(np.float32)
        out.append((boxes, c, cls[keep].astype(np.int32)))
    return out


def _same_tracks(got, want):
    assert [t.track_id for t in got] == [t.track_id for t in want]
    for g, w in zip(got, want):
        assert (g.class_id, g.class_name, g.age, g.time_since_update) == \
            (w.class_id, w.class_name, w.age, w.time_since_update)
        assert g.trail == w.trail
        np.testing.assert_allclose(g.xyxy, w.xyxy, rtol=1e-5, atol=1e-5)
        assert g.confidence == pytest.approx(w.confidence, rel=1e-5)
        assert g.xyxy.dtype == np.float32


@pytest.fixture(scope="module")
def tracked():
    """Track lists of both facades over the scene (ByteTrack, greedy)."""
    port = MultiObjectTracker("bytetrack", trail_length=6, device="cpu",
                              bytetrack=ByteTrackConfig(max_tracks=32))
    ref = JaxTracker("bytetrack", trail_length=6, bytetrack=JaxByteTrackConfig(max_tracks=32))
    got, want = [], []
    for boxes, conf, cls in scene():
        got.append(port.update(Detections(boxes, conf, cls, NAMES)))
        want.append(ref.update(JaxDetections(boxes, conf, cls, NAMES)))
    return got, want, port, ref


def test_update_gives_identical_track_lists(tracked):
    got, want, _, _ = tracked
    assert sum(len(t) for t in got) > 100
    for g, w in zip(got, want):
        _same_tracks(g, w)
    assert any(len(t.trail) == 6 for frame in got for t in frame)   # trails capped


def test_empty_detections_and_reset(tracked):
    _, _, port, ref = tracked
    _same_tracks(port.update(Detections.empty(NAMES)), ref.update(JaxDetections.empty(NAMES)))
    port.reset()
    ref.reset()
    boxes, conf, cls = scene()[0]
    _same_tracks(port.update(Detections(boxes, conf, cls, NAMES)),
                 ref.update(JaxDetections(boxes, conf, cls, NAMES)))


def _outputs(rng, k=None, s=24):
    lead = () if k is None else (k,)
    xy = rng.uniform(0, 500, lead + (s, 2)).astype(np.float32)
    fields = dict(
        boxes=np.concatenate([xy, xy + 40.5], -1),
        track_id=rng.permutation(np.arange(1, s + 1)).astype(np.int32) if k is None
        else np.stack([rng.permutation(np.arange(1, s + 1)) for _ in range(k)]).astype(np.int32),
        class_id=rng.integers(-1, 5, lead + (s,)).astype(np.int32),
        confidence=rng.uniform(0, 1, lead + (s,)).astype(np.float32),
        age=rng.integers(0, 50, lead + (s,)).astype(np.int32),
        tsu=rng.integers(0, 3, lead + (s,)).astype(np.int32),
        visible=rng.uniform(size=lead + (s,)) < 0.6)
    return TrackOutputs(**fields), JaxTrackOutputs(**fields)


def test_tracks_from_outputs_are_identical():
    import torch

    rng = np.random.default_rng(11)
    port = MultiObjectTracker(device="cpu", trail_length=4)
    ref = JaxTracker(trail_length=4)
    for _ in range(6):
        po, jo = _outputs(rng)
        po = TrackOutputs(*(torch.from_numpy(a) for a in po))     # as the device gives them
        _same_tracks(port.tracks_from_outputs(po, NAMES), ref.tracks_from_outputs(jo, NAMES))
    po, jo = _outputs(rng, k=5)
    got, gi = port.tracks_chunk_from_outputs(po, NAMES, with_indices=True)
    want, wi = ref.tracks_chunk_from_outputs(jo, NAMES, with_indices=True)
    for g, w, a, b in zip(got, want, gi, wi):
        _same_tracks(g, w)
        np.testing.assert_array_equal(a, b)


ZONES = [
    {"name": "left", "polygon": [[0, 0], [260, 0], [260, 600], [0, 600]],
     "trigger": "intrusion", "dwell_time_sec": 0.2, "cooldown_sec": 0.4},
    {"name": "cars_only", "polygon": [[100, 0], [600, 0], [600, 600], [100, 600]],
     "trigger": "intrusion", "dwell_time_sec": 0.0, "cooldown_sec": 0.3, "classes": [2]},
    {"name": "gate_lr", "polygon": [[300, 0], [700, 0], [700, 600], [300, 600]],
     "trigger": "crossing", "direction": "left_to_right", "cooldown_sec": 1.0},
    {"name": "gate_any", "polygon": [[200, 100], [500, 100], [500, 500], [200, 500]],
     "trigger": "crossing", "cooldown_sec": 0.5},
]


def _jsonl(path):
    with open(path) as f:
        out = [json.loads(line) for line in f]
    for e in out:
        e.pop("timestamp_utc")
    return out


def test_process_writes_identical_events_for_identical_tracks(tracked, tmp_path):
    got_tracks, _, _, _ = tracked
    port = ZoneEventEngine(ZONES, log_path=str(tmp_path / "port.jsonl"), trail_length=6)
    ref = JaxEngine(ZONES, log_path=str(tmp_path / "ref.jsonl"), trail_length=6)
    n = 0
    for f, tracks in enumerate(got_tracks):
        twins = [JaxTrack(**{k: getattr(t, k) for k in Track.__dataclass_fields__})
                 for t in tracks]
        ge = port.process(tracks, f + 1, f / FPS)
        we = ref.process(twins, f + 1, f / FPS)
        assert [(e.zone_name, e.track_id, e.frame_id) for e in ge] == \
            [(e.zone_name, e.track_id, e.frame_id) for e in we]
        n += len(ge)
    got, want = _jsonl(tmp_path / "port.jsonl"), _jsonl(tmp_path / "ref.jsonl")
    assert got == want and len(got) == n
    assert {e["zone_name"] for e in got} >= {"left", "cars_only", "gate_lr"}
    assert port.zone_counts() == ref.zone_counts()
    for (gn, gp), (wn, wp) in zip(port.get_zone_polygons(), ref.get_zone_polygons()):
        assert gn == wn and gp.dtype == wp.dtype
        np.testing.assert_array_equal(gp, wp)
