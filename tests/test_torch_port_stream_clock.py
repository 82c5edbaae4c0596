"""Stream clock and frame limit of the port's ``run_chunked`` (ROADMAP §3,
faults F1 and F2).

F1: a video path goes through the port's ``RTSPReader``, so the
``(frame_id, timestamp)`` that ``run_chunked`` hands the zone engine for each
frame of a 25-fps file equals what the reference's ``RTSPReader`` yields for
it (exact), and its event JSONL equals that of the JAX composition over
``planar_letterbox`` (as in tests/test_torch_port_pipeline.py) fed those
timestamps: identical less the wall-clock ``timestamp_utc``, ``bbox_xyxy``
within 1e-4 px.  The JAX ``Pipeline.run_chunked`` is not the arbiter: its
chunk program runs the space-to-depth front, which differs from
``planar_letterbox`` on a border ring.

F2: ``max_frames=0`` means no limit, in both packages.
"""

from __future__ import annotations

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rtmodt_tpu.config.loader import ByteTrackConfig as JaxByteTrackConfig
from rtmodt_tpu.config.loader import EventsConfig as JaxEventsConfig
from rtmodt_tpu.config.loader import _build as jax_build_cfg
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
from rtmodt_tpu.tracking.bytetrack import bytetrack_update as jax_update
from rtmodt_tpu.tracking.bytetrack import init_track_state as jax_init
from rtmodt_tpu.utils.synthetic import write_synthetic_video
from rtmodt_tpu_torch.config import load_config
from rtmodt_tpu_torch.runtime.pipeline import Pipeline

H, W, SIZE, K, N_FRAMES, FPS = 288, 512, 256, 4, 14, 25.0
CONF = 0.35
CLASSES = [0, 1, 2, 3, 5, 7]
WEIGHTS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "checkpoints", "rich640d", "ema_final.npz")


def _events_cfg(log_path: str) -> dict:
    # dwell and cooldown a few frame periods long: stamped at 30 fps instead
    # of the file's 25, events fire on other frames
    return {
        "zones": [
            {"name": "left_half", "polygon": [[0, 0], [256, 0], [256, 288], [0, 288]],
             "trigger": "intrusion", "dwell_time_sec": 0.14, "cooldown_sec": 0.18},
            {"name": "gate", "polygon": [[120, 0], [512, 0], [512, 288], [120, 288]],
             "trigger": "crossing", "cooldown_sec": 0.3},
        ],
        "alert": {"backend": "json_file", "log_path": log_path},
    }


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("clip") / "clip25.mp4")
    write_synthetic_video(path, frames=N_FRAMES, h=H, w=W, n_objects=6, fps=FPS, seed=1)
    return path


@pytest.fixture(scope="module")
def reference_stream(clip):
    """(frame, frame_id, timestamp) of every frame, as the reference's
    reader yields them."""
    out = []
    with JaxReader(clip) as reader:
        last = 0
        while True:
            frame, fid, ts = reader.read_new(last, timeout=5.0)
            if frame is None:
                assert reader.is_eof
                break
            last = fid
            out.append((frame, fid, ts))
    assert len(out) == N_FRAMES
    return out


@pytest.fixture(scope="module")
def jax_events(reference_stream, tmp_path_factory):
    """Event log of the JAX planar chunk composition fed the reader's
    frames, ids and timestamps."""
    model = jax_build("yolov8s", num_classes=8, dtype=jnp.float32, fused=True)
    params = jax_fuse_bn(jax.device_get(jax_load_npz(WEIGHTS)))
    mask = jnp.asarray(np.isin(np.arange(8), CLASSES))
    bt = JaxByteTrackConfig()
    geom = jax_packed_meta(H, W, SIZE)

    @jax.jit
    def detect(y, u, v):
        img = jax.vmap(lambda a, b, c: jax_planar_letterbox(
            a, b, c, SIZE, geom.pad_left, geom.pad_top, dtype=jnp.float32))(y, u, v)
        box_dist, cls = model.apply(params, img, train=False)
        res = jax.vmap(lambda bd, cl: jax_nms(bd, cl, SIZE, CONF, 0.45, 100, 300, mask))(
            box_dist, cls)
        return res._replace(boxes=jax_unletterbox(res.boxes, geom))

    log = str(tmp_path_factory.mktemp("ev") / "jax.jsonl")
    engine = JaxZoneEventEngine.from_config(
        jax_build_cfg(JaxEventsConfig, _events_cfg(log), "events"))
    step = jax.jit(functools.partial(jax_update, cfg=bt))
    state = jax_init(bt.max_tracks)
    names = ["person", "bicycle", "car", "motorcycle", "airplane", "bus", "train", "truck"]
    for c0 in range(0, N_FRAMES, K):
        part = reference_stream[c0:c0 + K]
        frames = [f for f, _, _ in part]
        (y, u, v), _ = jax_pack_chunk(np.stack(frames + [frames[-1]] * (K - len(frames))),
                                      SIZE)
        res = detect(jnp.asarray(y), jnp.asarray(u), jnp.asarray(v))
        outs = []
        for i in range(len(part)):
            state, o = step(state, res.boxes[i], res.scores[i], res.classes[i], res.valid[i])
            outs.append(jax.device_get(o))
        stack = lambda f: np.stack([getattr(o, f) for o in outs])  # noqa: E731
        engine.process_chunk(stack("track_id"), stack("class_id"), stack("boxes"),
                             stack("visible"), [fid for _, fid, _ in part],
                             np.asarray([ts for _, _, ts in part], np.float64),
                             class_names=names)
    return log


def _events(path: str) -> list[dict]:
    with open(path) as f:
        out = [json.loads(line) for line in f]
    for e in out:
        e.pop("timestamp_utc")
    return out


def _port(log_path: str, **detection) -> Pipeline:
    cfg = load_config(overrides={
        "detection": {"model": "yolov8s", "input_size": SIZE, "num_classes": 8,
                      "weights": WEIGHTS, "conf_threshold": CONF, "half": False,
                      "classes": CLASSES, **detection},
        "events": _events_cfg(log_path),
        "parallel": {"chunk_size": K, "pipeline_depth": 1},
    })
    return Pipeline(cfg, device="cpu")


def test_run_chunked_stamps_a_file_with_its_stream_clock(clip, reference_stream, jax_events,
                                                         tmp_path):
    log = str(tmp_path / "port.jsonl")
    pipe = _port(log)
    seen = []
    inner = pipe.events.process_chunk

    def process_chunk(track_ids, class_ids, boxes, visible, frame_ids, timestamps=None, **kw):
        seen.extend(zip(frame_ids, timestamps))
        return inner(track_ids, class_ids, boxes, visible, frame_ids, timestamps, **kw)

    pipe.events.process_chunk = process_chunk
    summary = pipe.run_chunked(clip)
    assert summary["frames"] == N_FRAMES
    assert [(int(f), float(t)) for f, t in seen] == [(fid, ts) for _, fid, ts in
                                                    reference_stream]
    got, want = _events(log), _events(jax_events)
    assert len(want) > 0 and len(got) == len(want)
    got_boxes = np.array([e.pop("bbox_xyxy") for e in got])
    want_boxes = np.array([e.pop("bbox_xyxy") for e in want])
    assert got == want
    np.testing.assert_allclose(got_boxes, want_boxes, rtol=0, atol=1e-4)


@pytest.mark.parametrize("source", ["frames", "path"])
def test_max_frames_zero_means_no_limit_in_the_port(clip, reference_stream, tmp_path, source):
    pipe = _port(str(tmp_path / "ev.jsonl"), model="yolov8n", weights=None, input_size=128)
    src = [f for f, _, _ in reference_stream] if source == "frames" else clip
    assert pipe.run_chunked(src, max_frames=0)["frames"] == N_FRAMES
    assert pipe.run_chunked(src, max_frames=None)["frames"] == N_FRAMES
    assert pipe.run_chunked(src, max_frames=5)["frames"] == 5


def test_max_frames_zero_means_no_limit_in_the_reference(clip, tmp_path):
    cfg = jax_load_config(overrides={
        "system": {"device": "cpu"},
        "detection": {"model": "yolov8n", "input_size": 128, "weights": None, "classes": None},
        "events": {"enabled": False},
        "visualization": {"enabled": False},
        "profiling": {"per_stage": False, "warmup_frames": 0, "log_interval": 0},
        "parallel": {"chunk_size": K},
    })
    pipe = JaxPipeline(cfg)
    pipe.run_chunked(clip, max_frames=0)
    assert pipe.profiler._frame_count == N_FRAMES
