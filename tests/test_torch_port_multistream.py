"""The port's ``MultiStreamPipeline`` on the CPU, with the trained rich640d
weights at a 256 px input in float32 and S = 2 streams of 512x288 frames.

* ``step`` / ``step_chunk`` (BGR frames, T = 2) against the JAX
  ``MultiStreamPipeline.step`` / ``step_chunk``: identical visibility and
  track ids, boxes within 1e-4 px (the DFL softmax's ulp-level difference
  between the frameworks, tests/test_torch_port_nms.py).
* ``submit_chunk_packed`` per stream against the port's single-stream
  ``Pipeline.submit_packed_yuv`` on that stream's frames (itself held to the
  JAX composition in tests/test_torch_port_pipeline.py); streams do not leak
  into each other; DeepSORT + GMC per stream against the single stream.
* ``run`` on two files: each stream's zone events equal the single-stream
  ``run_chunked``'s on its file (less ``timestamp_utc``, plus the
  ``stream`` field; ``bbox_xyxy`` within 1e-4 px).  The files' lengths are
  multiples of T: the reference's multi-stream loop feeds a short final
  chunk with blank frames where ``run_chunked`` repeats the last frame.
* A degraded run (one file half as long), the refusals, the mosaic, and
  the CLI with two ``-s``.
"""

from __future__ import annotations

import copy
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from rtmodt_tpu.config.loader import load_config as jax_load_config
from rtmodt_tpu.parallel.multistream import MosaicAnnotator as JaxMosaic
from rtmodt_tpu.parallel.multistream import MultiStreamPipeline as JaxMultiStream
from rtmodt_tpu_torch.config import load_config
from rtmodt_tpu_torch.ops.yuv import pack_chunk
from rtmodt_tpu_torch.parallel.multistream import MosaicAnnotator, MultiStreamPipeline
from rtmodt_tpu_torch.runtime.pipeline import Pipeline
from rtmodt_tpu_torch.tracking.bytetrack import TrackOutputs
from rtmodt_tpu_torch.utils.synthetic import moving_boxes_frame, write_synthetic_video

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHTS = os.path.join(ROOT, "checkpoints", "rich640d", "ema_final.npz")
H, W, SIZE, S, FPS = 288, 512, 256, 2, 25.0
CLASSES = [0, 1, 2, 3, 5, 7]
BOX_ATOL = 1e-4
ZONES = [
    {"name": "left_half", "polygon": [[0, 0], [256, 0], [256, 288], [0, 288]],
     "trigger": "intrusion", "dwell_time_sec": 0.12, "cooldown_sec": 0.2},
    {"name": "gate", "polygon": [[120, 0], [512, 0], [512, 288], [120, 288]],
     "trigger": "crossing", "cooldown_sec": 1.0},
]


def overrides(log_path: str | None = None, **extra) -> dict:
    """Config shared by both packages' loaders."""
    over = {
        "system": {"device": "cpu"},
        "detection": {"model": "yolov8s", "input_size": SIZE, "num_classes": 8,
                      "weights": WEIGHTS, "half": False, "classes": CLASSES},
        "events": ({"zones": ZONES, "alert": {"backend": "json_file", "log_path": log_path}}
                   if log_path else {"enabled": False}),
        "profiling": {"per_stage": False, "log_interval": 0},
        "visualization": {"enabled": False},
        "parallel": {"chunk_size": 4, "pipeline_depth": 1},
    }
    for k, v in extra.items():
        over[k] = {**over.get(k, {}), **v}
    return over


def stream_frames(n: int, pan: int = 0) -> np.ndarray:
    """(n, S, H, W, 3): stream s is scene seed s + 1 shifted 5 s frames;
    ``pan`` scrolls every frame sideways by ``pan`` px a frame."""
    out = np.stack([np.stack([moving_boxes_frame(t + 5 * s, H, W, 6, seed=s + 1)[0]
                              for s in range(S)]) for t in range(n)])
    if pan:
        for t in range(n):
            out[t] = np.roll(out[t], pan * t, axis=2)
    return out


def assert_same_outputs(got, want) -> None:
    """TrackOutputs-like (..., N): identical visibility and ids on visible
    slots, boxes within BOX_ATOL."""
    gv, wv = np.asarray(got.visible), np.asarray(want.visible)
    np.testing.assert_array_equal(gv, wv)
    np.testing.assert_array_equal(np.asarray(got.track_id)[gv], np.asarray(want.track_id)[wv])
    np.testing.assert_allclose(np.asarray(got.boxes)[gv], np.asarray(want.boxes)[wv],
                               rtol=0, atol=BOX_ATOL)


def assert_same_detections(got, want) -> None:
    gv, wv = np.asarray(got.valid), np.asarray(want.valid)
    np.testing.assert_array_equal(gv, wv)
    np.testing.assert_allclose(np.asarray(got.boxes)[gv], np.asarray(want.boxes)[wv],
                               rtol=0, atol=BOX_ATOL)


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("clips")
    paths = {}
    for name, n, seed in (("a", 8, 1), ("b", 8, 2), ("short", 4, 3)):
        paths[name] = str(tmp / f"{name}.mp4")
        write_synthetic_video(paths[name], frames=n, h=H, w=W, n_objects=6, fps=FPS, seed=seed)
    return paths


@pytest.fixture(scope="module")
def msp():
    return MultiStreamPipeline(load_config(overrides=overrides()), num_streams=S)


def test_step_and_step_chunk_match_jax(msp):
    frames = stream_frames(4)
    ref = JaxMultiStream(jax_load_config(overrides=overrides()), num_streams=S)
    msp.reset()
    n_visible = 0
    for call, batch in (("step", frames[0]), ("step_chunk", frames[1:3]), ("step", frames[3])):
        got_o, got_r = getattr(msp, call)(batch)
        want_o, want_r = getattr(ref, call)(batch)
        assert got_o.visible.shape == tuple(np.asarray(want_o.visible).shape)
        assert_same_outputs(got_o, want_o)
        assert_same_detections(got_r, want_r)
        n_visible += int(got_o.visible.sum())
    assert n_visible > 4 * S


def _single_stream_outputs(cfg, planes_ts, si: int, t: int):
    """The single-stream packed program over stream si's frames, in chunks
    of t: TrackOutputs with a leading frame axis."""
    pipe = Pipeline(cfg, device="cpu")
    outs = []
    y, u, v = planes_ts
    for c0 in range(0, y.shape[0], t):
        o, _ = pipe.submit_packed_yuv((y[c0:c0 + t, si], u[c0:c0 + t, si], v[c0:c0 + t, si]),
                                      H, W)
        outs.append(o)
    return TrackOutputs(*(torch.cat(f) for f in zip(*outs)))


def _packed(frames_ts: np.ndarray):
    n = frames_ts.shape[0]
    (y, u, v), _ = pack_chunk(frames_ts.reshape(n * S, H, W, 3), SIZE)
    return tuple(p.reshape(n, S, *p.shape[1:]) for p in (y, u, v))


def _multi_outputs(pipe, planes_ts, t: int):
    pipe.reset()
    y, u, v = planes_ts
    outs = [pipe.submit_chunk_packed((y[c0:c0 + t], u[c0:c0 + t], v[c0:c0 + t]), H, W)[0]
            for c0 in range(0, y.shape[0], t)]
    return TrackOutputs(*(torch.cat(f) for f in zip(*outs)))


def test_submit_chunk_packed_equals_single_stream(msp):
    planes = _packed(stream_frames(4))
    got = _multi_outputs(msp, planes, t=2)
    assert got.visible.shape[:2] == (4, S) and msp.chunks_submitted >= 2
    for si in range(S):
        want = _single_stream_outputs(msp.cfg, planes, si, t=2)
        assert_same_outputs(TrackOutputs(*(x[:, si] for x in got)), want)
        assert int(want.visible.sum()) > 4


def test_streams_are_independent(msp):
    frames = stream_frames(4)
    same = frames.copy()
    same[:, 1] = frames[:, 0]
    other = frames.copy()
    other[:, 1] = stream_frames(4)[::-1, 1]
    a = _multi_outputs(msp, _packed(frames), t=2)
    b = _multi_outputs(msp, _packed(other), t=2)
    c = _multi_outputs(msp, _packed(same), t=2)
    assert_same_outputs(TrackOutputs(*(x[:, 0] for x in a)), TrackOutputs(*(x[:, 0] for x in b)))
    assert_same_outputs(TrackOutputs(*(x[:, 1] for x in c)), TrackOutputs(*(x[:, 0] for x in c)))
    assert not torch.equal(a.visible[:, 1], c.visible[:, 1]) or \
        not torch.equal(a.boxes[:, 1], c.boxes[:, 1])


def test_deepsort_gmc_per_stream_equals_single_stream():
    cfg = load_config(overrides=overrides(tracking={"algorithm": "deepsort",
                                                    "gmc": {"method": "phase", "grid": 64}}))
    pipe = MultiStreamPipeline(cfg, num_streams=S)
    assert not pipe._batched and pipe._gmc_on
    planes = _packed(stream_frames(4, pan=6))
    got = _multi_outputs(pipe, planes, t=2)
    for si in range(S):
        want = _single_stream_outputs(cfg, planes, si, t=2)
        assert_same_outputs(TrackOutputs(*(x[:, si] for x in got)), want)
        assert int(want.visible.sum()) > 0


def _events(path: str) -> list[dict]:
    with open(path) as f:
        out = [json.loads(line) for line in f]
    for e in out:
        e.pop("timestamp_utc")
    return out


def _assert_same_events(got: list[dict], want: list[dict]) -> None:
    assert len(want) > 0 and len(got) == len(want)
    got_boxes = np.array([e.pop("bbox_xyxy") for e in got])
    want_boxes = np.array([e.pop("bbox_xyxy") for e in want])
    assert got == want
    np.testing.assert_allclose(got_boxes, want_boxes, rtol=0, atol=BOX_ATOL)


@pytest.fixture(scope="module")
def two_file_run(clips, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("run")
    log = str(tmp / "multi.jsonl")
    pipe = MultiStreamPipeline(load_config(overrides=overrides(log)), num_streams=S)
    summary = pipe.run([clips["a"], clips["b"]])
    return summary, _events(log), tmp


def test_run_events_equal_single_stream_run_chunked(clips, two_file_run):
    summary, events, tmp = two_file_run
    assert summary["frames"] == 16 and summary["streams"] == S
    assert summary["per_stream_frames"] == [8, 8]
    assert summary["dead_streams"] == [0, 1]   # both files ended
    assert set(summary) == {"frames", "streams", "fps_aggregate", "fps_per_stream",
                            "per_stream_frames", "dead_streams", "zone_counts"}
    for si, name in enumerate(("a", "b")):
        log = str(tmp / f"single_{name}.jsonl")
        single = Pipeline(load_config(overrides=overrides(log)), device="cpu")
        single.run_chunked(clips[name])
        got = [copy.deepcopy(e) for e in events if e["metadata"]["stream"] == si]
        for e in got:
            assert e["metadata"].pop("stream") == si
        _assert_same_events(got, _events(log))
        assert summary["zone_counts"][si] == single.events.zone_counts()


def test_degraded_run_names_the_dead_stream(clips, two_file_run, tmp_path):
    log = str(tmp_path / "degraded.jsonl")
    pipe = MultiStreamPipeline(load_config(overrides=overrides(log)), num_streams=S)
    summary = pipe.run([clips["a"], clips["short"]], max_frames=8)
    assert summary["per_stream_frames"] == [8, 4] and summary["frames"] == 12
    assert summary["dead_streams"] == [1]
    # stream 0 is unaffected by its neighbour going blank
    got = [e for e in _events(log) if e["metadata"]["stream"] == 0]
    want = [copy.deepcopy(e) for e in two_file_run[1] if e["metadata"]["stream"] == 0]
    _assert_same_events(got, want)


def test_refusals(msp, clips, tmp_path):
    from rtmodt_tpu_torch.runtime.state_store import save_snapshot

    with pytest.raises(ValueError, match="1 sources for 2 streams"):
        msp.run([clips["a"]])
    # a single-stream snapshot is not restored into S streams
    single = str(tmp_path / "single.npz")
    save_snapshot(single, msp.tracker)
    with pytest.raises(ValueError, match="single-stream"):
        msp.run([clips["a"], clips["b"]], state_path=single)
    # a pre-packed chunk must have the x6 or x24 layout
    with pytest.raises(ValueError, match="channels"):
        msp.submit_chunk_packed(np.zeros((2, S, 72, 128, 5), np.uint8), H, W)
    with pytest.raises(ValueError, match="3 streams"):
        msp.step(np.zeros((3, H, W, 3), np.uint8))
    with pytest.raises(ValueError, match="lapjv"):
        load_config(overrides={"parallel": {"num_streams": 2},
                               "tracking": {"bytetrack": {"assignment": "lapjv"}}})
    with pytest.raises(ValueError, match="lapjv"):
        MultiStreamPipeline(load_config(overrides=overrides(
            tracking={"bytetrack": {"assignment": "lapjv"}})), num_streams=S)
    with pytest.raises(ValueError, match="num_streams"):
        load_config(overrides={"parallel": {"num_streams": 0}})
    assert load_config(overrides={"parallel": {"num_streams": 4}}).parallel.num_streams == 4


def test_mosaic_matches_reference_and_blanks_the_dead_tile():
    cfg = load_config(overrides={"visualization": {"enabled": True}})
    jcfg = jax_load_config(overrides={"visualization": {"enabled": True}})
    names = [f"c{i}" for i in range(8)]
    rng = np.random.default_rng(0)
    n = 4
    host = TrackOutputs(
        boxes=np.tile(np.array([40, 30, 120, 110], np.float32), (1, 3, n, 1)),
        track_id=np.arange(1, 3 * n + 1, dtype=np.int32).reshape(1, 3, n),
        class_id=np.full((1, 3, n), 2, np.int32),
        confidence=np.full((1, 3, n), 0.9, np.float32),
        age=np.ones((1, 3, n), np.int32), tsu=np.zeros((1, 3, n), np.int32),
        visible=np.array([[[True, False, True, False]] * 3]))
    frame = rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
    zones = [("z", np.array([[0, 0], [100, 0], [100, 100]], np.float32))]
    got = MosaicAnnotator(cfg.visualization, names, 3).mosaic(
        host, 0, [frame.copy(), None, frame.copy()], zones, fps=12.5)
    want = JaxMosaic(jcfg.visualization, names, 3).mosaic(
        host, 0, [frame.copy(), None, frame.copy()], zones, fps=12.5)
    assert got.shape == (2 * H, 2 * W, 3)
    np.testing.assert_array_equal(got, want)
    assert not got[H:, W:].any()                      # the padding tile
    dead = got[:H, W:]
    assert (dead == 0).mean() > 0.9 and dead.any()    # black, with its label
    assert not np.array_equal(got[:H, :W], frame)     # drawn on


def test_cli_runs_two_sources(clips, tmp_path):
    cfg = overrides(str(tmp_path / "cli.jsonl"), system={"log_dir": str(tmp_path / "logs")})
    path = tmp_path / "cli.yaml"
    path.write_text(json.dumps(cfg))                  # JSON is YAML
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tools", "run_pipeline_torch.py"), "-c", str(path),
         "-s", clips["a"], "-s", clips["b"], "--max-frames", "4"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "per_stream_frames: [4, 4]" in proc.stdout
    assert "streams: 2" in proc.stdout and "zone_counts" in proc.stdout
