"""Kill-and-resume of the multi-camera loop (``MultiStreamPipeline.run`` with
``state_path``) and the live-source rule of both loops.

Two 25-fps clips (16 frames of 512x288 each) run at S = 2, T = 4 with
yolov8n at 128 px (seeded weights, conf 0.01: every run here is the port's
own, compared with itself), zone events on:

  * uninterrupted against a run cut twice (two restarts):
    each stream's event log identical less the wall-clock ``timestamp_utc``,
    the same ``zone_counts``, and ``per_stream_frames`` counted across
    restarts;
  * the same for OC-SORT + GMC (per-stream states and GMC carries);
  * a stream that ended before the snapshot stays dead after the restart,
    its blank frames stamped on its own clock, as in the uninterrupted run;
  * a live source is not fast-forwarded, neither by ``MultiStreamPipeline``
    nor by ``Pipeline.run_chunked``: it resumes at its current frame.
"""

from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

import rtmodt_tpu_torch.parallel.multistream as multistream
import rtmodt_tpu_torch.runtime.pipeline as pipeline
from rtmodt_tpu_torch.config import load_config
from rtmodt_tpu_torch.ingestion.rtsp_reader import RTSPReader
from rtmodt_tpu_torch.parallel.multistream import MultiStreamPipeline
from rtmodt_tpu_torch.runtime.pipeline import Pipeline
from rtmodt_tpu_torch.utils.synthetic import write_synthetic_video

H, W, SIZE, T, N = 288, 512, 128, 4, 16


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads while this module runs: the suite runs several
    workers on one host, and small models gain little from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def cfg(log: str, **tracking):
    return load_config(overrides={
        "system": {"device": "cpu"},
        "ingestion": {"max_reconnects": 0},
        "detection": {"model": "yolov8n", "input_size": SIZE, "conf_threshold": 0.01,
                      "classes": None, "nms_candidates": 64, "max_detections": 20,
                      "half": False},
        "tracking": tracking,
        "events": {"zones": [
            {"name": "left_half", "polygon": [[0, 0], [256, 0], [256, 288], [0, 288]],
             "trigger": "intrusion", "dwell_time_sec": 0.12, "cooldown_sec": 0.2},
            {"name": "gate", "polygon": [[120, 0], [512, 0], [512, 288], [120, 288]],
             "trigger": "crossing", "cooldown_sec": 1.0}],
            "alert": {"backend": "json_file", "log_path": log}},
        "parallel": {"chunk_size": T, "pipeline_depth": 1},
        "visualization": {"enabled": False},
    })


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    d = tmp_path_factory.mktemp("clips")
    out = []
    for i, n in enumerate((N, N, N // 2)):
        path = str(d / f"cam{i}.mp4")
        write_synthetic_video(path, frames=n, h=H, w=W, n_objects=6, fps=25.0, seed=1 + i)
        out.append(path)
    return out


def events(path: str) -> list[tuple]:
    """(stream, event, zone, track, frame, dwell) of each logged event."""
    if not os.path.exists(path):
        return []
    rows = [json.loads(line) for line in open(path)]
    return [(r["metadata"]["stream"], r["event_type"], r["zone_name"], r["track_id"],
             r["frame_id"], round(r["dwell_time_sec"], 6)) for r in rows]


def run(log: str, sources: list, **kw) -> dict:
    tracking = kw.pop("tracking", {})
    return MultiStreamPipeline(cfg(log, **tracking), num_streams=len(sources),
                               device="cpu").run(sources, chunk_size=T, **kw)


@pytest.mark.parametrize("tracking", [
    {}, {"algorithm": "ocsort", "gmc": {"method": "phase"},
         "ocsort": {"det_thresh": 0.3, "min_hits": 1}}], ids=["bytetrack", "ocsort_gmc"])
def test_resume_equals_the_uninterrupted_run(clips, tmp_path, tracking):
    sources = clips[:2]
    want_log = str(tmp_path / "whole.jsonl")
    want = run(want_log, sources, tracking=tracking)
    assert want["per_stream_frames"] == [N, N] and events(want_log)
    log, snap = str(tmp_path / "cut.jsonl"), str(tmp_path / "s.npz")
    # runs to frames 4 and 12 of each stream, then to the end
    done = 0
    for stop in (4, 12, None):
        got = run(log, sources, tracking=tracking, state_path=snap, state_interval=8,
                  max_frames=None if stop is None else stop - done)
        done = N if stop is None else stop
        with np.load(snap) as z:
            meta = json.loads(str(z["meta"]))
        assert meta["per_stream_frames"] == got["per_stream_frames"] == [done] * 2
    assert got["per_stream_frames"] == [N, N]
    assert events(log) == events(want_log)
    assert got["zone_counts"] == want["zone_counts"]
    assert got["dead_streams"] == want["dead_streams"]


def test_a_dead_stream_stays_dead_after_the_restart(clips, tmp_path):
    sources = [clips[0], clips[2]]              # the second ends after N / 2 frames
    want_log = str(tmp_path / "whole.jsonl")
    want = run(want_log, sources)
    # both files end; the short one first
    assert want["dead_streams"] == [0, 1] and want["per_stream_frames"] == [N, N // 2]
    log, snap = str(tmp_path / "cut.jsonl"), str(tmp_path / "s.npz")
    first = run(log, sources, max_frames=12, state_path=snap)
    assert first["dead_streams"] == [1]
    got = run(log, sources, state_path=snap)
    assert got["dead_streams"] == [0, 1] and got["per_stream_frames"] == [N, N // 2]
    assert events(log) == events(want_log)
    assert got["zone_counts"] == want["zone_counts"]


class LiveReader(RTSPReader):
    """A file read as a camera: the resumed loops may not drop its frames."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._is_file = False


def test_live_sources_are_not_fast_forwarded(clips, tmp_path, monkeypatch):
    monkeypatch.setattr(multistream, "RTSPReader", LiveReader)
    monkeypatch.setattr(pipeline, "RTSPReader", LiveReader)
    snap = str(tmp_path / "ms.npz")
    first = run(str(tmp_path / "a.jsonl"), clips[:2], max_frames=8, state_path=snap)
    assert first["per_stream_frames"] == [8, 8]
    again = run(str(tmp_path / "a.jsonl"), clips[:2], state_path=snap)
    assert again["frames"] == 2 * N                       # every frame read again
    assert again["per_stream_frames"] == [8 + N, 8 + N]

    one = str(tmp_path / "one.npz")
    p1 = Pipeline(cfg(str(tmp_path / "b.jsonl")))
    p1.run_chunked(clips[0], max_frames=8, state_path=one)
    p2 = Pipeline(cfg(str(tmp_path / "b.jsonl")))
    skip = p2.load_runtime_state(one)
    assert skip == 8
    assert p2.run_chunked(clips[0], state_path=one, skip_frames=skip)["frames"] == N
    with np.load(one) as z:
        assert json.loads(str(z["meta"]))["frames_done"] == N
