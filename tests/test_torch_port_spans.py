"""The program's span recorder (``profiling/spans.py``) and its four spans.

* The recorder: off, ``span()`` is the shared no-op and nothing is
  recorded; on, it records names, parents and threads, at times between
  ``perf_counter()`` readings taken around each span; ``drain`` clears.
* ``MultiStreamPipeline.submit_chunk_packed`` (rich640d at 256 px, float32,
  S = 2 streams, T = 4, on the CPU): one ``detect`` and one ``track`` span a
  chunk, every ``sync`` span a child of ``track``, one ``sync`` span per
  read of ``greedy_assign``'s loop condition; tracks and detections bit for
  bit the same with the recorder on and off.
* ``ZoneEventEngine.process_chunk``: one ``emit`` span per event returned.
* A ``profiling.trace_dir`` capture writes the spans of its window into its
  trace as a host lane, on the trace's clock: each convolution the CPU lane
  shows lies inside a ``detect`` span.
"""

from __future__ import annotations

import glob
import gzip
import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from rtmodt_tpu_torch.config import load_config
from rtmodt_tpu_torch.config.loader import AlertConfig
from rtmodt_tpu_torch.events.zone_engine import ZoneEventEngine
from rtmodt_tpu_torch.ops.yuv import pack_chunk
from rtmodt_tpu_torch.parallel.multistream import MultiStreamPipeline
from rtmodt_tpu_torch.profiling import spans
from rtmodt_tpu_torch.runtime.pipeline import Pipeline
from rtmodt_tpu_torch.tracking import bytetrack
from rtmodt_tpu_torch.utils.synthetic import moving_boxes_frame
from tests.test_torch_port_threads import torch_threads  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHTS = os.path.join(ROOT, "checkpoints", "rich640d", "ema_final.npz")
H, W, SIZE, S, T = 288, 512, 256, 2, 4


@pytest.fixture(autouse=True)
def recorder_off():
    """Every test starts and ends with the recorder off and empty."""
    spans.disable()
    spans.drain()
    yield
    spans.disable()
    spans.drain()


def test_off_records_nothing_and_returns_the_shared_no_op():
    assert not spans.enabled()
    a, b = spans.span("detect"), spans.span("track")
    assert a is b is spans.NO_SPAN
    with spans.span("detect"):
        with spans.span("sync"):
            pass
    assert spans.drain() == []


def test_on_records_parents_nesting_threads_and_times():
    spans.enable()
    before = time.perf_counter()
    with spans.span("track"):
        inside = time.perf_counter()
        with spans.span("sync"):
            pass
        with spans.span("sync"):
            pass
    after = time.perf_counter()

    def other():
        with spans.span("emit"):
            pass

    th = threading.Thread(target=other)
    with spans.span("detect"):       # open while the other thread records
        th.start()
        th.join()
    got = spans.drain()
    assert spans.drain() == []
    assert [(s.name, s.parent) for s in got] == [("sync", "track"), ("sync", "track"),
                                                 ("track", None), ("emit", None),
                                                 ("detect", None)]
    track = got[2]
    assert before <= track.t0 <= inside <= track.t1 <= after
    for s in got[:2]:
        assert track.t0 <= s.t0 <= s.t1 <= track.t1
    assert got[0].t1 <= got[1].t0
    me = threading.get_native_id()
    assert {s.thread for s in got if s.name != "emit"} == {me}
    assert got[3].thread != me
    spans.disable()
    with spans.span("detect"):
        pass
    assert spans.drain() == []


def _frames(c: int) -> np.ndarray:
    """(T, S, H, W, 3) BGR frames of chunk c: stream s is scene seed s + 1."""
    return np.stack([np.stack([moving_boxes_frame(c * T + t + 5 * s, H, W, 6, seed=s + 1)[0]
                               for s in range(S)]) for t in range(T)])


@pytest.fixture(scope="module")
def msp():
    return MultiStreamPipeline(load_config(overrides={
        "system": {"device": "cpu"},
        "detection": {"model": "yolov8s", "input_size": SIZE, "num_classes": 8,
                      "weights": WEIGHTS, "half": False},
        "events": {"enabled": False}, "visualization": {"enabled": False},
        "profiling": {"per_stage": False, "log_interval": 0},
        "parallel": {"chunk_size": T}}), num_streams=S)


@pytest.fixture(scope="module")
def planes():
    out = []
    for c in range(2):
        y, u, v = pack_chunk(_frames(c).reshape(T * S, H, W, 3), SIZE)[0]
        out.append(tuple(torch.from_numpy(p.reshape(T, S, *p.shape[1:])) for p in (y, u, v)))
    return out


def _run(msp, planes, reads: list) -> list:
    """Two chunks from a fresh state; ``reads`` gets a list a chunk."""
    msp.reset()
    out = []
    for p in planes:
        reads.append([])
        out.append(msp.submit_chunk_packed(p, H, W))
    return out


def test_chunk_program_spans_and_sync_reads(msp, planes, monkeypatch):
    reads: list = []
    inner = bytetrack.greedy_assign

    def counted(sim, thr, row_valid=None, col_valid=None):
        res = inner(sim, thr, row_valid=row_valid, col_valid=col_valid)
        r, c = sim.shape[-2:]
        reads[-1].append(0 if not (r and c) else
                         res.rounds + (res.rounds < min(r, c)))
        return res

    monkeypatch.setattr(bytetrack, "greedy_assign", counted)
    want = _run(msp, planes, reads)              # recorder off
    reads.clear()
    spans.enable()
    got = _run(msp, planes, reads)
    spans.disable()
    rec = spans.drain()

    # outputs unchanged by the recorder, bit for bit
    for g_chunk, w_chunk in zip(got, want):
        for g, w_ in zip(g_chunk, w_chunk):            # TrackOutputs, NMSResult
            for name, a, b in zip(g._fields, g, w_):
                assert torch.equal(a, b), name
    assert int(got[-1][0].visible[-1].sum()) >= 2 * S   # the model tracks the boxes

    detect = [s for s in rec if s.name == "detect"]
    track = [s for s in rec if s.name == "track"]
    sync = [s for s in rec if s.name == "sync"]
    assert len(detect) == len(track) == len(planes)
    assert {s.name for s in rec} == {"detect", "track", "sync"}
    assert all(s.parent is None for s in detect + track)
    assert all(s.parent == "track" for s in sync)
    for c, (d, t) in enumerate(zip(detect, track)):
        assert d.t1 <= t.t0
        inside = [s for s in sync if t.t0 <= s.t0 and s.t1 <= t.t1]
        # two associations a tracker step, each reading its condition
        assert len(reads[c]) == 2 * T
        assert len(inside) == sum(reads[c]) >= 2 * T
    assert len(sync) == sum(map(sum, reads))
    assert sum(map(sum, reads)) > 4 * T            # greedy rounds ran, not only the first read


def test_zone_engine_emits_one_span_per_event(tmp_path):
    engine = ZoneEventEngine(
        [{"name": "z", "polygon": [[0, 0], [200, 0], [200, 200], [0, 200]],
          "dwell_time_sec": 0.0, "cooldown_sec": 0.2}],
        alert=AlertConfig(backend="json_file", log_path=str(tmp_path / "ev.jsonl")),
        clock="stream")
    k, s = 12, 2
    xs = np.arange(k, dtype=np.float32)[:, None] * 40 + np.array([0, 20], np.float32)
    boxes = np.stack([xs, xs, xs + 30, xs + 30], axis=-1)            # (K, S, 4)
    args = (np.tile([3, 4], (k, 1)), np.zeros((k, s), np.int32), boxes, np.ones((k, s), bool),
            list(range(1, k + 1)), np.arange(k) / 10.0)
    spans.enable()
    evts = engine.process_chunk(*args)
    rec = spans.drain()
    assert len(evts) >= 2
    assert [x.name for x in rec] == ["emit"] * len(evts)
    assert len((tmp_path / "ev.jsonl").read_text().splitlines()) == len(evts)


def test_trace_dir_capture_writes_the_spans_on_the_trace_clock(tmp_path):
    tdir = tmp_path / "traces"
    pipe = Pipeline(load_config(overrides={
        "system": {"device": "cpu"},
        "detection": {"model": "yolov8n", "input_size": 128, "half": False},
        "profiling": {"trace_dir": str(tdir), "trace_frames": 2, "warmup_frames": 0,
                      "log_interval": 0, "per_stage": False},
        "parallel": {"chunk_size": 4},
        "visualization": {"enabled": False}, "events": {"enabled": False}}), device="cpu")
    frames = [moving_boxes_frame(t, 96, 160, 4)[0] for t in range(12)]
    pipe.run_chunked(frames)
    assert not spans.enabled() and spans.drain() == []      # the capture's own, and closed
    path, = glob.glob(os.path.join(str(tdir), "**", "*.pt.trace.json.gz"), recursive=True)
    with gzip.open(path, "rt") as f:
        events = json.load(f)["traceEvents"]
    lane = [e for e in events if e.get("cat") == "program_span"]
    names = [e["name"] for e in lane]
    assert names.count("detect") == names.count("track") >= 2
    assert {e["pid"] for e in lane} == {"program spans"}
    assert any(e.get("ph") == "M" and e["pid"] == "program spans" for e in events)
    detect = [(e["ts"], e["ts"] + e["dur"]) for e in lane if e["name"] == "detect"]
    convs = [(e["ts"], e["ts"] + e["dur"]) for e in events
             if e.get("cat") == "cpu_op" and e["name"] == "aten::conv2d"]
    assert convs
    # every convolution of the window ran inside one of its detect spans (1 us of the
    # two clocks' mapping to spare)
    for a, b in convs:
        assert any(d0 - 1.0 <= a and b <= d1 + 1.0 for d0, d1 in detect), (a, b)
    # the reader still reads only device events (a CPU capture holds none)
    from rtmodt_tpu_torch.profiling import trace_summary

    assert trace_summary.device_op_times(events) == ({}, {})
