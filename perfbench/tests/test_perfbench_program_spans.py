"""The program's spans read beside the harness's (``perfbench/program_spans.py``):
the chunk rule, the self time of ``track``, the first-``sync`` rule and the
profiled sub-window left out, on a hand-built ``RunRecord``, and the
readers' ``RunRecord.program_ms_per_frame``; the idle split by program span
(``devtrace.reduce``'s ``program_idle``) on ``fixtures/trace_small.json``;
one run of a CPU-sized cell through the tool."""

from __future__ import annotations

import os

import pytest
import torch

from perfbench import bench, devtrace, manifest, program_spans
from perfbench.tests.helpers import tiny_root
from rtmodt_tpu_torch.profiling import spans
from rtmodt_tpu_torch.profiling.spans import Span

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "trace_small.json")
FRAMES = 10
EXCLUDED = (59.0, 75.0)


def _harness() -> list:
    out = []
    for c, t in enumerate((0.0, 30.0, 60.0)):
        out += [("pack", c, t, t + 1), ("submit", c, t + 1, t + 11), ("copy", c, t + 11, t + 12),
                ("wait", c, t + 18, t + 20), ("events", c, t + 20, t + 24)]
    return out


def _program() -> list:
    def sp(name, parent, t0, t1, thread=1):
        return Span(name, parent, t0, t1, thread)

    return [
        sp("detect", None, -5.0, -4.0),                       # warm-up: in no harness span
        # chunk 0: forward wait 2, rounds 0.5 + 0.5, track self 7 - 3
        sp("detect", None, 1.5, 3.0), sp("sync", "track", 4.0, 6.0),
        sp("sync", "track", 7.0, 7.5), sp("sync", "track", 8.0, 8.5),
        sp("track", None, 3.0, 10.0), sp("emit", None, 21.0, 21.5), sp("emit", None, 22.0, 22.2),
        # chunk 1: forward wait 1, rounds 0.5, track self 7 - 1.5
        sp("detect", None, 31.0, 32.0), sp("sync", "track", 33.0, 34.0),
        sp("sync", "track", 35.0, 35.5), sp("track", None, 32.0, 39.0),
        sp("emit", None, 51.0, 52.0),
        # chunk 2 starts inside the profiled sub-window: left out
        sp("detect", None, 61.0, 62.0), sp("sync", "track", 63.0, 64.0),
        sp("track", None, 62.0, 69.0), sp("emit", None, 81.0, 82.0),
    ]


def _record(program: list | None = None) -> bench.RunRecord:
    return bench.RunRecord(_harness(), FRAMES, 1.0, (0.0, 90.0), [24.0, 54.0, 84.0], EXCLUDED,
                           None, program_spans=program)


def test_split_by_chunk_with_self_time_and_first_sync():
    rr = _record()
    assert {s[1] for s in rr.spans} == {0, 1, 2}     # chunk 2's events start after the window
    got = program_spans.split(rr.spans, _program(), rr.frames_per_chunk, EXCLUDED)
    per = 1e3 / (2 * FRAMES)                          # ms a frame of one second a chunk-pair
    assert got["detect_ms_per_frame"] == pytest.approx(2.5 * per)
    assert got["forward_wait_ms_per_frame"] == pytest.approx(3.0 * per)
    assert got["round_sync_ms_per_frame"] == pytest.approx(1.5 * per)
    assert got["track_ms_per_frame"] == pytest.approx((4.0 + 5.5) * per)
    assert got["host_syncs_per_chunk"] == pytest.approx(5 / 2)
    # events: chunks 0, 1 and 2 (its events span starts after the sub-window)
    assert got["alert_ms_per_frame"] == pytest.approx(1e3 * 2.7 / (3 * FRAMES))
    parts = sum(got[k] for k in program_spans.SUBMIT_PARTS)
    assert parts == pytest.approx(rr.ms_per_frame("submit") * 16.5 / 20)   # 3.5 s outside


def test_record_leaves_out_the_sub_window_and_reads_as_split():
    rr = _record(_program())
    assert all(not EXCLUDED[0] <= p.t0 <= EXCLUDED[1] for p in rr.program_spans)
    assert len(rr.program_spans) == len(_program()) - 3
    got = program_spans.split(rr.spans, _program(), rr.frames_per_chunk, EXCLUDED)
    for name in ("detect", "track"):
        assert rr.program_ms_per_frame(name) == pytest.approx(got[f"{name}_ms_per_frame"])
    assert rr.program_ms_per_frame("forward") is None          # no such span
    assert _record().program_ms_per_frame("detect") is None    # recorder off


def test_split_without_exclusion_counts_every_chunk():
    harness = _harness()
    got = program_spans.split(harness, _program(), FRAMES)
    per = 1e3 / (3 * FRAMES)
    assert got["forward_wait_ms_per_frame"] == pytest.approx(4.0 * per)
    assert got["host_syncs_per_chunk"] == pytest.approx(2.0)
    assert program_spans.split([], _program(), FRAMES) == {}


def test_idle_split_on_the_fixture():
    # harness as test_perfbench_devtrace.py's; offset 1000 s puts perf_counter s at trace us s*1e6
    harness = [("pack", 50e-6, 90e-6), ("submit", 90e-6, 400e-6), ("events", 400e-6, 500e-6)]
    program = [Span("detect", None, 90e-6, 100e-6, 1), Span("sync", "track", 180e-6, 300e-6, 1),
               Span("sync", "track", 320e-6, 340e-6, 1), Span("track", None, 180e-6, 390e-6, 1),
               Span("emit", None, 400e-6, 450e-6, 1)]
    r = devtrace.reduce(FIXTURE, harness, 1000.0, program=program)
    assert set(r) == {"busy_s", "window_s", "device_ops", "idle_gaps", "k1_launches", "kernels",
                      "kernel_table", "program_idle"}
    assert "program_idle" not in devtrace.reduce(FIXTURE, harness, 1000.0)
    assert r["busy_s"] == pytest.approx(110e-6, abs=1e-9)
    idle, window_s = r["program_idle"], r["window_s"]
    want = {"sync": 140e-6, "track": 50e-6, "detect": 10e-6, "emit": 50e-6, "outside": 90e-6}
    assert set(idle) == set(want)
    for k, v in want.items():
        assert idle[k] == pytest.approx(v, abs=1e-9), k
    assert sum(idle.values()) + r["busy_s"] == pytest.approx(r["window_s"], abs=1e-9)
    pct = program_spans.device_idle_track_pct(idle, window_s)
    assert pct == pytest.approx(100 * 190 / 450)
    assert pct <= 100.0 * (1.0 - r["busy_s"] / r["window_s"])     # device_idle_pct


def test_manifest_still_has_no_problems():
    assert manifest.problems(manifest.load_manifest()) == []


def test_tool_runs_a_cpu_cell(tmp_path):
    root = tiny_root(str(tmp_path))
    n = torch.get_num_threads()
    torch.set_num_threads(4)
    record, reduce = bench.RunRecord, devtrace.reduce
    try:
        res = program_spans.run(["--workload", "tiny", "--seed", "3000000011", "--seconds", "3",
                                 "--trace", "1"], root, device="cpu")
    finally:
        torch.set_num_threads(n)
    assert (bench.RunRecord, devtrace.reduce) == (record, reduce)
    assert not spans.enabled() and spans.drain() == []
    assert res["correct"], res["checks"]
    got = res["program_spans"]
    for k in program_spans.SUBMIT_PARTS + ("host_syncs_per_chunk", "alert_ms_per_frame",
                                           "device_idle_track_pct"):
        assert got[k] is not None and got[k] >= 0, k
    # two associations a tracker step, T = 2 steps a chunk
    assert got["host_syncs_per_chunk"] >= 2 * 2
    parts = sum(got[k] for k in program_spans.SUBMIT_PARTS)
    assert 0.95 * got["submit_ms_per_frame"] <= parts <= got["submit_ms_per_frame"]
    assert got["device_idle_track_pct"] <= res["metrics"]["device_idle_pct"]["value"] + 1e-9
