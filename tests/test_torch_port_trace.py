"""Device traces in the port (``profiling.trace_dir``) against the reference.

``_maybe_trace`` must start and stop its capture on the same calls as the
JAX pipeline's (both run unbound on a stub, their profilers patched to
record the call index); a real CPU capture through ``run_chunked`` and the
per-stage ``run`` writes one gzipped Chrome trace that
``profiling/trace_summary.py`` reads; the reader reads only device events
(kernels, copies, memsets), takes the device's busy time as the union of
their intervals and reads the newest trace; the loader takes
``trace_dir`` and ``trace_frames`` with the reference's default.
"""

from __future__ import annotations

import glob
import gzip
import json
import os
import time
from types import SimpleNamespace

import jax
import pytest
import torch

from rtmodt_tpu.config.loader import load_config as jax_load_config
from rtmodt_tpu.runtime.pipeline import Pipeline as JaxPipeline
from rtmodt_tpu_torch.config import load_config
from rtmodt_tpu_torch.profiling import trace_summary
from rtmodt_tpu_torch.runtime import pipeline as port_pipeline
from rtmodt_tpu_torch.runtime.pipeline import Pipeline
from tests.test_torch_port_threads import torch_threads  # noqa: F401 (autouse)

CALLS = 40


def _stub(trace_dir: str, trace_frames: int, **extra) -> SimpleNamespace:
    prof = SimpleNamespace(trace_dir=trace_dir, trace_frames=trace_frames)
    return SimpleNamespace(cfg=SimpleNamespace(profiling=prof),
                           _trace_state={"frames_left": 0, "active": False}, **extra)


def _drive(maybe_trace, stub, calls: list) -> tuple[list, list]:
    for i in range(CALLS):
        calls.append(i)
        maybe_trace(stub)
    return stub.starts, stub.stops


@pytest.mark.parametrize("trace_frames", [1, 3, 20])
def test_maybe_trace_starts_and_stops_on_the_reference_calls(trace_frames, tmp_path,
                                                             monkeypatch):
    calls: list = []
    want = _stub(str(tmp_path / "jax"), trace_frames, starts=[], stops=[])
    monkeypatch.setattr(jax.profiler, "start_trace",
                        lambda d: want.starts.append(calls[-1]))
    monkeypatch.setattr(jax.profiler, "stop_trace", lambda: want.stops.append(calls[-1]))
    _drive(JaxPipeline._maybe_trace, want, calls)

    got = _stub(str(tmp_path / "port"), trace_frames, starts=[], stops=[],
                device=torch.device("cpu"))
    monkeypatch.setattr(port_pipeline, "start_trace",
                        lambda d, dev: got.starts.append(calls[-1]) or "capture")
    monkeypatch.setattr(port_pipeline, "stop_trace",
                        lambda prof: got.stops.append((calls[-1], prof)))
    _drive(Pipeline._maybe_trace, got, calls)

    assert want.starts == [0] and want.stops == [trace_frames]
    assert got.starts == want.starts
    assert [i for i, _ in got.stops] == want.stops
    assert all(prof == "capture" for _, prof in got.stops)
    assert got._trace_state == want._trace_state == {"frames_left": 0, "active": False,
                                                     "done": True}


def test_no_trace_dir_never_captures(monkeypatch):
    monkeypatch.setattr(port_pipeline, "start_trace",
                        lambda *a: pytest.fail("a capture started without trace_dir"))
    stub = _stub(None, 20, device=torch.device("cpu"))
    for _ in range(5):
        Pipeline._maybe_trace(stub)
    assert stub._trace_state == {"frames_left": 0, "active": False}


def _cfg(trace_dir, **over):
    base = {"system": {"device": "cpu"},
            "detection": {"model": "yolov8n", "input_size": 128, "half": False},
            "profiling": {"trace_dir": str(trace_dir), "trace_frames": 2,
                          "warmup_frames": 0, "log_interval": 0},
            "visualization": {"enabled": False}, "events": {"enabled": False}}
    for section, values in over.items():
        base[section] = {**base.get(section, {}), **values}
    return load_config(overrides=base)


def _traces(d) -> list[str]:
    return glob.glob(os.path.join(str(d), "**", "*.trace.json.gz"), recursive=True)


def test_run_chunked_writes_one_trace_the_reader_reads(tmp_path):
    from rtmodt_tpu_torch.utils.synthetic import moving_boxes_frame

    tdir = tmp_path / "traces"
    pipe = Pipeline(_cfg(tdir, parallel={"chunk_size": 4}, profiling={"per_stage": False}),
                    device="cpu")
    frames = [moving_boxes_frame(t, 96, 160, 4)[0] for t in range(12)]
    summary = pipe.run_chunked(frames)
    assert summary["chunks"] == 3
    assert len(_traces(tdir)) == 1
    events = trace_summary.load_latest_trace(str(tdir))
    names = {e.get("name", "") for e in events if e.get("cat") == "cpu_op"}
    assert any(n.startswith("aten::conv") for n in names)
    # a CPU capture holds no device lane
    assert trace_summary.device_op_times(events) == ({}, {})
    assert pipe._trace_state == {"frames_left": 0, "active": False, "done": True}
    assert not torch._C._autograd._profiler_enabled()


def test_per_stage_run_traces_step_and_the_bgr_window_traces_nothing(tmp_path, monkeypatch):
    from rtmodt_tpu_torch.utils.synthetic import write_synthetic_video

    clip = str(tmp_path / "clip.mp4")
    write_synthetic_video(clip, frames=6, h=96, w=160, n_objects=2)
    calls = {"step": 0}
    inner_step = Pipeline.step

    def step(self, *a, **k):
        calls["step"] += 1
        return inner_step(self, *a, **k)

    monkeypatch.setattr(Pipeline, "step", step)
    tdir = tmp_path / "per_stage"
    pipe = Pipeline(_cfg(tdir), device="cpu")
    pipe.run(clip)
    assert calls["step"] == 6 and len(_traces(tdir)) == 1
    events = trace_summary.load_latest_trace(str(tdir))
    assert any(e.get("name", "").startswith("aten::") for e in events)
    assert pipe._trace_state["done"] and not torch._C._autograd._profiler_enabled()

    # the fused BGR program in a window: submit, which the reference never traces
    tdir = tmp_path / "bgr"
    pipe = Pipeline(_cfg(tdir, profiling={"per_stage": False},
                         parallel={"transport": "bgr", "pipeline_depth": 2,
                                   "chunk_size": 1}), device="cpu")
    calls["step"] = 0
    pipe.run(clip)
    assert calls["step"] == 0 and _traces(tdir) == []
    assert pipe._trace_state == {"frames_left": 0, "active": False}


def _kineto_events() -> list:
    """A hand-built Kineto trace: a GPU lane with a kernel, a copy, a memset
    and a device annotation span; a CPU lane with ops and a launch."""
    return [
        {"ph": "M", "name": "process_name", "pid": 0, "args": {"name": "python"}},
        {"ph": "X", "cat": "cpu_op", "name": "aten::conv2d", "pid": 0, "tid": 1,
         "ts": 0.0, "dur": 900.0},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "pid": 0, "tid": 1,
         "ts": 10.0, "dur": 5.0, "args": {"correlation": 7}},
        {"ph": "X", "cat": "python_function", "name": "forward", "pid": 0, "tid": 1,
         "ts": 0.0, "dur": 1000.0},
        {"ph": "X", "cat": "user_annotation", "name": "chunk", "pid": 0, "tid": 1,
         "ts": 0.0, "dur": 1000.0},
        {"ph": "X", "cat": "kernel", "name": "conv_kernel", "pid": 1, "tid": 7,
         "ts": 20.0, "dur": 250.0, "args": {"correlation": 7}},
        {"ph": "X", "cat": "kernel", "name": "conv_kernel", "pid": 1, "tid": 7,
         "ts": 300.0, "dur": 150.0},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD (Pinned -> Device)",
         "pid": 1, "tid": 8, "ts": 5.0, "dur": 40.0},
        {"ph": "X", "cat": "gpu_memset", "name": "Memset (Device)", "pid": 1, "tid": 8,
         "ts": 50.0, "dur": 2.0},
        {"ph": "X", "cat": "gpu_user_annotation", "name": "chunk", "pid": 1, "tid": 7,
         "ts": 0.0, "dur": 600.0},
        {"ph": "f", "cat": "ac2g", "name": "ac2g", "pid": 1, "tid": 7, "ts": 20.0},
    ]


def test_device_op_times_sums_only_device_events_in_ms():
    by_op, calls = trace_summary.device_op_times(_kineto_events())
    assert by_op == pytest.approx({"conv_kernel": 0.4, "Memcpy HtoD (Pinned -> Device)": 0.04,
                                   "Memset (Device)": 0.002})
    assert calls == {"conv_kernel": 2, "Memcpy HtoD (Pinned -> Device)": 1,
                     "Memset (Device)": 1}


def _write(path, events, gz: bool = True) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    opener = gzip.open if gz else open
    with opener(path, "wt") as f:
        json.dump({"traceEvents": events}, f)


def test_device_total_ms_reads_the_newest_trace(tmp_path):
    older = [{"ph": "X", "cat": "kernel", "name": "k", "pid": 1, "tid": 7, "ts": 0.0,
              "dur": 5000.0}]
    _write(str(tmp_path / "a" / "host_1.1.pt.trace.json.gz"), older)
    _write(str(tmp_path / "b" / "deep" / "host_2.2.pt.trace.json.gz"), _kineto_events())
    now = time.time()
    os.utime(tmp_path / "a" / "host_1.1.pt.trace.json.gz", (now - 60, now - 60))
    # the copy at 5-45 us overlaps the kernel at 20-270 us: 5-270 and 300-450 are busy
    assert trace_summary.device_total_ms(str(tmp_path)) == pytest.approx(0.415)
    # a plain .trace.json is found too; no trace at all reads as nothing
    _write(str(tmp_path / "c" / "x.trace.json"), older, gz=False)
    assert trace_summary.device_total_ms(str(tmp_path)) == pytest.approx(5.0)
    assert trace_summary.load_latest_trace(str(tmp_path / "none")) == []


def test_device_total_ms_refuses_a_card_capture_without_device_events(tmp_path):
    host_only = [e for e in _kineto_events()
                 if e.get("cat") not in trace_summary.DEVICE_CATEGORIES]
    _write(str(tmp_path / "t" / "host_1.1.pt.trace.json.gz"), host_only)
    # a CPU capture holds no device lane: 0 ms is its reading
    assert trace_summary.device_total_ms(str(tmp_path / "t")) == 0.0
    assert trace_summary.device_total_ms(str(tmp_path / "t"), "cpu") == 0.0
    # a capture of the card without its CUDA lane, or no trace at all, is no reading
    for d in ("t", "none"):
        with pytest.raises(RuntimeError, match="no device event"):
            trace_summary.device_total_ms(str(tmp_path / d), torch.device("cuda", 0))
    _write(str(tmp_path / "t" / "host_2.2.pt.trace.json.gz"), _kineto_events())
    now = time.time()
    os.utime(tmp_path / "t" / "host_1.1.pt.trace.json.gz", (now - 60, now - 60))
    assert trace_summary.device_total_ms(str(tmp_path / "t"), "cuda") == pytest.approx(0.415)


@pytest.mark.parametrize("events, busy_ms", [
    # a copy inside a kernel counts once; one past its end adds its tail
    ([("kernel", 0.0, 100.0), ("gpu_memcpy", 10.0, 20.0)], 0.1),
    ([("kernel", 0.0, 100.0), ("gpu_memcpy", 80.0, 40.0)], 0.12),
    # two kernels on two streams at once, a memset between, a gap after
    ([("kernel", 0.0, 50.0), ("kernel", 25.0, 50.0), ("gpu_memset", 75.0, 5.0),
      ("kernel", 200.0, 10.0)], 0.09),
], ids=["inside", "past-the-end", "two-streams"])
def test_device_total_ms_counts_overlapping_events_once(tmp_path, events, busy_ms):
    trace = [{"ph": "X", "cat": cat, "name": f"{cat}{i}", "pid": 1, "tid": 7 + i, "ts": ts,
              "dur": dur} for i, (cat, ts, dur) in enumerate(events)]
    _write(str(tmp_path / "host_1.1.pt.trace.json.gz"), trace)
    by_op, _ = trace_summary.device_op_times(trace)
    assert trace_summary.device_total_ms(str(tmp_path), "cuda") == pytest.approx(busy_ms)
    assert trace_summary.device_total_ms(str(tmp_path)) < sum(by_op.values())


def test_loader_takes_trace_dir_and_the_reference_trace_frames(tmp_path):
    assert load_config().profiling.trace_frames == jax_load_config().profiling.trace_frames == 20
    d = str(tmp_path / "t")
    cfg = load_config(overrides={"profiling": {"trace_dir": d, "trace_frames": 5}})
    ref = jax_load_config(overrides={"profiling": {"trace_dir": d, "trace_frames": 5}})
    assert (cfg.profiling.trace_dir, cfg.profiling.trace_frames) == (d, 5)
    assert (ref.profiling.trace_dir, ref.profiling.trace_frames) == (d, 5)
    for off in (None, ""):
        assert not load_config(overrides={"profiling": {"trace_dir": off}}).profiling.trace_dir
    assert load_config().profiling.trace_dir is None
