"""Capture torch.profiler Chrome-format traces and summarize their device lanes.

The port's counterpart of ``rtmodt_tpu/profiling/trace_summary.py``.
``start_trace`` / ``stop_trace`` play ``jax.profiler.start_trace`` /
``stop_trace``: a capture of the CPU activity, and the card's (CUPTI) on a
CUDA device, written on stop as one gzipped Chrome trace
(``*.pt.trace.json.gz``) into the directory.  The readers pull the DEVICE
events out of such a trace: the ``ph == "X"`` events whose category is
``kernel``, ``gpu_memcpy`` or ``gpu_memset``.  The CPU lanes (``cpu_op``,
``cuda_runtime``, ``python_function``, user annotations) and the device's
own annotation spans are left out, so host time is never counted as device
time and no op is counted twice.  Used by the pipeline's
``profiling.trace_dir`` capture, ``tools/trace_chunk_torch.py`` (top device
ops) and ``tools/bench_dense_torch.py`` (device ms/frame).

A capture turns the program's span recorder (``profiling/spans.py``) on for
its window, where nothing else has it on, and writes the spans into its
trace as a host lane (process ``program spans``, a thread each), their
``perf_counter`` times put on the trace's clock: microseconds of the Unix
clock from ``baseTimeNanoseconds``.
"""

from __future__ import annotations

import glob
import gzip
import json
import os
import socket
import time
from collections import defaultdict

import torch

from rtmodt_tpu_torch.profiling import spans

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def start_trace(out_dir: str, device: torch.device | str,
                record_shapes: bool = False) -> "torch.profiler.profile":
    """Start a capture that writes its trace into ``out_dir`` when
    ``stop_trace`` stops it: the CPU activity, plus the card's on a CUDA
    ``device``, plus the program's spans of the window.  ``record_shapes``
    keeps every op's input shapes (what ``tools/trace_chunk_torch.py
    --attribute`` reads)."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(out_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    lane: list[spans.Span] = []
    prof = profile(activities=activities, record_shapes=record_shapes,
                   on_trace_ready=lambda p: _write_trace(p, out_dir, lane))
    prof.span_lane = lane
    prof.owns_spans = not spans.enabled()
    if prof.owns_spans:
        spans.drain()           # spans an earlier owner left behind
        spans.enable()
    prof.start()
    return prof


def stop_trace(prof: "torch.profiler.profile") -> None:
    """Stop a capture of ``start_trace`` and write its trace file; the
    program's spans of its window go in as a host lane where the capture
    turned the recorder on (else its owner keeps them)."""
    if prof.owns_spans:
        spans.disable()
        prof.span_lane.extend(spans.drain())
    prof.stop()


def _host_lane(recorded: list, base_ns: float, unix_off: float) -> list[dict]:
    """Chrome trace events of the program's spans: complete events of the
    process ``program spans``, a thread per recording thread, at
    microseconds of the Unix clock from ``base_ns``."""
    pid = "program spans"
    out = [{"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
            "args": {"name": pid}},
           {"ph": "M", "name": "process_sort_index", "pid": pid, "tid": 0,
            "args": {"sort_index": -1}}]
    for s in recorded:
        out.append({"ph": "X", "cat": "program_span", "name": s.name, "pid": pid,
                    "tid": s.thread, "ts": (s.t0 + unix_off) * 1e6 - base_ns / 1e3,
                    "dur": (s.t1 - s.t0) * 1e6, "args": {"parent": s.parent}})
    return out


def _write_trace(prof, out_dir: str, lane: list) -> None:
    """The capture's ``on_trace_ready``: one ``<host>_<pid>.<ns>.pt.trace.json.gz``
    in ``out_dir`` (the name ``tensorboard_trace_handler`` gives), with the
    program's spans added."""
    path = os.path.join(out_dir, f"{socket.gethostname()}_{os.getpid()}."
                                 f"{time.time_ns()}.pt.trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        trace = json.load(f)
    os.remove(path)
    trace["traceEvents"].extend(_host_lane(lane, float(trace.get("baseTimeNanoseconds", 0)),
                                          spans.unix_offset()))
    with gzip.open(path + ".gz", "wt") as f:
        json.dump(trace, f)


def load_latest_trace(out_dir: str) -> list:
    """traceEvents of the most recent ``*.trace.json.gz`` (or ``*.trace.json``)
    under ``out_dir``, searched recursively ([] if none)."""
    paths = [p for pattern in ("*.trace.json.gz", "*.trace.json")
             for p in glob.glob(os.path.join(out_dir, "**", pattern), recursive=True)]
    if not paths:
        return []
    path = max(paths, key=os.path.getmtime)
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        trace = json.load(f)
    return trace.get("traceEvents", [])


def device_events(events: list) -> list:
    """The device events of a trace: kernels, copies and memsets."""
    return [e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATEGORIES]


def device_op_times(events: list) -> tuple[dict[str, float], dict[str, int]]:
    """(total_ms_by_op, call_count_by_op) over the device events."""
    by_op: dict[str, float] = defaultdict(float)
    n_ev: dict[str, int] = defaultdict(int)
    for e in device_events(events):
        name = e.get("name", "?")
        by_op[name] += e.get("dur", 0) / 1e3          # us -> ms
        n_ev[name] += 1
    return dict(by_op), dict(n_ev)


def _busy_intervals(events: list) -> list[tuple[float, float]]:
    """The union of the device events' [ts, ts + dur) intervals (us),
    merged and sorted."""
    out: list[list[float]] = []
    for a, b in sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)))
                       for e in device_events(events)):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def device_total_ms(out_dir: str, device: torch.device | str | None = None) -> float:
    """The device's busy time (ms) in the latest trace under out_dir: the
    union of its kernels', copies' and memsets' intervals, so a copy that
    overlaps a kernel counts once (as ``perfbench/devtrace.py`` reads it).
    Given the CUDA ``device`` the capture ran on, raises when that trace is
    missing or holds no device event (CUPTI gave no CUDA lane), so that an
    empty lane is never read as 0 ms."""
    busy = _busy_intervals(load_latest_trace(out_dir))
    if device is not None and torch.device(device).type == "cuda" and not busy:
        raise RuntimeError(f"no device event in a trace of the card under {out_dir} "
                           "(no trace file, or a capture without its CUDA lane)")
    return sum(b - a for a, b in busy) / 1e3
