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
"""

from __future__ import annotations

import glob
import gzip
import json
import os
from collections import defaultdict

import torch

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def start_trace(out_dir: str, device: torch.device | str,
                record_shapes: bool = False) -> "torch.profiler.profile":
    """Start a capture that writes its trace into ``out_dir`` when
    ``stop_trace`` stops it: the CPU activity, plus the card's on a CUDA
    ``device``.  ``record_shapes`` keeps every op's input shapes (what
    ``tools/trace_chunk_torch.py --attribute`` reads)."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    os.makedirs(out_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities, record_shapes=record_shapes,
                   on_trace_ready=tensorboard_trace_handler(out_dir, use_gzip=True))
    prof.start()
    return prof


def stop_trace(prof: "torch.profiler.profile") -> None:
    """Stop a capture of ``start_trace`` and write its trace file."""
    prof.stop()


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


def device_total_ms(out_dir: str, device: torch.device | str | None = None) -> float:
    """Total device op time (ms) in the latest trace under out_dir.  Given the
    CUDA ``device`` the capture ran on, raises when that trace is missing or
    holds no device event (CUPTI gave no CUDA lane), so that an empty lane is
    never read as 0 ms."""
    by_op, _ = device_op_times(load_latest_trace(out_dir))
    if device is not None and torch.device(device).type == "cuda" and not by_op:
        raise RuntimeError(f"no device event in a trace of the card under {out_dir} "
                           "(no trace file, or a capture without its CUDA lane)")
    return sum(by_op.values())
