"""A torch.profiler trace of a steady sub-window, and its reduction.

Only the device's activity is traced (recording every host-side operator
would slow the host, which paces this program, by a third); the harness's
own spans come from its host clock and are placed on the trace's clock,
which counts microseconds of the Unix clock from ``baseTimeNanoseconds``.

The device's busy time is the union of the intervals of its operations
(kernels, copies, memsets): a copy that overlaps a kernel counts once.  The
traced window runs from the start of the first to the end of the last
harness span of the traced chunks; its idle gaps, the parts of the window
no device operation covers, are split over the harness spans open during
them, each part to the innermost span (``between spans`` where none is)."""

from __future__ import annotations

import gzip
import json
import time
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
K1_KERNELS = ("nms_greedy_kernel", "nms_wide_compact")   # one per K1 launch
OUTER_SPANS = ("due",)   # the open loop's wait for its next chunk, around consumes


def start(on_card: bool):
    import torch

    act = torch.profiler.ProfilerActivity
    prof = torch.profiler.profile(activities=[act.CUDA if on_card else act.CPU])
    prof.start()
    return prof


def unix_offset() -> float:
    """Unix time minus ``time.perf_counter()``, in seconds (the closest of a
    few readings)."""
    best = None
    for _ in range(5):
        a = time.perf_counter()
        u = time.time()
        b = time.perf_counter()
        if best is None or b - a < best[0]:
            best = (b - a, u - 0.5 * (a + b))
    return best[1]


def stop(prof, path: str | None) -> None:
    """Stop the profiler and write its Chrome trace to ``path`` (None: drop it)."""
    prof.stop()
    if path is not None:
        prof.export_chrome_trace(path)


def load(path: str) -> tuple[list[dict], float]:
    """(events, the trace clock's zero in Unix microseconds)."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        data = json.load(f)
    if isinstance(data, list):
        return data, 0.0
    return data["traceEvents"], float(data.get("baseTimeNanoseconds", 0)) / 1e3


def kernel_name(name: str) -> str:
    """A demangled kernel name without its namespaces, template and
    parameters: ``(anonymous namespace)::nms_greedy_kernel(float4 const*,
    ...)`` -> ``nms_greedy_kernel``."""
    base = name.split("(anonymous namespace)::")[-1].split("(")[0].split("<")[0]
    return base.split("::")[-1].strip()


def union(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    """Merged, sorted intervals."""
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def clip(intervals: list[tuple[float, float]], w0: float, w1: float) -> list[tuple[float, float]]:
    return [(max(a, w0), min(b, w1)) for a, b in intervals if b > w0 and a < w1]


def gaps(busy: list[tuple[float, float]], w0: float, w1: float) -> list[tuple[float, float]]:
    out, t = [], w0
    for a, b in busy:
        if a > t:
            out.append((t, a))
        t = max(t, b)
    if t < w1:
        out.append((t, w1))
    return out


def reduce(path: str, host_spans: list[tuple[str, float, float]], unix_off: float,
           k1_names: tuple[str, ...] = K1_KERNELS, top: int = 10) -> dict:
    """Busy and window seconds, the top device operations, idle seconds by
    harness span, and the K1 launches the trace holds.  ``host_spans`` are
    the traced chunks' (name, start, end) on ``time.perf_counter()``, and
    ``unix_off`` that clock's offset to the Unix clock."""
    raw, base_us = load(path)
    events = [e for e in raw if e.get("ph") == "X"]
    spans = [((a + unix_off) * 1e6 - base_us, (b + unix_off) * 1e6 - base_us, name)
             for name, a, b in host_spans]
    if not spans:
        raise ValueError("no harness span in the traced sub-window")
    w0, w1 = min(s[0] for s in spans), max(s[1] for s in spans)
    dev = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)), str(e["name"]))
           for e in events if e.get("cat") in DEVICE_CATS]
    busy = union(clip([(a, b) for a, b, _ in dev], w0, w1))
    busy_us = sum(b - a for a, b in busy)
    by_op: dict[str, float] = defaultdict(float)
    for a, b, name in dev:
        lo, hi = max(a, w0), min(b, w1)
        if hi > lo:
            by_op[name[:160]] += (hi - lo) * 1e-6
    idle: dict[str, float] = defaultdict(float)
    inner = [s for s in spans if s[2] not in OUTER_SPANS]
    outer = [s for s in spans if s[2] in OUTER_SPANS]
    for a, b in gaps(busy, w0, w1):
        # each part of a gap goes to the innermost harness span open over it
        rest = [(a, b)]
        for level in (inner, outer):
            left = []
            for x0, x1 in rest:
                hit = []
                for s0, s1, name in level:
                    lo, hi = max(x0, s0), min(x1, s1)
                    if hi > lo:
                        idle[name] += (hi - lo) * 1e-6
                        hit.append((lo, hi))
                left.extend(gaps(union(hit), x0, x1))
            rest = left
        for x0, x1 in rest:
            idle["between spans"] += (x1 - x0) * 1e-6
    k1 = sum(1 for _, _, name in dev if kernel_name(name) in k1_names)
    return {
        "busy_s": busy_us * 1e-6,
        "window_s": (w1 - w0) * 1e-6,
        "device_ops": sorted(([k, v] for k, v in by_op.items()), key=lambda x: -x[1])[:top],
        "idle_gaps": sorted(([k, v] for k, v in idle.items()), key=lambda x: -x[1])[:top],
        "k1_launches": k1,
        "kernels": sum(1 for e in events if e.get("cat") == "kernel"),
    }
