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
them, each part to the innermost span (``between spans`` where none is).
Given the program's own spans (``rtmodt_tpu_torch/profiling/spans.py``),
the gaps are split over them too (``program_idle``).  ``kernel_table``
holds every kernel of the window by its short name (``kernel_name``): its
seconds inside the window and its launches, for a reader of any kernel's
roofline share."""

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


def program_idle(idle_gaps: list[tuple[float, float]], program: list[tuple[str, float, float]],
                 w0: float, w1: float) -> dict[str, float]:
    """Idle seconds by program span: each part of a gap (trace microseconds)
    to the innermost program span (name, start, end) open over it, ``sync``
    being the only one that nests in another; ``outside`` where none is."""
    rest = idle_gaps
    idle: dict[str, float] = defaultdict(float)
    for name in sorted({n for n, _, _ in program}, key=lambda n: (n != "sync", n)):
        under = union(clip([(a, b) for n, a, b in program if n == name], w0, w1))
        left = []
        for a, b in rest:
            hit = clip(under, a, b)
            idle[name] += sum(y - x for x, y in hit) * 1e-6
            left.extend(gaps(hit, a, b))
        rest = left
    idle["outside"] += sum(b - a for a, b in rest) * 1e-6
    return dict(idle)


def reduce(path: str, host_spans: list[tuple[str, float, float]], unix_off: float,
           k1_names: tuple[str, ...] = K1_KERNELS, top: int = 10,
           program: list | None = None) -> dict:
    """Busy and window seconds, the top device operations, idle seconds by
    harness span, the K1 launches the trace holds and every kernel's seconds
    and launches.  ``host_spans`` are the traced chunks' (name, start, end)
    on ``time.perf_counter()``, and ``unix_off`` that clock's offset to the
    Unix clock; ``program``, the program's spans on the same clock, adds
    ``program_idle``."""
    raw, base_us = load(path)
    events = [e for e in raw if e.get("ph") == "X"]

    def us(t: float) -> float:
        return (t + unix_off) * 1e6 - base_us

    spans = [(us(a), us(b), name) for name, a, b in host_spans]
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
    table: dict[str, dict] = {}
    for e in events:
        a = float(e["ts"])
        lo, hi = max(a, w0), min(a + float(e.get("dur", 0.0)), w1)
        if e.get("cat") == "kernel" and hi > lo:
            row = table.setdefault(kernel_name(str(e["name"])), {"seconds": 0.0, "launches": 0})
            row["seconds"] += (hi - lo) * 1e-6
            row["launches"] += 1
    out = {
        "busy_s": busy_us * 1e-6,
        "window_s": (w1 - w0) * 1e-6,
        "device_ops": sorted(([k, v] for k, v in by_op.items()), key=lambda x: -x[1])[:top],
        "idle_gaps": sorted(([k, v] for k, v in idle.items()), key=lambda x: -x[1])[:top],
        "k1_launches": k1,
        "kernels": sum(1 for e in events if e.get("cat") == "kernel"),
        "kernel_table": table,
    }
    if program is not None:
        out["program_idle"] = program_idle(gaps(busy, w0, w1),
                                           [(p.name, us(p.t0), us(p.t1)) for p in program],
                                           w0, w1)
    return out
