"""The program's own spans (``rtmodt_tpu_torch/profiling/spans.py``) read
beside the harness's: where the chunk program's host time goes, and the
device's idle time under each of them.

    python3 perfbench/program_spans.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

runs one run of the cell as ``perfbench/run.py`` does, with the program's
span recorder on from before the warm-up (through ``bench.run``'s
``pipeline`` hook), and prints the run's result line with a
``program_spans`` object added, last on standard output.  With ``--trace
0`` it also measures what the recorder costs when on: compare its ``fps``
with ``run.py``'s on the same seed.  The benchmark's own runs never run it:
``bench.py`` keeps its spans and the trace's path to itself, so this tool
takes them from ``bench.RunRecord`` and ``devtrace.reduce``, which it wraps.

Readings (ms a frame over the frames of the chunks counted; a program span
belongs to the chunk whose harness ``submit`` or ``events`` span contains
it, and those starting inside the profiled sub-window are left out, as the
harness leaves out its own):

  * ``detect_ms_per_frame``: ``detect`` spans;
  * ``forward_wait_ms_per_frame``: the first ``sync`` span inside each
    ``track`` span, the host blocked until the chunk's forward and K1 ran;
  * ``track_ms_per_frame``: ``track`` spans less their ``sync`` children,
    the host launching the tracker's kernels;
  * ``round_sync_ms_per_frame``: every other ``sync`` span, the host blocked
    on a greedy round's read;
  * ``host_syncs_per_chunk``: ``sync`` spans over chunks submitted;
  * ``alert_ms_per_frame``: ``emit`` spans, the zone engine's alerts;
  * ``device_idle_track_pct`` (``--trace 1``): the traced window's idle time
    that falls while the host is inside a ``track`` span (its ``sync``
    children included), over the window.

The four ``submit`` parts sum to the harness's ``submit_ms_per_frame``, less
the chunk program's few Python lines outside ``detect`` and ``track``."""

import time

T_START = time.perf_counter()

import bisect  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from collections import defaultdict  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from perfbench import bench, devtrace, manifest  # noqa: E402

SUBMIT_PARTS = ("detect_ms_per_frame", "forward_wait_ms_per_frame", "track_ms_per_frame",
                "round_sync_ms_per_frame")


def by_chunk(harness: list, program: list, excluded: tuple[float, float] | None = None
             ) -> tuple[dict[int, list], dict[int, list], int, int]:
    """(program spans of each chunk's ``submit``, of each chunk's
    ``events``, chunks submitted, chunks consumed): ``harness`` holds the
    harness's (name, chunk, t0, t1), ``program`` the recorder's spans."""
    lo, hi = excluded or (float("inf"), float("-inf"))
    outer = {n: sorted((s[2], s[3], s[1]) for s in harness if s[0] == n)
             for n in ("submit", "events")}
    starts = {n: [s[0] for s in items] for n, items in outer.items()}
    got: dict[str, dict[int, list]] = {n: defaultdict(list) for n in outer}
    for p in program:
        if lo <= p.t0 <= hi:
            continue
        for n, items in outer.items():
            i = bisect.bisect_right(starts[n], p.t0) - 1     # the last span to start first
            if i >= 0 and p.t1 <= items[i][1]:
                got[n][items[i][2]].append(p)
                break
    return got["submit"], got["events"], len(outer["submit"]), len(outer["events"])


def split(harness: list, program: list, frames_per_chunk: int,
          excluded: tuple[float, float] | None = None) -> dict[str, float]:
    """The host readings above (all but the device's), from the harness's
    spans and the program's."""
    sub, ev, n_sub, n_ev = by_chunk(harness, program, excluded)
    if not n_sub:
        return {}
    ms = defaultdict(float)
    syncs = 0
    for items in sub.values():
        sync = [s for s in items if s.name == "sync"]
        syncs += len(sync)
        for s in items:
            if s.name == "detect":
                ms["detect"] += s.t1 - s.t0
        for t in (s for s in items if s.name == "track"):
            inner = sorted((s for s in sync if s.thread == t.thread and t.t0 <= s.t0
                            and s.t1 <= t.t1), key=lambda s: s.t0)
            ms["track"] += (t.t1 - t.t0) - sum(s.t1 - s.t0 for s in inner)
            if inner:
                ms["forward_wait"] += inner[0].t1 - inner[0].t0
                ms["round_sync"] += sum(s.t1 - s.t0 for s in inner[1:])
    out = {f"{k}_ms_per_frame": 1e3 * ms[k] / (n_sub * frames_per_chunk)
           for k in ("detect", "forward_wait", "track", "round_sync")}
    out["host_syncs_per_chunk"] = syncs / n_sub
    if n_ev:
        emit = sum(s.t1 - s.t0 for items in ev.values() for s in items if s.name == "emit")
        out["alert_ms_per_frame"] = 1e3 * emit / (n_ev * frames_per_chunk)
    return out


def idle_by_span(path: str, harness: list[tuple[str, float, float]], program: list,
                 unix_off: float) -> tuple[dict[str, float], float]:
    """(idle seconds of the traced window by program span, the window's
    seconds): the window and the device's busy time as ``devtrace.reduce``
    takes them, from the traced chunks' harness spans (name, t0, t1); each
    part of an idle gap goes to the innermost program span open over it
    (``sync`` inside ``track``), ``outside`` where none is."""
    raw, base_us = devtrace.load(path)

    def us(t: float) -> float:
        return (t + unix_off) * 1e6 - base_us

    w0, w1 = min(us(a) for _, a, _ in harness), max(us(b) for _, _, b in harness)
    dev = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))) for e in raw
           if e.get("ph") == "X" and e.get("cat") in devtrace.DEVICE_CATS]
    rest = devtrace.gaps(devtrace.union(devtrace.clip(dev, w0, w1)), w0, w1)
    idle: dict[str, float] = defaultdict(float)
    names = sorted({p.name for p in program}, key=lambda n: n != "sync")   # innermost first
    for name in names:
        under = devtrace.union(devtrace.clip([(us(p.t0), us(p.t1)) for p in program
                                              if p.name == name], w0, w1))
        left = []
        for a, b in rest:
            hit = devtrace.clip(under, a, b)
            idle[name] += sum(y - x for x, y in hit) * 1e-6
            left.extend(devtrace.gaps(hit, a, b))
        rest = left
    idle["outside"] += sum(b - a for a, b in rest) * 1e-6
    return dict(idle), (w1 - w0) * 1e-6


def device_idle_track_pct(idle: dict[str, float], window_s: float) -> float:
    """The window's idle share while the host is inside ``track`` (its
    ``sync`` children included), in percent."""
    return 100.0 * (idle.get("track", 0.0) + idle.get("sync", 0.0)) / window_s


def run(argv: list[str], root: str = manifest.ROOT, device: str | None = None) -> dict:
    """One run of the cell with the recorder on; the result line's object
    with ``program_spans`` added (``root`` and ``device`` as ``bench.run``
    takes them)."""
    from rtmodt_tpu_torch.profiling import spans

    args = bench.parse_args(argv)
    seen: dict = {"program": []}
    record, reduce = bench.RunRecord, devtrace.reduce

    def traced_reduce(path, host_spans, unix_off, *a, **k):
        out = reduce(path, host_spans, unix_off, *a, **k)
        seen["program"].extend(spans.drain())
        lo, hi = min(s[1] for s in host_spans), max(s[2] for s in host_spans)
        inside = [p for p in seen["program"] if lo <= p.t0 and p.t1 <= hi]
        seen["idle"] = idle_by_span(path, host_spans, inside, unix_off)
        return out

    class Record(record):
        def __init__(self, harness, frames_per_chunk, flops, window, emitted, excluded,
                     trace):
            super().__init__(harness, frames_per_chunk, flops, window, emitted, excluded, trace)
            spans.disable()
            seen["program"].extend(spans.drain())
            seen.update(harness=self.spans, frames_per_chunk=frames_per_chunk,
                        excluded=excluded, submit=self.ms_per_frame("submit"))

    bench.RunRecord, devtrace.reduce = Record, traced_reduce
    try:
        result = bench.run(args, T_START, root, device,
                           hooks={"pipeline": lambda pipe, pool: spans.enable()})
    finally:
        bench.RunRecord, devtrace.reduce = record, reduce
        spans.disable()
    got = split(seen["harness"], seen["program"], seen["frames_per_chunk"], seen["excluded"])
    got["submit_ms_per_frame"] = seen["submit"]
    got["spans_recorded"] = len(seen["program"])
    if "idle" in seen:
        idle, window_s = seen["idle"]
        got["device_idle_track_pct"] = device_idle_track_pct(idle, window_s)
        print("perfbench: idle s by program span " + ", ".join(
            f"{k} {v:.4f}" for k, v in sorted(idle.items(), key=lambda x: -x[1]))
            + f" of a {window_s:.4f} s window", file=sys.stderr)
    parts = sum(got.get(k, 0.0) for k in SUBMIT_PARTS)
    print(f"perfbench: submit {got['submit_ms_per_frame']:.4f} ms a frame, its four parts "
          f"{parts:.4f}", file=sys.stderr)
    result["program_spans"] = got
    return result


if __name__ == "__main__":
    res = run(sys.argv[1:])
    print(json.dumps(res), flush=True)
