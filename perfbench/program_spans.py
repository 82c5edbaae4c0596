"""The program's own spans (``rtmodt_tpu_torch/profiling/spans.py``) read
beside the harness's: where the chunk program's host time goes, and the
device's idle time under each of them.

    python3 perfbench/program_spans.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

runs one run of the cell as ``perfbench/run.py`` does and prints the run's
result line with a ``program_spans`` object added, last on standard output.
With ``--trace 1`` the harness records the program's spans itself and hands
them over in its ``RunRecord`` (``program_spans``, ``program_counters``, and
the trace's ``program_idle``), which this tool reads.  With ``--trace 0``
the tool turns the recorder on from before the warm-up (through
``bench.run``'s ``pipeline`` hook), which the harness never does there: its
``fps`` against ``run.py``'s on the same seed is what the recorder costs
when on.  The benchmark's own runs never run it; its per-layer readers take
``split``'s attribution through ``RunRecord.program_ms_per_frame``.

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

from perfbench import bench, manifest  # noqa: E402

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
    seen: dict = {}

    def keep(rr) -> None:
        if not args.trace:
            spans.disable()
            seen["program"] = spans.drain()
        seen["run"] = rr

    hooks = {"run": keep}
    if not args.trace:
        hooks["pipeline"] = lambda pipe, pool: spans.enable()
    try:
        result = bench.run(args, T_START, root, device, hooks=hooks)
    finally:
        spans.disable()
    rr = seen["run"]
    program = rr.program_spans if args.trace else seen["program"]
    got: dict = split(rr.spans, program, rr.frames_per_chunk)
    got["submit_ms_per_frame"] = rr.ms_per_frame("submit")
    got["spans_recorded"] = len(program)
    if rr.program_counters is not None:
        got["program_counters"] = rr.program_counters
    if rr.trace is not None:
        idle, window_s = rr.trace["program_idle"], rr.trace["window_s"]
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
