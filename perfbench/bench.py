"""The benchmark harness of ``rtmodt_tpu_torch``: many camera streams through
``MultiStreamPipeline``'s multi-stream chunk program.

One run (``perfbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>``):

  1. loads the cell's configuration and traffic from their own files
     (``manifest.py``);
  2. builds the program through its normal constructor
     (``MultiStreamPipeline`` with a ``PipelineConfig`` made from the
     configuration file) and its native kernels (``_build``, cached under
     the checkout's ``build/``); a configuration whose ``weights`` is
     ``{"seed": n}`` has its architecture module (``manifest.arch_module``)
     write them first, into the run's temporary directory, from its own
     seed, and the program and the reference read that one file;
  3. makes every stream's camera frames from the seed (``scenes.py``);
  4. warms up the cell's one chunk shape with two real chunks, then resets
     the trackers;
  5. drives the loop ``MultiStreamPipeline.run`` drives, without its decode
     threads, for ``--seconds``: ``ops/yuv.py::pack_chunk`` packs each of
     the chunk's T frame times (S frames) into pinned planes,
     ``submit_chunk_packed`` runs the chunk program, the track outputs are
     copied to pinned host buffers with ``depth`` chunks in flight, and one
     ``ZoneEventEngine`` per stream consumes each chunk.  A closed loop has
     every frame ready ahead; an open loop makes each frame due on its
     camera's clock and waits for a chunk's last frame;
  6. reads the peak memory, frees the program and runs the correctness
     comparison (``check.py``), then prints one JSON line.

Spans of the harness's calls into each layer are kept on the host clock
(``pack``, ``submit``, ``copy``, ``wait``, ``events``, and ``due`` for an
open loop's wait for its next chunk).  With ``--trace 1`` a torch.profiler
trace of a steady sub-window is read for the device's busy time, the top
device operations and the idle gaps by host span (``devtrace.py``), and the
program's own span recorder (``rtmodt_tpu_torch/profiling/spans.py``) is on
from the warm-up to the window's end: its spans, and the tracker's graph
counters over the window, reach the per-layer readers through
``RunRecord``.  With ``--trace 0`` the recorder stays off."""

from __future__ import annotations

import argparse
import gc
import json
import math
import os
import shutil
import statistics
import sys
import tempfile
import time
from collections import deque
from contextlib import contextmanager

import numpy as np

from perfbench import manifest

FORBIDDEN = ("jax", "jaxlib", "flax", "rtmodt_tpu")


class NoCards(RuntimeError):
    pass


def pick_device(chips: int) -> str:
    """The card the run measures on; raises where CUDA has fewer cards than
    the cell asks for."""
    import torch

    if not torch.cuda.is_available():
        raise NoCards("torch.cuda.is_available() is false: no card to measure on")
    if torch.cuda.device_count() < chips:
        raise NoCards(f"the cell needs {chips} cards, {torch.cuda.device_count()} visible")
    return "cuda"


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


class Spans:
    """Host-clock spans (name, chunk, start, end) of the harness's calls into
    the program's layers."""

    def __init__(self):
        self.items: list[tuple[str, int, float, float]] = []

    @contextmanager
    def __call__(self, name: str, chunk: int):
        t0 = time.perf_counter()
        yield
        self.items.append((name, chunk, t0, time.perf_counter()))


class RunRecord:
    """What the per-layer metric readers read: spans outside the profiled
    interval, frames per chunk, the window and the trace's reduction; with
    ``--trace 1`` also the program's spans outside the profiled interval
    (``program_spans``, else None), its counters over the window
    (``program_counters``), the frames of the traced chunks
    (``traced_frames``), and the cell's configuration and traffic."""

    def __init__(self, spans: list, frames_per_chunk: int, flops_per_frame: float,
                 window: tuple[float, float], emitted: list[float],
                 excluded: tuple[float, float] | None, trace: dict | None,
                 program_spans: list | None = None, program_counters: dict | None = None,
                 traced_frames: int = 0, config: dict | None = None,
                 traffic: dict | None = None):
        self.frames_per_chunk = frames_per_chunk
        self.flops_per_frame = flops_per_frame
        self.trace = trace
        self.program_counters = program_counters
        self.traced_frames = traced_frames
        self.config = config
        self.traffic = traffic
        lo, hi = excluded or (math.inf, -math.inf)
        self.spans = [s for s in spans if not (lo <= s[2] <= hi)]
        self.program_spans = (None if program_spans is None else
                              [p for p in program_spans if not (lo <= p.t0 <= hi)])
        self._split = None
        # frames consumed inside the window, outside the profiled interval,
        # over the window's time outside it
        w0, w1 = window
        self.frames_done = frames_per_chunk * sum(1 for t in emitted
                                                  if w0 <= t <= w1 and not lo <= t <= hi)
        self.window_s = (w1 - w0) - (max(0.0, min(hi, w1) - max(lo, w0)) if excluded else 0.0)

    def frames_per_s(self) -> float:
        return self.frames_done / self.window_s

    def ms_per_frame(self, *names: str) -> float | None:
        """Milliseconds a frame spent in the named spans (summed)."""
        out = 0.0
        for name in names:
            d = [s[3] - s[2] for s in self.spans if s[0] == name]
            if not d:
                return None
            out += 1e3 * sum(d) / (len(d) * self.frames_per_chunk)
        return out

    def program_ms_per_frame(self, name: str) -> float | None:
        """Milliseconds a frame in the program's ``name`` spans, over the
        chunks submitted, each span to the chunk whose harness span holds it
        (``program_spans.split``: ``track`` less its ``sync`` children);
        None where the program recorded no such span."""
        if not self.program_spans or not any(p.name == name for p in self.program_spans):
            return None
        if self._split is None:
            from perfbench import program_spans

            self._split = program_spans.split(self.spans, self.program_spans,
                                              self.frames_per_chunk)
        return self._split.get(f"{name}_ms_per_frame")


def parse_args(argv: list[str]) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="perfbench/run.py", description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True, help="cell name of BENCHMARK.json")
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True, help="length of the measured window")
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def program_config(cell: manifest.Cell, weights: str, tmp: str):
    """The program's ``PipelineConfig`` of the cell's configuration file,
    reading ``weights``."""
    from rtmodt_tpu_torch.config.loader import load_config

    over = json.loads(json.dumps(cell.config["pipeline"]))
    over["detection"]["weights"] = weights
    over.setdefault("events", {}).setdefault("alert", {})["log_path"] = \
        os.path.join(tmp, "events.jsonl")
    over.setdefault("parallel", {}).update(
        num_streams=cell.traffic["streams"], chunk_size=cell.traffic["chunk"],
        pipeline_depth=cell.traffic["depth"])
    return load_config(None, over)


def quantiles(values: list[float]) -> tuple[float, float]:
    """(median, 95th percentile) by the inclusive method."""
    q = statistics.quantiles(values, n=100, method="inclusive")
    return statistics.median(values), q[94]


def run(args: argparse.Namespace, t_start: float, root: str = manifest.ROOT,
        device: str | None = None, hooks: dict | None = None) -> dict:
    """One run; returns the result line's object (``checks`` last).
    ``device`` skips the look for a card (the CPU tests); ``hooks`` lets
    the control and the tests reach the cell as loaded (``cell``), the
    program (``pipeline``), the ``RunRecord`` (``run``), the record compared
    (``record``) and the numbers (``numbers``)."""
    hooks = hooks or {}
    cell = manifest.load_cell(args.workload, root)
    if "cell" in hooks:
        hooks["cell"](cell)
    device = device or pick_device(cell.chips)
    tmp = tempfile.mkdtemp(prefix="perfbench-")
    try:
        return _run(args, t_start, root, device, hooks, cell, tmp)
    finally:
        if args.trace:
            from rtmodt_tpu_torch.profiling import spans

            spans.disable()
        shutil.rmtree(tmp, ignore_errors=True)


def _run(args, t_start, root, device, hooks, cell, tmp) -> dict:
    import torch

    from perfbench import check, devtrace, scenes
    from rtmodt_tpu_torch import _build
    from rtmodt_tpu_torch.events.zone_engine import ZoneEventEngine
    from rtmodt_tpu_torch.ops.yuv import content_dims, pack_chunk
    from rtmodt_tpu_torch.parallel.multistream import MultiStreamPipeline
    from rtmodt_tpu_torch.tracking.bytetrack import TrackOutputs
    from rtmodt_tpu_torch.utils.logging import logger

    tr, conf = cell.traffic, cell.config
    S, T, depth = int(tr["streams"]), int(tr["chunk"]), int(tr["depth"])
    H, W = int(conf["camera"]["height"]), int(conf["camera"]["width"])
    cam_fps = float(conf["camera"]["fps"])
    open_loop = tr["loop"] == "open"
    logger.remove()
    logger.add(os.path.join(tmp, "program.log"), level="INFO")
    logger.add(sys.stderr, level="WARNING")
    arch = manifest.arch_module(conf, root)
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    marks = [("imports", time.perf_counter())]
    weights = conf["weights"]
    if isinstance(weights, dict):
        # the configuration's seed, not the run's: every run loads one model
        weights = arch.seeded_weights(conf, int(weights["seed"]), os.path.join(tmp, "weights"),
                                      device)
        marks.append(("weights", time.perf_counter()))
    else:
        weights = os.path.join(root, weights)
    cfg = program_config(cell, weights, tmp)
    if on_card:
        _build.build_all()
    marks.append(("build", time.perf_counter()))
    rng = np.random.default_rng([int(args.seed) % (1 << 63), 7])
    F = int(tr["pool_frames"])
    if (2 * F) % T:
        raise ValueError(f"2 x pool_frames ({2 * F}) must be a multiple of the chunk ({T})")
    pool = scenes.make_pool(tr["scene"], S, F, H, W, int(tr["objects"]), args.seed)
    marks.append(("frames", time.perf_counter()))
    pipe = MultiStreamPipeline(cfg, num_streams=S, device=device, seed=0)
    marks.append(("pipeline", time.perf_counter()))
    if "pipeline" in hooks:
        hooks["pipeline"](pipe, pool)
    size = cfg.detection.input_size
    ch, cw = content_dims(H, W, size)
    n_slots = pipe.tracker.cfg.max_tracks
    names = pipe.detector.class_names

    def slot():
        def buf(shape, dtype):
            return torch.empty(shape, dtype=dtype, pin_memory=on_card)
        planes = (buf((T, S, ch, cw), torch.uint8), buf((T, S, ch // 2, cw // 2), torch.uint8),
                  buf((T, S, ch // 2, cw // 2), torch.uint8))
        out = TrackOutputs(boxes=buf((T, S, n_slots, 4), torch.float32),
                           track_id=buf((T, S, n_slots), torch.int32),
                           class_id=buf((T, S, n_slots), torch.int32),
                           confidence=buf((T, S, n_slots), torch.float32),
                           age=buf((T, S, n_slots), torch.int32),
                           tsu=buf((T, S, n_slots), torch.int32),
                           visible=buf((T, S, n_slots), torch.bool))
        return planes, tuple(p.numpy() for p in planes), out

    slots = [slot() for _ in range(depth + 1)]
    chk = sorted(int(x) for x in rng.choice(S, size=min(S, int(tr.get("check_streams", 8))),
                                            replace=False))
    spans = Spans()

    class State:
        pass

    st = State()

    def new_engines():
        engines = [ZoneEventEngine.from_config(cfg.events, trail_length=cfg.tracking.trail_length)
                   for _ in range(S)]
        for si, e in enumerate(engines):
            e.extra_metadata = {"stream": si}
        return engines

    def reset(record: bool):
        pipe.reset()
        st.engines = new_engines()
        st.inflight = deque()
        st.record = record
        st.dets, st.tracks, st.events, st.planes = [], [], [], {}
        st.done_frames = 0
        st.emit = []         # (chunk, time its events were emitted)

    def submit(c: int, plane_capture: bool):
        planes_t, planes_np, out = slots[c % len(slots)]
        q = (c * T) % (2 * F)
        frames = pool[q:q + T].reshape(T * S, H, W, 3)      # a view: T x S frames
        with spans("pack", c):
            pack_chunk(frames, size, out=tuple(x.reshape(T * S, *x.shape[2:]) for x in planes_np))
        if plane_capture:
            st.planes[c] = tuple(x[:, chk].copy() for x in planes_np)
        with spans("submit", c):
            outs, res = pipe.submit_chunk_packed(planes_t, H, W)
        with spans("copy", c):
            for dst, src in zip(out, outs):
                dst.copy_(src, non_blocking=on_card)
            ready = None
            if on_card:
                ready = torch.cuda.Event()
                ready.record()
        if st.record:
            st.dets.append(res)
        st.inflight.append((c, out, ready))

    def consume():
        c, out, ready = st.inflight.popleft()
        with spans("wait", c):
            if ready is not None:
                ready.synchronize()
        with spans("events", c):
            host = TrackOutputs(*(x.numpy() for x in out))
            fids = [c * T + t + 1 for t in range(T)]
            ts = np.asarray([(c * T + t) / cam_fps for t in range(T)], np.float64)
            evs = []
            for si in range(S):
                evs.append(st.engines[si].process_chunk(
                    host.track_id[:, si], host.class_id[:, si], host.boxes[:, si],
                    host.visible[:, si], fids, ts, class_names=names))
        if st.record:
            st.tracks.append(tuple(x[:, chk].copy() for x in
                                   (host.boxes, host.track_id, host.class_id, host.visible)))
            for j, si in enumerate(chk):
                for e in evs[si]:
                    st.events.append((j, e.frame_id, e.zone_name, e.event_type, e.track_id,
                                      e.class_id, e.dwell_time_sec))
        st.done_frames += T * S
        st.emit.append((c, time.perf_counter()))
        return c

    recorder = None
    if args.trace:
        from rtmodt_tpu_torch.profiling import spans as recorder

        recorder.drain()
        recorder.enable()
    # counters the recorder keeps itself, where it has them: a recorder with
    # ``drain_counts() -> {name: n}`` hands them over as it hands its spans
    drain_counts = getattr(recorder, "drain_counts", dict)

    def program_counts() -> dict[str, int]:
        t = pipe.tracker
        out = {"graph_captures": t.graph_captures, "graph_replays": t.graph_replays}
        out.update({f"eager_chunks.{k}": v for k, v in t.eager_chunks.items()})
        return out

    # -- warm-up: the cell's one chunk shape, through every layer ------------
    reset(record=False)
    for c in range(2):
        submit(c, False)
        while st.inflight:
            consume()
    if args.trace:
        # the profiler's first start initialises its device tracing (seconds):
        # pay it here, not inside the window
        warm = devtrace.start(on_card)
        submit(2, False)
        while st.inflight:
            consume()
        devtrace.stop(warm, None)
    if on_card:
        torch.cuda.synchronize()
    spans.items.clear()
    if recorder is not None:
        recorder.drain()
        drain_counts()
        counts0 = program_counts()
    reset(record=True)
    plane_chunks = sorted(int(x) for x in rng.choice(np.arange(1, 9), 2, replace=False))
    phases = rng.uniform(0.0, 1.0 / cam_fps, S)
    trace_want = bool(args.trace)
    trace_chunks = int(tr.get("trace_chunks", 6))
    prof = None
    prof_span: tuple[float, float] | None = None
    trace_path = os.path.join(tmp, "trace.json")
    traced: list[int] = []
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    window = float(args.seconds)
    marks.append(("warm-up", t0))
    cpu0 = time.process_time()

    def maybe_profile(c: int, now: float):
        nonlocal prof, prof_span
        if not trace_want or prof_span is not None:
            return
        if prof is None and now >= t0 + 0.4 * window:
            st.prof_t0 = time.perf_counter()
            prof = devtrace.start(on_card)
            traced.append(c)
            st.prof_started = time.perf_counter()
        elif prof is not None:
            traced.append(c)

    def maybe_stop():
        nonlocal prof, prof_span
        if prof is not None and prof_span is None and len(traced) > trace_chunks:
            while st.inflight:
                consume()
            t_stop = time.perf_counter()
            devtrace.stop(prof, trace_path)
            prof_span = (st.prof_t0, time.perf_counter())
            prof = None
            print(f"perfbench: profiler start {st.prof_started - st.prof_t0:.3f} s, "
                  f"{len(traced)} traced chunks {t_stop - st.prof_started:.3f} s, stop and "
                  f"export {prof_span[1] - t_stop:.3f} s", file=sys.stderr)

    def closed_loop():
        """Every frame ready ahead: submit as fast as the program takes
        chunks; the window ends at the first chunk emitted past its length
        (a traced run goes on until its trace is taken)."""
        c, t_end, frames = 0, None, 0
        while t_end is None or (trace_want and prof_span is None):
            maybe_profile(c, time.perf_counter())
            submit(c, c in plane_chunks)
            c += 1
            maybe_stop()
            while len(st.inflight) > depth:
                consume()
                now = time.perf_counter()
                if now >= t0 + window and t_end is None:
                    t_end, frames = now, st.done_frames
        while st.inflight:
            consume()
        return t_end - t0, c * T * S, {"fps": frames / (t_end - t0)}

    def open_loop_run():
        """Frame i of stream s is due at t0 + phase_s + i / fps; chunk c can
        start once its last frame is due.  Each frame's latency runs from
        when it was due to when its chunk's events were emitted."""
        maxph = float(phases.max())
        n_chunks = int(math.floor(((window - maxph) * cam_fps + 1) / T))

        def ready_at(c: int) -> float:
            return t0 + maxph + (c * T + T - 1) / cam_fps

        late = []
        for c in range(n_chunks):
            with spans("due", c):
                while st.inflight and time.perf_counter() < ready_at(c):
                    consume()
                wait = ready_at(c) - time.perf_counter()
                if wait > 0:
                    time.sleep(wait)
            late.append(time.perf_counter() - ready_at(c))
            maybe_profile(c, time.perf_counter())
            submit(c, c in plane_chunks)
            maybe_stop()
            while len(st.inflight) > depth:
                consume()
        while st.inflight:
            consume()
        t_end = time.perf_counter()
        due = t0 + phases[None, :] + np.arange(T)[:, None] / cam_fps   # (T, S) of chunk 0
        latencies = []
        for done_c, te in st.emit:
            latencies.extend((te - (due + done_c * T / cam_fps)).ravel().tolist())
        p50, p95 = quantiles(latencies)
        q = max(1, len(late) // 4)
        print(f"perfbench: {n_chunks} chunks of {T} x {S} frames due; submits ran late by "
              f"median {1e3 * statistics.median(late):.3f} ms, max {1e3 * max(late):.3f} ms; "
              f"first quarter's median {1e3 * statistics.median(late[:q]):.3f} ms, last "
              f"quarter's {1e3 * statistics.median(late[-q:]):.3f} ms", file=sys.stderr)
        return (t_end - t0, n_chunks * T * S,
                {"latency_p95_ms": 1e3 * p95, "latency_p50_ms": 1e3 * p50})

    try:
        window_s, attempted, e2e = (open_loop_run if open_loop else closed_loop)()
    finally:
        if prof is not None:
            prof.stop()
        if recorder is not None:
            recorder.disable()
    program, counts = None, None
    if recorder is not None:
        program = recorder.drain()
        counts = {k: v - counts0.get(k, 0) for k, v in program_counts().items()}
        counts.update(drain_counts())
    cpu = time.process_time() - cpu0
    prev = t_start
    phases = []
    for name, t in marks:
        phases.append(f"{name} {t - prev:.3f}")
        prev = t
    print(f"perfbench: set-up {setup_s:.3f} s: " + ", ".join(phases), file=sys.stderr)
    in_window = [x for x in spans.items if t0 <= x[2] <= t0 + window_s]
    layer_ms = {n: 1e3 * sum(x[3] - x[2] for x in in_window if x[0] == n) / max(1, st.done_frames)
                for n in ("pack", "submit", "copy", "wait", "events", "due")}
    print(f"perfbench: window {window_s:.3f} s; ms a frame by span "
          + ", ".join(f"{k} {v:.4f}" for k, v in layer_ms.items())
          + f"; process CPU {cpu / window_s:.2f} cores", file=sys.stderr)
    e2e["setup_s"] = setup_s
    if on_card:
        torch.cuda.synchronize()
        mem_peak = int(torch.cuda.max_memory_allocated())
        kind = torch.cuda.get_device_name(0)
    else:
        mem_peak, kind = 0, "cpu"

    # -- the trace's reduction --------------------------------------------
    trace = None
    if trace_want:
        if prof_span is None:
            raise RuntimeError("the window ended before the traced sub-window; lengthen --seconds")
        lo, hi = prof_span
        trace = devtrace.reduce(trace_path, [(n, a, b) for n, _, a, b in spans.items
                                             if lo <= a and b <= hi], devtrace.unix_offset(),
                                program=program)
        print(f"perfbench: trace holds {trace['k1_launches']} K1 launches for the "
              f"{len(traced)} chunks it covered ({trace['kernels']} kernels in all); program "
              f"counters over the window {json.dumps(counts, sort_keys=True)}; "
              f"{len(program)} program spans", file=sys.stderr)

    # -- what the timed path produced, to host; free the program -----------
    rec = {"streams": chk, "chunk": T, "camera_fps": cam_fps, "planes": st.planes,
           "events": st.events}
    n_rec = len(st.tracks)
    rec["dets"] = {k: np.stack([getattr(r, k)[:, chk].cpu().numpy() for r in st.dets[:n_rec]])
                   for k in ("boxes", "scores", "classes", "valid")}
    rec["tracks"] = {k: np.stack([x[i] for x in st.tracks])
                     for i, k in enumerate(("boxes", "track_id", "class_id", "visible"))}
    rr = RunRecord(spans.items, T * S, arch.forward_flops(conf), (t0, t0 + window_s),
                   [t for _, t in st.emit], prof_span, trace, program_spans=program,
                   program_counters=counts, traced_frames=len(traced) * T * S, config=conf,
                   traffic=tr)
    if "run" in hooks:
        hooks["run"](rr)
    del pipe, slots, st.dets, st.engines, st.inflight
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    if "record" in hooks:
        hooks["record"](rec, conf)
    numbers = check.run_check(rec, pool[:F], conf, dev, arch, weights)
    if "numbers" in hooks:
        hooks["numbers"](numbers)
    check_s = time.perf_counter() - t_check

    # -- the result line ----------------------------------------------------
    compared = check.order(arch)
    limits = {k: float(cell.limits[k]) for k in compared}
    checks = {k: {"value": numbers[k], "limit": limits[k]} for k in compared}
    correct = all(numbers[k] <= limits[k] for k in compared)
    if args.trace:
        metrics = {}
        for m in cell.per_layer:
            v = manifest.metric_reader(m["name"], root)(rr)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        metrics = {e["name"]: {"value": e2e[e["name"]], "unit": e["unit"]}
                   for e in cell.end_to_end}
    dev_info = {"platform": "gpu" if on_card else "cpu", "kind": kind, "count": cell.chips,
                "memory_peak_bytes": mem_peak}
    if trace is not None:
        dev_info["busy_s"] = trace["busy_s"]
        dev_info["window_s"] = trace["window_s"]
    result = {"correct": correct, "attempted": attempted, "failed": 0, "metrics": metrics,
              "device": dev_info}
    if trace is not None:
        result["breakdown"] = {"device_ops": trace["device_ops"], "idle_gaps": trace["idle_gaps"]}
    result["checks"] = checks
    print(f"perfbench: {cell.name} seed {args.seed}: {st.done_frames} frames consumed, "
          f"window {window_s:.3f} s, check {check_s:.1f} s over streams {chk}, "
          f"{int(numbers['_events'])} program events compared", file=sys.stderr)
    return result


def main(argv: list[str], t_start: float, root: str = manifest.ROOT) -> int:
    args = parse_args(argv)
    try:
        result = run(args, t_start, root)
    except NoCards as e:
        print(f"perfbench: {e}", file=sys.stderr)
        return 2
    bad = forbidden_modules()
    if bad:
        print(f"perfbench: the run loaded {', '.join(bad)}; nothing it runs may import JAX "
              "or the JAX package", file=sys.stderr)
        return 3
    for k, v in result["checks"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0
