#!/usr/bin/env python
"""Live-mode per-frame latency of the port: p50/p95/p99 and a floor decomposition.

The port's counterpart of ``tools/bench_latency.py``, with its report keys.
On a card attached to its own host the "relay" of the reference's report is
the PCIe copy plus a sync, so the floor it measures is:

  rpc_round_trip   - a tiny tensor to the card and back (``.to`` + ``.cpu``)
  put_frame        - one packed I420 720p frame (its three planes) uploaded,
                     then a sync
  device_compute   - the amortized chunk-program time per frame of
                     ``submit_packed_yuv`` over 16 frames

then the real per-frame loop (``submit_packed_frame``) with 0, 1 and 2
frames in flight, reporting mean / p50 / p95 / p99 of submit -> consume
latency (the first 20 frames of each dropped).  ``relay_floor_ms_est`` is
(rpc_round_trip x 2 + put_frame - rpc_round_trip + device_compute) and
``framework_overhead_ms_est`` is what depth 1's p50 takes beyond it.

    python tools/bench_latency_torch.py [--frames 300] [--json out.json] [--device cuda|cpu]

``--model``, ``--imgsz``, ``--height`` and ``--width`` (default YOLOv8s at 640
on 720p frames, the reference's fixed setting) size the run; ``--weights`` /
``--num-classes`` (default: random 80-class weights, as the reference runs)
choose its weights.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

DROP = 20   # frames of each live loop left out of its percentiles (warm tail-in)


def pct(xs, q):
    return float(np.percentile(np.asarray(xs), q))


def run(frames_n: int = 300, device: str = "cuda", model: str = "yolov8s", imgsz: int = 640,
        height: int = 720, width: int = 1280, weights: str | None = None,
        num_classes: int = 80) -> dict:
    import torch

    from rtmodt_tpu_torch.config import load_config
    from rtmodt_tpu_torch.ops.yuv import pack_chunk
    from rtmodt_tpu_torch.runtime.pipeline import Pipeline
    from rtmodt_tpu_torch.utils.synthetic import moving_boxes_frame

    cfg = load_config(overrides={
        "detection": {"model": model, "input_size": imgsz, "weights": weights,
                      "num_classes": num_classes},
        "profiling": {"per_stage": False, "warmup_frames": 10, "log_interval": 0},
        "visualization": {"enabled": False},
        "events": {"enabled": True},
    })
    pipe = Pipeline(cfg, device=device)
    dev = pipe.device
    h, w = height, width
    frames = [moving_boxes_frame(t, h, w, n_objects=8)[0] for t in range(32)]
    names = pipe.detector.class_names

    def sync() -> None:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    report: dict = {}

    # --- floor components -------------------------------------------------
    print("measuring the transfer floor...", file=sys.stderr)
    pipe.warmup((h, w), iters=2)

    tiny = torch.zeros((8,), dtype=torch.float32)
    ts = []
    for _ in range(20):
        t0 = time.perf_counter()
        tiny.to(dev).cpu()                       # to the card and back
        ts.append((time.perf_counter() - t0) * 1e3)
    report["rpc_round_trip_ms"] = {"p50": pct(ts, 50), "p95": pct(ts, 95)}

    ts = []
    for i in range(20):
        planes, _ = pack_chunk(frames[i % len(frames)][None], cfg.detection.input_size)
        planes[0][0, :2, :4] = i                 # a different payload each time
        t0 = time.perf_counter()
        bufs = [torch.from_numpy(p).to(dev) for p in planes]
        sync()
        ts.append((time.perf_counter() - t0) * 1e3)
    del bufs
    report["put_frame_ms"] = {"p50": pct(ts, 50), "p95": pct(ts, 95)}

    # amortized device compute from the chunk program
    k = 16
    planes = pack_chunk(np.stack(frames[:k]), cfg.detection.input_size)[0]
    pipe.submit_packed_yuv(planes, h, w)         # warm-up at B = k
    outs, _ = pipe.submit_packed_yuv(planes, h, w)
    outs.visible.cpu()
    t0 = time.perf_counter()
    reps = 4
    for _ in range(reps):
        outs, _ = pipe.submit_packed_yuv(planes, h, w)
    outs.visible.cpu()
    chunk_wall = (time.perf_counter() - t0) / reps
    report["device_compute_ms_per_frame_amortized"] = chunk_wall * 1e3 / k

    # --- the per-frame live loop at several depths -------------------------
    for depth in (0, 1, 2):
        lats: list[float] = []
        inflight: list = []

        def consume(entry):
            t_sub, outputs = entry
            tracks = pipe.tracker.tracks_from_outputs(outputs, names)
            if pipe.events:
                pipe.events.process(tracks, 0, None)
            lats.append((time.perf_counter() - t_sub) * 1e3)

        for i in range(frames_n):
            f = frames[i % len(frames)].copy()
            f[:2, :4, 0] = i & 0xFF
            t_sub = time.perf_counter()
            outputs, _res = pipe.submit_packed_frame(f)
            inflight.append((t_sub, outputs))
            if len(inflight) > depth:
                consume(inflight.pop(0))
        while inflight:
            consume(inflight.pop(0))
        lats = lats[DROP:]
        report[f"live_depth{depth}_ms"] = {
            "mean": float(np.mean(lats)), "p50": pct(lats, 50),
            "p95": pct(lats, 95), "p99": pct(lats, 99)}
        print(f"depth {depth}: mean {np.mean(lats):.1f} p50 {pct(lats, 50):.1f} "
              f"p95 {pct(lats, 95):.1f} p99 {pct(lats, 99):.1f} ms", file=sys.stderr)

    floor = (2 * report["rpc_round_trip_ms"]["p50"]
             + report["put_frame_ms"]["p50"]
             - report["rpc_round_trip_ms"]["p50"]  # put includes one round trip
             + report["device_compute_ms_per_frame_amortized"])
    report["relay_floor_ms_est"] = floor
    report["framework_overhead_ms_est"] = report["live_depth1_ms"]["p50"] - floor
    return report


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=300)
    ap.add_argument("--json", default=None)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--model", default="yolov8s")
    ap.add_argument("--imgsz", type=int, default=640)
    ap.add_argument("--height", type=int, default=720)
    ap.add_argument("--width", type=int, default=1280)
    ap.add_argument("--weights", default=None, help="detection.weights (.npz or .pt)")
    ap.add_argument("--num-classes", type=int, default=80)
    args = ap.parse_args(argv)
    if args.frames <= DROP:
        ap.error(f"--frames must exceed the {DROP} warm frames each loop drops")
    report = run(args.frames, args.device, args.model, args.imgsz, args.height, args.width,
                 args.weights, args.num_classes)
    print(json.dumps(report, indent=1))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
