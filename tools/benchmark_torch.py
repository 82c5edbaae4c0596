#!/usr/bin/env python
"""Benchmark harness of the port: per-stage latency and throughput tables.

The port's counterpart of ``tools/benchmark.py``, with its flags (argparse),
``--device`` (the card by default) and ``--weights`` / ``--num-classes``
(default: random 80-class weights, as the reference runs).  Over the
synthetic scene generator (no dataset needed) it prints the stage mean /
p95 / p99 table and the fps, and writes the same summary keys to
``--json-out``:

  * ``per_stage``: ``Pipeline.step`` with ``profiling.per_stage: true``, the
    renderer on (letterbox, forward, NMS and tracker timed apart, each ended
    by a sync of the card);
  * ``fused``: the per-frame program with ``per_stage: false`` (``step``
    times detect + track as one ``inference`` stage), the renderer on;
  * ``chunked``: the packed chunk program ``submit_packed_yuv`` over
    ``--chunk``-frame chunks, each one's outputs fetched before the next.

    python tools/benchmark_torch.py [--mode per_stage|fused|chunked] [--frames 200]
        [--chunk 16] [--json-out summary.json] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def run(model: str = "yolov8s", imgsz: int = 640, height: int = 720, width: int = 1280,
        frames: int = 200, mode: str = "per_stage", chunk: int = 16,
        device: str = "cuda", weights: str | None = None, num_classes: int = 80) -> dict:
    """The benchmark's summary: the profiler's (per_stage, fused) or
    ``{fps_mean, mode, chunk}`` (chunked)."""
    from rtmodt_tpu_torch.config import load_config
    from rtmodt_tpu_torch.runtime.pipeline import Pipeline
    from rtmodt_tpu_torch.utils.synthetic import moving_boxes_frame

    cfg = load_config(overrides={
        "detection": {"model": model, "input_size": imgsz, "weights": weights,
                      "num_classes": num_classes},
        "profiling": {"per_stage": mode == "per_stage", "warmup_frames": 10,
                      "log_interval": 0},
        "visualization": {"enabled": True},
    })
    pipe = Pipeline(cfg, device=device)
    scene = [moving_boxes_frame(t, height, width, 8)[0] for t in range(64)]

    if mode == "chunked":
        from rtmodt_tpu_torch.ops.yuv import pack_i420_planar

        planes = [pack_i420_planar(f, imgsz)[0] for f in scene[:chunk]]
        yuv = tuple(np.stack([p[i] for p in planes]) for i in range(3))
        pipe.submit_packed_yuv(yuv, height, width)  # warm-up: cuDNN plans, allocator
        t0 = time.perf_counter()
        done = 0
        it = 0
        while done < frames:
            # a different payload each dispatch, as the reference sends
            y = yuv[0].copy()
            y[:, :2, :4] = it & 0xFF
            it += 1
            outs, _ = pipe.submit_packed_yuv((y, yuv[1], yuv[2]), height, width)
            outs.visible.cpu()
            done += chunk
        dt = time.perf_counter() - t0
        return {"fps_mean": done / dt, "mode": "chunked", "chunk": chunk}
    pipe.warmup((height, width))
    zones = pipe.events.get_zone_polygons() if pipe.events else []
    for i in range(frames):
        frame = scene[i % len(scene)].copy()
        tracks, events, _ = pipe.step(frame, i, i / 30.0)
        if pipe.renderer:
            pipe.profiler.tick("visualization")
            pipe.renderer.render(frame, tracks, zones)
            pipe.profiler.tock("visualization")
        pipe.profiler.end_frame()
    summary = pipe.profiler.summary()
    pipe.profiler.print_summary()
    return summary


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="yolov8s")
    ap.add_argument("--imgsz", type=int, default=640)
    ap.add_argument("--height", type=int, default=720)
    ap.add_argument("--width", type=int, default=1280)
    ap.add_argument("--frames", type=int, default=200)
    ap.add_argument("--mode", choices=["per_stage", "fused", "chunked"], default="per_stage")
    ap.add_argument("--chunk", type=int, default=16)
    ap.add_argument("--json-out", default=None)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--weights", default=None, help="detection.weights (.npz or .pt)")
    ap.add_argument("--num-classes", type=int, default=80)
    args = ap.parse_args(argv)
    summary = run(args.model, args.imgsz, args.height, args.width, args.frames, args.mode,
                  args.chunk, args.device, args.weights, args.num_classes)
    print(json.dumps({k: round(v, 2) for k, v in summary.items()
                      if isinstance(v, (int, float))}, indent=2))
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(summary, f, indent=2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
