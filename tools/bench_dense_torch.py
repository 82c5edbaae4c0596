#!/usr/bin/env python
"""Dense-scene cost scaling of the port: ms/frame against object count.

The port's counterpart of ``tools/bench_dense.py``, with its flags, config
overrides and ``rows`` keys, plus ``--device`` (the card by default).  The
chunk program's cost grows with content in two places: the NMS (K1 works on
the valid candidates) and the tracker's mutual-best assignment rounds
(``ops/assignment.py``: on the card one kernel, on the CPU a host read a
round).  For each density of
``dense_moving_scene`` it reports:

  * amortized wall ms/frame of ``submit_packed_yuv`` over chunks with
    continuous motion (time advances across every dispatch, so tracker
    occupancy is the steady state);
  * mean detections a frame and live tracks at the end of the run;
  * on the last two frames: NMS rounds to convergence, candidate-pool use
    against ``nms_candidates`` and survivors (``ops/nms.py::
    nms_debug_from_logits``), and the mutual-best rounds
    (``ops/assignment.py::greedy_assign_rounds``) on the IoU matrix between
    the two frames' detections, the shape of the tracker's first
    association stage;
  * with ``--trace``, device ms/frame from a torch.profiler trace of the
    same chunks (``profiling/trace_summary.py::device_total_ms``).

    python tools/bench_dense_torch.py --weights checkpoints/rich640d/ema_final.npz \\
        --model yolov8s --num-classes 8 --input-size 640 --densities 8,64 [--trace] \\
        [--json out.json] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

TRACE_ROOT = os.path.join(ROOT, "build", "traces")


def dense_config(weights: str | None, model: str, num_classes: int, input_size: int,
                 conf: float):
    from rtmodt_tpu_torch.config import load_config

    return load_config(overrides={
        "detection": {"model": model, "weights": weights, "num_classes": num_classes,
                      "input_size": input_size, "conf_threshold": conf, "classes": None,
                      "max_detections": 256, "nms_candidates": 512},
        # thresholds matched to dense-scene statistics: tiny crowded shapes
        # score 0.3-0.6, so the default track_thresh 0.5 would suppress most
        # births; the iou_distance gate tolerates the fast relative motion of
        # small objects (the reference tool's settings)
        "tracking": {"bytetrack": {"max_tracks": 256, "track_thresh": 0.3,
                                   "new_track_thresh": 0.3, "match_thresh": 0.7,
                                   "match_metric": "iou_distance"}},
        "profiling": {"per_stage": False, "warmup_frames": 0, "log_interval": 0},
        "visualization": {"enabled": False},
        "events": {"enabled": False},
    })


def debug_counts(det, frame_prev: np.ndarray, frame_cur: np.ndarray
                 ) -> tuple[int, int, int, int]:
    """(NMS rounds, pool used, kept, assignment rounds) of ``frame_cur``
    and the IoU matrix between the two frames' detections, through the
    detector's BGR letterbox and forward."""
    import torch

    from rtmodt_tpu_torch.ops.assignment import greedy_assign_rounds
    from rtmodt_tpu_torch.ops.iou import pairwise_iou
    from rtmodt_tpu_torch.ops.nms import batched_nms_from_logits, nms_debug_from_logits

    d = det.cfg
    outs = []
    with torch.no_grad():
        for f in (frame_prev, frame_cur):
            bd, cl = det.forward(det.preprocess(torch.from_numpy(f).to(det.device)))
            rounds, pool, kept = nms_debug_from_logits(
                bd[0], cl[0], d.input_size, d.conf_threshold, d.iou_threshold,
                num_candidates=d.nms_candidates, class_mask=det._class_mask,
                agnostic=d.agnostic_nms)
            res = batched_nms_from_logits(
                bd, cl, d.input_size, d.conf_threshold, d.iou_threshold, d.max_detections,
                d.nms_candidates, det._class_mask, d.agnostic_nms)
            outs.append((rounds, pool, kept, [t[0] for t in res]))
        (_, _, _, res_p), (rounds, pool, kept, res_c) = outs
        # the tracker's stage-1 association matrix: the previous frame's
        # detections (as the track slots they become) x the current ones
        sim = pairwise_iou(res_p[0], res_c[0])
        a_rounds = greedy_assign_rounds(sim, 0.2, row_valid=res_p[3], col_valid=res_c[3])
    return int(rounds), int(pool), int(kept), int(a_rounds)


def run(weights: str | None = None, model: str = "yolov8n", num_classes: int = 8,
        input_size: int = 416, conf: float = 0.25, densities: str = "8,32,64,128",
        chunk: int = 16, reps: int = 8, height: int = 480, width: int = 640,
        trace: bool = False, device: str = "cuda", trace_root: str = TRACE_ROOT
        ) -> list[dict]:
    import torch

    from rtmodt_tpu_torch.ops.yuv import pack_chunk
    from rtmodt_tpu_torch.profiling.trace_summary import (device_total_ms, start_trace,
                                                          stop_trace)
    from rtmodt_tpu_torch.runtime.pipeline import Pipeline
    from rtmodt_tpu_torch.utils.synthetic import dense_moving_scene

    cfg = dense_config(weights, model, num_classes, input_size, conf)
    pipe = Pipeline(cfg, device=device)
    det = pipe.detector
    h, w, k = height, width, chunk
    n_warm = 2 + max(2, reps // 2)   # warm-up + ramp + tracker fill

    def sync() -> None:
        if pipe.device.type == "cuda":
            torch.cuda.synchronize(pipe.device)

    rows = []
    for dens in [int(x) for x in densities.split(",")]:
        # continuous motion across every dispatch; the host draws the
        # frames on a few threads (set-up, outside every timed region)
        n_total = n_warm + reps
        with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as ex:
            drawn = list(ex.map(lambda i: dense_moving_scene(
                i, h, w, n_objects=dens, seed=1234 + dens)[0], range(n_total * k)))
        raw = [np.stack(drawn[c * k:(c + 1) * k]) for c in range(n_total)]
        chunks = [pack_chunk(f, cfg.detection.input_size)[0] for f in raw]

        pipe.tracker.reset()
        for c in range(n_warm):
            outs, _ = pipe.submit_packed_yuv(chunks[c], h, w)
        sync()

        t0 = time.perf_counter()
        counts = []
        for c in range(n_warm, n_total):
            outs, res = pipe.submit_packed_yuv(chunks[c], h, w)
            counts.append(res.count)
        visible = outs.visible.cpu()             # sync once at the end
        wall = (time.perf_counter() - t0) / (reps * k)

        n_det = float(torch.cat([c.cpu().reshape(-1) for c in counts]).float().mean())
        occupancy = int(visible[-1].sum())

        dev_ms = None
        if trace:
            tdir = os.path.join(trace_root, f"dense_{dens}")
            prof = start_trace(tdir, pipe.device)
            for c in range(n_warm, n_total):
                outs, _ = pipe.submit_packed_yuv(chunks[c], h, w)
            outs.visible.cpu()
            sync()
            stop_trace(prof)
            dev_ms = device_total_ms(tdir, pipe.device) / (reps * k)

        rounds, pool, kept, a_rounds = debug_counts(det, raw[-1][-2], raw[-1][-1])
        rows.append({"objects": dens, "ms_per_frame": wall * 1e3,
                     "device_ms_per_frame": dev_ms,
                     "mean_detections": n_det, "live_tracks": occupancy,
                     "nms_rounds": rounds, "nms_pool_used": pool,
                     "nms_kept": kept, "assign_rounds": a_rounds})
        dev_s = f"  device={dev_ms:6.3f} ms/f" if dev_ms is not None else ""
        print(f"objects={dens:4d}  {wall * 1e3:7.3f} ms/frame{dev_s}  "
              f"det/frame={n_det:6.1f}  live_tracks={occupancy:4d}  "
              f"nms_rounds={rounds}  pool={pool}/{cfg.detection.nms_candidates}  "
              f"kept={kept}  assign_rounds={a_rounds}", flush=True)
    return rows


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--weights", default=None)
    ap.add_argument("--model", default="yolov8n")
    ap.add_argument("--num-classes", type=int, default=8)
    ap.add_argument("--input-size", type=int, default=416)
    ap.add_argument("--conf", type=float, default=0.25)
    ap.add_argument("--densities", default="8,32,64,128")
    ap.add_argument("--chunk", type=int, default=16)
    ap.add_argument("--reps", type=int, default=8)
    ap.add_argument("--height", type=int, default=480)
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--json", default=None)
    ap.add_argument("--trace", action="store_true",
                    help="also capture a torch.profiler trace per density and report "
                         "device ms/frame (the card's time, free of host noise)")
    ap.add_argument("--trace-dir", default=TRACE_ROOT,
                    help="traces go to <dir>/dense_<objects>")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    rows = run(args.weights, args.model, args.num_classes, args.input_size, args.conf,
               args.densities, args.chunk, args.reps, args.height, args.width, args.trace,
               args.device, args.trace_dir)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
