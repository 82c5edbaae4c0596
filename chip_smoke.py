#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``rtmodt_tpu_torch``) on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

Phases (each prints one line when it starts; any failure exits non-zero):
  1. the card's name and power limit (nvidia-smi);
  2. build every native source of the port (the CUDA kernels with plain
     nvcc, the host LAPJV solver with g++; loaded with ctypes);
  3. the greedy-NMS kernel against its plain PyTorch version at the main
     path's shapes (16 frames x 300 candidates): random, tied, zero-score,
     class-offset, scattered zero scores, identical boxes, no and one valid
     candidate, zero-width and inverted boxes; then the kernel's edges (K
     from 1 to 1024, 1 and 64 frames, thresholds -0.1, 0 and 0.9999); keep
     masks must be equal bit for bit;
  4. the rich640d YOLOv8s weights through ``params_from_jax``; the bf16
     channels_last forward against a float32 forward with TF32 off;
  5. the slice: 720p frames drawn in numpy -> ``pack_chunk`` ->
     ``Pipeline.run_chunked`` (chunks of 16, 8 chunks, zone events on), with
     the kernel's launch count read around that run; then timings with CUDA
     events (chunk program, stages, tracker), the chunk program's device time
     from a profiler trace, and the NMS kernel's own duration in that trace
     against its plain version and its bound, also on inputs that change
     one part of its work (no valid, all valid, one frame, K = 1024), and
     the NMS stage's device time split into decode and suppress-and-pack;
  6. the live per-frame paths: ``Pipeline.run`` on a 25-fps 720p file (a)
     per stage, with the renderer and the annotated video saved, and (b) on
     the packed per-frame path with 2 frames in flight: K1's launches, the
     profiler's summary as one JSON line, track stability, zone events, the
     saved video's frame count; K1 at B = 1 on both paths' real inputs
     against its plain version, and its time and bound there; (c) the CLI
     ``tools/run_pipeline_torch.py`` as a subprocess on a 25-fps file with
     botsort and GMC, whose events must carry 25-fps stream time; (d) IDF1 /
     MOTA / ID switches of the per-stage path on the dense 64-object scene,
     seed 5;
  7. the other trackers and camera-motion compensation, with the shipped
     ``checkpoints/embedder.npz``: (a) ``run_chunked`` with deepsort + GMC
     (the appearance chunk program; its device time and idle share, what the
     ROI crops, the embedder and GMC cost per frame), (b) ``Pipeline.run``
     per stage with botsort + GMC, (c) packed per frame with ocsort + GMC,
     (d) per stage with ByteTrack on host LAPJV; K1's launches and K1 bit
     for bit against its plain version on each of these paths' inputs;
     (e) ``tools/compare_trackers_torch.py``'s four oracle-detection
     scenarios, one row per tracker (every "+ GMC" shake row must reach
     IDF1 0.99); (f) the dense scene of 6 (d) with deepsort and botsort;
  8. several streams: (a) the native frame packer against its numpy plain
     versions, byte for byte, on a 720p chunk (2x) and a 1080p chunk (3x),
     with its ms/frame and numpy's on the card's host; (b)
     ``MultiStreamPipeline.run`` on four 25-fps 720p files of phase-shifted
     scenes (T = 8, 64 frames a stream, ByteTrack, zone events): the
     summary, K1 once per chunk (B = 32) and bit-equal to its plain version
     on a chunk's candidates; (c) each stream of ``submit_chunk_packed``
     against the single-stream ``submit_packed_yuv`` on its frames, float32
     with TF32 off (and the bf16 gap); (d) the chunk program's device time
     per frame slot, its idle share, K1's own time at B = 32 and its bound;
     (e) deepsort + GMC on two streams (T = 4, four chunks); (f) a degraded
     run whose short stream must be named in ``dead_streams``;
  9. serving: (a) the port's web app (``serving/server.py``) on a real
     socket with rich640d injected through ``_singleton.set``: health,
     samples, the sample gallery, an upload, 16-frame webcam sessions
     (ByteTrack with a zone, deepsort), ``/api/track/video`` (ByteTrack and
     botsort, zones), ``/api/stream/demo`` and ``/api/stream/video``, with
     K1 once per served frame; (b) the default detector build
     (``RTMODT_WEIGHTS`` unset) on the card; (c) K1 bit for bit on a served
     frame's candidates, and its time; (d) 8 client threads x 8 uploads
     against the sequential responses; (e) request times (host clock); (f)
     the MJPEG monitor behind ``Pipeline.run``, ``MultiStreamPipeline.run``
     (the mosaic) and the CLI's ``--mjpeg-port``, read by a viewer thread;
     (g) ``tools/run_inference_torch.py`` ``detect --evaluate`` (mAP) and
     ``track --gt-mot`` on the dense scene of 6 (d), without and with
     ``--interpolate 20``;
 10. kill-and-resume, device zone masks and the transports, on 25-fps 720p
     files with zones on: (a) ``run_chunked`` (K = 16, 128 frames, a
     snapshot every 32) against half of it, a snapshot and a fresh
     ``Pipeline`` that resumes: equal event logs and zone counts, the
     snapshot's bytes, save and load ms, K1 bit for bit on the first resumed
     chunk's candidates; (b) the same on the per-stage path; (c) the CLI with
     ``--resume-state`` killed by SIGKILL after its first snapshot and
     started again, its log cut at the snapshot's ``log_offset``: the events
     of the uninterrupted CLI, and the seconds from the restart to the first
     resumed frame; (d) ``MultiStreamPipeline.run`` at S = 4, T = 8, half
     then resume, each stream's events equal, ``per_stream_frames`` [64] * 4;
     (e) ``events.device_masks`` on ``run_chunked``: the host-mask run's
     events, masks equal to ``points_in_polygons`` on the CPU, the mask
     step's ms per chunk; (f) planes, x6 and x24 through
     ``submit_packed_yuv`` (and planes, x6 through ``submit_chunk_packed``)
     give bit-equal tracks; ``transport: bgr`` through ``run_chunked``;
 11. int8 and the rest of this slice: (a) ``run_chunked`` with
     ``detection.quant: int8`` (synthetic calibration, bf16 float layers) on
     phase 5's frames: K1 once per chunk and the int8 GEMM once per quantized
     layer and chunk, K1 bit for bit against its plain version on every
     chunk, the forward's and the chunk program's ms/frame (CUDA events,
     profiler device time), idle share and e2e fps beside phase 5's bf16;
     (b) ``torch._int_mm`` against its int64 plain version on every
     quantized layer of one chunk (0 mismatches), its time and bound on the
     largest layer beside cuDNN's bf16 conv of it; (c) the frozen QAT scales
     ``qat_act_scales.npz`` on ``ema_final.npz``, ``Pipeline.run`` per stage
     on the 25-fps file; (d) int8 on ``MultiStreamPipeline.run`` at S = 2, T
     = 8; (e) ``Pipeline.run`` with ``transport: bgr`` at depth 0 and 2: the
     BGR program, never the packed one; (f) ``events.alert.backend: mqtt``
     against a broker thread on localhost: one PUBLISH per JSONL line, the
     payloads equal; (g) rich640d as ultralytics-named ``.pt`` (tensors, and a
     pickled model of unimportable classes): detections bit-equal to the
     ``.npz`` route; (h) ``run_inference_torch detect --quant int8``: mAP@0.5
     beside phase 9's bf16.
The line before the last is the kernel table as JSON; the last line is
``{"ok": true, "device": {...}}``.  Where CUDA is not available it exits
non-zero and prints no result.  It imports torch, numpy, the standard
library and ``rtmodt_tpu_torch`` only.
"""

from __future__ import annotations

import base64
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
WEIGHTS = os.path.join(ROOT, "checkpoints", "rich640d", "ema_final.npz")
OUT_DIR = os.path.join(ROOT, "build", "smoke")

DEVICE = "cuda"
SIZE = 640             # model input (YOLOv8s at its published 640)
K = 16                 # frames per chunk
N_CHUNKS = 8           # chunks in the counted main-path run
N_OBJECTS = 8
H, W = 720, 1280
CANDIDATES = 300
F32_PEAK = 67e12       # H100 SXM float32 outside the tensor cores, FLOP/s
HBM_RATE = 3.35e12     # H100 SXM HBM3, bytes/s
# phase 6: the live per-frame paths
LIVE_FPS = 25.0        # a file rate other than the 30 a naive stamp assumes
N_LIVE = 96            # counted frames of each live run
LIVE_WARMUP = 8        # profiling.warmup_frames of the live runs (reference: 50)
WARMUP_ITERS = 3       # Pipeline.warmup's iterations: one K1 launch each
CLI_FRAMES = 48
CLI_DWELL = 0.3        # 8 frames at 25 fps (0.32 s); 9 at 30 fps would read 0.3
DENSE_OBJECTS, DENSE_FRAMES, DENSE_SEED = 64, 96, 5
IDF1_FLOOR = 0.75      # the reference recorded 0.803 on this seed (docs/RESULTS.md)
# phase 7: the other trackers and camera-motion compensation
EMBEDDER = os.path.join(ROOT, "checkpoints", "embedder.npz")
N_LAPJV = 32           # counted frames of the short host-LAPJV run
COMPARE = {"bounce": 60, "stopgo": 60, "shake": 60, "dense": 60}   # frames per scenario
GMC_SHAKE_IDF1 = 0.99  # every "+ GMC" row of the shake scenario (reference 0.997)
# docs/RESULTS.md, dense seed 5 at 64 objects, full detection
DENSE_REF = {"deepsort": (0.793, 46), "botsort": (0.807, 58)}
# phase 8: several streams (bench.py's multi mode: S = 4 streams at T = 8)
S_STREAMS = 4
T_MULTI = 8
N_MULTI = 64           # frames per stream of the counted multi-stream run
MULTI_DEPTH = 3        # bench.py's pipeline_depth in multi mode
PACK_FRAMES = 32       # 720p frames of the packer check (1080p: half as many)
H2, W2 = 1080, 1920    # the 3x geometry of the packer check
DS_STREAMS, DS_T, DS_CHUNKS = 2, 4, 4   # deepsort + GMC
INDEP_CHUNKS = 2       # chunks of T_MULTI of the float32 independence check
INDEP_BOX_TOL = 1e-3   # px, float32 with TF32 off on both sides
# bf16 vs float32 BGR letterbox: both cast before the resize; bf16 keeps 8
# bits of mantissa on 0-255 values, so a pixel may move by a few 8-bit levels
LETTERBOX_BF16_TOL = 0.02
# bf16 vs float32 forward: bf16 keeps 8 mantissa bits, and the rounding
# compounds through ~70 layers; a mapping or layout fault is O(1) of the
# logit range, an arithmetic-precision gap a few percent of it.
MODEL_REL_TOL = 0.05
# phase 10: kill-and-resume, device zone masks, the x6 / x24 / bgr transports
RESUME_FRAMES = 128     # the chunked file (25 fps, 720p); resumed at half
RESUME_INTERVAL = 32    # state_interval of the chunked runs
RESUME_LIVE_FRAMES = 64     # the per-stage runs, resumed at half
RESUME_LIVE_INTERVAL = 16
CLI_KILL_FRAMES = 320   # the CLI's file: long enough to be killed mid-run
CLI_KILL_INTERVAL = 16
RESUME_BOX_TOL = 1e-3   # px, event boxes of a resumed run against the uninterrupted one
# phase 9: serving
SERVE_FRAMES = 16      # /api/detect/frame requests of each webcam session
SERVE_CLIP = 48        # frames of the 25-fps 720p clip (track/video, the monitor, the CLI)
STREAM_SECONDS, STREAM_FPS = 2.0, 30.0   # /api/stream/demo: 60 parts
STREAM_VIDEO_FRAMES = 24
CONC_THREADS, CONC_REQUESTS = 8, 8
# concurrent vs sequential /api/detect/image boxes: every request runs the
# same kernels on the same stream, so they should agree bit for bit
CONC_BOX_TOL = 1e-3    # px
MONITOR_PARTS = 3      # distinct /stream parts a viewer must receive
RI_IMAGES, RI_OBJECTS = 8, 16   # run_inference_torch detect: frames, objects a frame
# phase 11: int8, frozen QAT scales, the per-frame bgr path, mqtt, .pt weights
QAT_SCALES = os.path.join(ROOT, "checkpoints", "rich640d", "qat_act_scales.npz")
INT8_LAYERS = 56       # YOLOv8s's fused ConvBNs less the stem, quantized
INT8_PEAK = 1979e12    # H100 SXM dense int8, operations/s
BF16_PEAK = 989e12     # H100 SXM dense bf16, FLOP/s
BGR_FRAMES = 48        # frames of the 25-fps file through each per-frame bgr run
PT_FRAMES = 4          # phase-5 frames detected through the .pt and .npz routes


def phase(msg: str) -> None:
    print(f"[phase] {msg}", flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()
    return out[0]


def cuda_time_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean wall time of fn() on the current stream, from CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int, name: str | None = None) -> float | None:
    """Device time per call of fn(), from torch.profiler's CUDA trace: the
    self device time of every kernel and copy it ran, summed, over ``iters``
    calls.  With ``name``, fn() launches one kernel whose name holds it, and
    the time is that kernel's mean over the launches the trace holds (a trace
    that lost some would otherwise read low); a count other than ``iters`` is
    printed.  None when the trace holds none."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total_us, count = 0.0, 0
    for evt in prof.key_averages():
        if name is None or name in evt.key:
            total_us += getattr(evt, "self_device_time_total",
                                getattr(evt, "self_cuda_time_total", 0.0))
            count += evt.count
    if total_us <= 0:
        return None
    if name is None:
        return total_us / iters / 1e3
    if count != iters:
        print(f"  profiler trace holds {count} launches of {name} for {iters} calls",
              flush=True)
    return total_us / count / 1e3


def graph_ms(fn, iters: int) -> float:
    """Time per call of fn() replayed from a CUDA graph of ``iters`` calls:
    device time plus the graph's gap between kernels, without the host cost
    of each call."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    return cuda_time_ms(graph.replay, iters=5) / iters


def nms_bound_ms(boxes: torch.Tensor, scores: torch.Tensor) -> tuple[float, str]:
    """Least time for the greedy suppression of these inputs on an H100:
    bytes = every score read once (4 B) + every keep flag written once (1 B)
    + the box (16 B) of each valid candidate only, since a row with score
    <= 0 never suppresses and is never kept; operations = the IoU test of
    every pair of valid candidates (i < j, 14 f32 ops: 4 min/max, 2 sub,
    2 clamp, 1 mul, 1 add, 1 sub, 1 add eps, 1 div, 1 compare) plus 3 ops
    per valid candidate's area."""
    b, k = scores.shape
    v = (scores > 0).sum(dim=1).double()
    nbytes = scores.numel() * 4 + b * k + float(v.sum()) * 16
    ops = float((v * (v - 1) / 2 * 14 + 3 * v).sum())
    t_bytes, t_ops = nbytes / HBM_RATE, ops / F32_PEAK
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def k1_times(boxes: torch.Tensor, scores: torch.Tensor, iou: float, label: str) -> dict:
    """K1's time on these candidates (profiler trace and CUDA graph, per
    launch), its plain version's and its bound, printed under ``label``."""
    from rtmodt_tpu_torch.ops import nms_kernel

    launch = lambda: nms_kernel.greedy_suppress(boxes, scores, iou)  # noqa: E731
    plain = lambda: nms_kernel.greedy_suppress_reference(boxes, scores, iou)  # noqa: E731
    t = {"trace_ms": device_ms(launch, iters=100, name="nms_greedy_kernel"),
         "graph_ms": graph_ms(launch, iters=100), "plain_ms": cuda_time_ms(plain, iters=20),
         "bound": nms_bound_ms(boxes, scores), "valid": int((scores > 0).sum())}
    print(f"  K1 at {label}, {t['valid']} valid of {scores.numel()}: "
          + ("not measured" if t["trace_ms"] is None else f"{t['trace_ms']:.5f} ms")
          + f" per launch (profiler trace); CUDA graph {t['graph_ms']:.5f} ms; plain version "
          f"{t['plain_ms']:.4f} ms; bound {t['bound'][0]:.3e} ms ({t['bound'][1]})", flush=True)
    return t


def synthetic_case(name: str, gen: torch.Generator, b: int, k: int):
    xy = torch.rand(b, k, 2, generator=gen) * 560
    wh = torch.rand(b, k, 2, generator=gen) * 152 + 8
    boxes = torch.cat([xy, xy + wh], dim=-1)
    scores = torch.sort(torch.rand(b, k, generator=gen) * 0.95 + 0.05, dim=1,
                        descending=True).values
    if name == "tied":
        boxes[:, 1::3] = boxes[:, 0::3][:, : boxes[:, 1::3].shape[1]]
        scores = scores[:, ::3].repeat_interleave(3, dim=1)[:, :k].contiguous()
    elif name == "zero_score":
        scores[:, k // 2:] = 0.0
    elif name == "holes":           # zero scores anywhere, not only a suffix
        scores[torch.rand(b, k, generator=gen) < 0.3] = 0.0
    elif name == "identical":       # every pair conflicts
        boxes[:] = boxes[:, :1].clone()
    elif name == "no_valid":
        scores.zero_()
    elif name == "one_valid":
        at = torch.randint(0, k, (b, 1), generator=gen)
        scores[torch.arange(k)[None, :] != at] = 0.0
    elif name == "degenerate":      # zero-width and inverted boxes: zero or negative areas
        boxes[:, 0::3, 2] = boxes[:, 0::3, 0]
        boxes[:, 1::3, 0], boxes[:, 1::3, 2] = boxes[:, 1::3, 2].clone(), boxes[:, 1::3, 0].clone()
    elif name == "class_offset":
        from rtmodt_tpu_torch.ops.nms import CLASS_OFFSET

        boxes = boxes + torch.randint(0, 8, (b, k, 1), generator=gen).float() * CLASS_OFFSET
    return boxes.contiguous(), scores.contiguous()


def _k1_at_b1(det, frame: np.ndarray, packed: bool) -> tuple:
    """K1's inputs at B = 1 from one real frame through the per-stage
    (BGR letterbox) or the packed (planar I420) front, with the detector's
    own ``nms_candidates`` rows, and its keep mask against the plain
    version's.  Returns (boxes, scores, mismatches)."""
    from rtmodt_tpu_torch.ops import nms_kernel
    from rtmodt_tpu_torch.ops.nms import CLASS_OFFSET, candidates_from_logits
    from rtmodt_tpu_torch.ops.yuv import pack_chunk, planar_letterbox

    d = det.cfg
    with torch.no_grad():
        if packed:
            (y, u, v), meta = pack_chunk(frame[None], SIZE)
            img = planar_letterbox(*(torch.from_numpy(p).to(det.device) for p in (y, u, v)),
                                   SIZE, meta.pad_left, meta.pad_top, dtype=det.dtype)[0]
        else:
            img = det.preprocess(torch.from_numpy(frame).to(det.device))
        bd, cl = det.forward(img)
        cb, cs, cc, _ = candidates_from_logits(bd, cl, SIZE, d.conf_threshold,
                                               d.nms_candidates, det._class_mask)
        off = (cb + (cc.float() * CLASS_OFFSET)[..., None]).contiguous()
        cs = cs.contiguous()
    want = nms_kernel.greedy_suppress_reference(off, cs, d.iou_threshold)
    got = nms_kernel.greedy_suppress(off, cs, d.iou_threshold)
    return off, cs, int((got.cpu() != want.cpu()).sum())


def dense_run(cfg) -> tuple[dict, int, float]:
    """The per-stage path over the dense scene (``DENSE_OBJECTS`` objects,
    seed ``DENSE_SEED``): (MOT metrics, K1 launches with warmup, seconds)."""
    from rtmodt_tpu_torch.evaluation.mot_eval import evaluate_mot
    from rtmodt_tpu_torch.ops import nms_kernel
    from rtmodt_tpu_torch.runtime.pipeline import Pipeline
    from rtmodt_tpu_torch.utils.synthetic import dense_moving_scene

    pipe = Pipeline(cfg)
    nms_kernel.launches = 0
    pipe.warmup((H, W))
    gt: dict = {}
    pred: dict = {}
    t0 = time.perf_counter()

    def xywh(x1, y1, x2, y2):   # as the MOT15 text files round them
        return np.array([float(f"{v:.2f}") for v in (x1, y1, x2 - x1, y2 - y1)])

    for t in range(DENSE_FRAMES):
        frame, gt_boxes, _, ids = dense_moving_scene(t, H, W, n_objects=DENSE_OBJECTS,
                                                     seed=DENSE_SEED)
        fid = t + 1
        gt[fid] = {int(i) + 1: xywh(*b) for b, i in zip(gt_boxes, ids)}
        tracks, _, _ = pipe.step(frame, fid, fid / 30.0)
        pred[fid] = {tr.track_id: xywh(*tr.xyxy) for tr in tracks}
    launches = nms_kernel.launches
    seconds = time.perf_counter() - t0
    del pipe
    torch.cuda.empty_cache()
    return evaluate_mot(gt, pred), launches, seconds


def live_paths(smi: str) -> dict:
    """Phase 6: the live per-frame paths, the CLI and the dense-scene
    quality.  Returns K1's launches per run, its mismatches and its time at
    B = 1."""
    import cv2   # the video files, the renderer and the dense scene need it

    from rtmodt_tpu_torch.config import load_config
    from rtmodt_tpu_torch.config.loader import DEFAULTS
    from rtmodt_tpu_torch.config.loader import _deep_merge as _merge
    from rtmodt_tpu_torch.ops import nms_kernel
    from rtmodt_tpu_torch.runtime.pipeline import Pipeline
    from rtmodt_tpu_torch.utils.synthetic import write_synthetic_video

    whole = {"name": "whole_frame", "polygon": [[0, 0], [W, 0], [W, H], [0, H]],
             "trigger": "intrusion", "dwell_time_sec": 0.5, "cooldown_sec": 2.0}
    base = {"system": {"device": DEVICE},
            "detection": {"model": "yolov8s", "input_size": SIZE, "num_classes": 8,
                          "weights": WEIGHTS},
            "profiling": {"warmup_frames": LIVE_WARMUP, "log_interval": 0}}
    out: dict = {"launches": {}, "mismatches": 0}
    n_file = N_LIVE + LIVE_WARMUP
    clip = os.path.join(OUT_DIR, "live720.mp4")
    write_synthetic_video(clip, frames=n_file, h=H, w=W, n_objects=N_OBJECTS, fps=LIVE_FPS)
    video = os.path.join(OUT_DIR, "annotated_per_stage.mp4")
    runs = {
        "per_stage": {"profiling": {"per_stage": True},
                      "visualization": {"enabled": True, "save_video": True,
                                        "save_path": video}},
        "packed": {"profiling": {"per_stage": False}, "parallel": {"pipeline_depth": 2},
                   "visualization": {"enabled": True}},
    }
    for name, over in runs.items():
        label = "a" if name == "per_stage" else "b"
        print(f"  ({label}) Pipeline.run, {name}: {n_file} frames of {W}x{H} at {LIVE_FPS:g} fps",
              flush=True)
        log = os.path.join(OUT_DIR, f"events_{name}.jsonl")
        for f in (log, video):
            if os.path.exists(f) and (f == log or name == "per_stage"):
                os.remove(f)
        events = {"zones": DEFAULTS["events"]["zones"] + [whole], "alert": {"log_path": log}}
        pipe = Pipeline(load_config(overrides=_merge(_merge(base, over), {"events": events})))
        torch.cuda.synchronize()
        nms_kernel.launches = 0
        summary = pipe.run(clip)
        launches = nms_kernel.launches
        frames = pipe.profiler.frame_count
        out["launches"][name] = {"launches": launches, "frames": frames}
        print(json.dumps({"path": name, "card": smi, "frames": frames, **summary}), flush=True)
        print(f"  K1 launches {launches} for {frames} frames + {WARMUP_ITERS} warmup", flush=True)
        if frames != n_file or launches != frames + WARMUP_ITERS:
            fail(f"{name}: K1 launched {launches} times for {frames} frames "
                 f"(+{WARMUP_ITERS} warmup) of {n_file}")
        st = pipe.tracker.state
        vis_end, births = int((st.active & (st.tsu == 0)).sum()), int(st.next_id) - 1
        n_events = 0
        if os.path.exists(log):
            with open(log) as f:
                n_events = sum(1 for _ in f)
        print(f"  tracks: {vis_end} visible at the end, {births} ids born for {N_OBJECTS} "
              f"objects; {n_events} zone events; zone counts "
              f"{json.dumps(pipe.events.zone_counts())}", flush=True)
        if vis_end < N_OBJECTS // 2 or births > 3 * N_OBJECTS:
            fail(f"{name}: tracks not stable: {vis_end} visible, {births} ids")
        if n_events == 0:
            fail(f"{name}: no zone events were written")
        if not torch.isfinite(st.boxes[st.active]).all():
            fail(f"{name}: non-finite track boxes")
        if name == "per_stage":
            cap = cv2.VideoCapture(video)
            n_video = 0
            while cap.read()[0]:
                n_video += 1
            cap.release()
            print(f"  annotated video {os.path.relpath(video, ROOT)}: {n_video} frames", flush=True)
            if n_video != frames:
                fail(f"annotated video has {n_video} frames for {frames} processed")
        # K1 at B = 1 on this path's real inputs: bit-equal to the plain version
        cap = cv2.VideoCapture(clip)
        for _ in range(N_LIVE // 2):
            ok, frame = cap.read()
        cap.release()
        if not ok:
            fail(f"cannot read {clip}")
        boxes, scores, diff = _k1_at_b1(pipe.detector, frame, packed=name == "packed")
        out["mismatches"] += diff
        print(f"  K1 at B=1 on the {name} path's inputs: valid {int((scores > 0).sum())}, "
              f"mismatches {diff}", flush=True)
        if diff:
            fail(f"K1 differs from its plain version at B=1 on the {name} path")
        if name == "per_stage":
            from rtmodt_tpu_torch.ops.letterbox import letterbox

            with torch.no_grad():
                fdev = torch.from_numpy(frame).to(pipe.device)
                gap = float((letterbox(fdev, SIZE, torch.bfloat16)[0].float()
                             - letterbox(fdev, SIZE, torch.float32)[0]).abs().max())
            print(f"  BGR letterbox: max|bf16 - f32| = {gap:.5f} (tolerance "
                  f"{LETTERBOX_BF16_TOL})", flush=True)
            if gap > LETTERBOX_BF16_TOL:
                fail(f"bf16 letterbox differs from float32 by {gap}")
            out["b1"] = k1_times(boxes, scores, pipe.cfg.detection.iou_threshold,
                                 "B=1 (per-stage inputs)")
        del pipe
        torch.cuda.empty_cache()

    # (c) the CLI on a 25-fps file: its events must carry the file's stream time
    print(f"  (c) tools/run_pipeline_torch.py on a {LIVE_FPS:g}-fps {W}x{H} file, botsort + GMC",
          flush=True)
    cli_clip = os.path.join(OUT_DIR, "cli25.mp4")
    write_synthetic_video(cli_clip, frames=CLI_FRAMES, h=H, w=W, n_objects=N_OBJECTS,
                          fps=LIVE_FPS, seed=3)
    cli_log = os.path.join(OUT_DIR, "events_cli.jsonl")
    if os.path.exists(cli_log):
        os.remove(cli_log)
    cli_cfg = _merge(base, {
        "system": {"log_dir": os.path.join(OUT_DIR, "logs")},
        "tracking": {"algorithm": "botsort", "gmc": {"method": "phase"}},
        "events": {"zones": [dict(whole, dwell_time_sec=CLI_DWELL, cooldown_sec=1.0)],
                   "alert": {"log_path": cli_log}},
        "profiling": {"per_stage": True, "warmup_frames": 4},
        "visualization": {"enabled": True},
    })
    cfg_path = os.path.join(OUT_DIR, "cli.yaml")
    with open(cfg_path, "w") as f:
        json.dump(cli_cfg, f)          # JSON is YAML
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, os.path.join(ROOT, "tools", "run_pipeline_torch.py"),
                           "-c", cfg_path, "-s", cli_clip], cwd=ROOT, capture_output=True,
                          text=True, timeout=600)
    tail = proc.stdout.strip().splitlines()
    print("  " + "\n  ".join(tail[-8:]), flush=True)
    print(f"  CLI exit {proc.returncode} in {time.perf_counter() - t0:.1f} s", flush=True)
    if proc.returncode != 0:
        print(proc.stderr[-3000:], file=sys.stderr)
        fail(f"the CLI exited {proc.returncode}")
    cli_events = []
    if os.path.exists(cli_log):
        with open(cli_log) as f:
            cli_events = [json.loads(line) for line in f]
    dwells = sorted({e["dwell_time_sec"] for e in cli_events})
    off_grid = [x for x in dwells if abs(x * LIVE_FPS - round(x * LIVE_FPS)) > 0.13]
    print(f"  CLI events {len(cli_events)}; dwell times {dwells} s "
          f"(multiples of 1/{LIVE_FPS:g} s, each rounded to 0.01)", flush=True)
    if not cli_events or off_grid:
        fail(f"CLI events: {len(cli_events)}, dwell times off the 1/{LIVE_FPS:g} s grid: "
             f"{off_grid}")

    # (d) tracking quality of the per-stage path on the dense scene
    print(f"  (d) quality: dense_moving_scene seed {DENSE_SEED}, {DENSE_OBJECTS} objects, "
          f"{DENSE_FRAMES} frames, per-stage path", flush=True)
    cfg = load_config(overrides=_merge(base, {
        "detection": {"conf_threshold": 0.35, "classes": None},
        "tracking": {"bytetrack": {"match_thresh": 0.8, "track_thresh": 0.3,
                                   "new_track_thresh": 0.3}},
        "events": {"enabled": False}, "visualization": {"enabled": False},
        "profiling": {"per_stage": True, "warmup_frames": 0}}))
    q, launches, seconds = dense_run(cfg)
    out["launches"]["dense"] = {"launches": launches, "frames": DENSE_FRAMES}
    if launches != DENSE_FRAMES + WARMUP_ITERS:
        fail(f"dense run: K1 launched {launches} times for {DENSE_FRAMES} frames")
    out["quality"] = q
    print(f"  dense quality: IDF1 {q['idf1']:.4f}, MOTA {q['mota']:.4f}, ID switches "
          f"{q['num_switches']}, HOTA {q['hota']:.4f} ({seconds:.1f} s, "
          f"K1 launches {launches}); reference 0.803 IDF1 / 63 switches", flush=True)
    if q["idf1"] < IDF1_FLOOR:
        fail(f"dense-scene IDF1 {q['idf1']:.4f} < {IDF1_FLOOR}")
    return out


def _k1_chunk(pipe, planes, meta) -> tuple[torch.Tensor, torch.Tensor, int]:
    """K1's inputs on a chunk's real candidates and its mismatches against
    the plain version: (boxes, scores, mismatches)."""
    from rtmodt_tpu_torch.ops import nms_kernel
    from rtmodt_tpu_torch.ops.nms import CLASS_OFFSET, candidates_from_logits
    from rtmodt_tpu_torch.ops.yuv import planar_letterbox

    d = pipe.cfg.detection
    with torch.no_grad():
        img = planar_letterbox(*planes, SIZE, meta.pad_left, meta.pad_top,
                               dtype=pipe.detector.dtype).permute(0, 3, 1, 2)
        bd, cl = pipe.detector.model(img)
        cb, cs, cc, _ = candidates_from_logits(bd, cl, SIZE, d.conf_threshold, CANDIDATES,
                                               pipe.detector._class_mask)
        off = (cb + (cc.float() * CLASS_OFFSET)[..., None]).contiguous()
        cs = cs.contiguous()
    want = nms_kernel.greedy_suppress_reference(off, cs, d.iou_threshold)
    got = nms_kernel.greedy_suppress(off, cs, d.iou_threshold)
    return off, cs, int((got.cpu() != want.cpu()).sum())


def tracker_paths(smi: str, frames: np.ndarray) -> dict:
    """Phase 7: deepsort / botsort / ocsort with GMC and host-LAPJV ByteTrack
    on the three paths, the oracle-detection tracker comparison and the
    dense scene with the appearance trackers.  Returns K1's launches per
    run and its mismatches."""
    from rtmodt_tpu_torch.config import load_config
    from rtmodt_tpu_torch.config.loader import _deep_merge as _merge
    from rtmodt_tpu_torch.ops import nms_kernel
    from rtmodt_tpu_torch.ops.gmc import half_res_luma, luma_grids, phase_shift
    from rtmodt_tpu_torch.ops.roi import crop_yuv_rgb
    from rtmodt_tpu_torch.ops.yuv import pack_chunk, pad_planes
    from rtmodt_tpu_torch.runtime.pipeline import Pipeline
    from tools import compare_trackers_torch as compare

    out: dict = {"launches": {}, "mismatches": 0}
    whole = {"name": "whole_frame", "polygon": [[0, 0], [W, 0], [W, H], [0, H]],
             "trigger": "intrusion", "dwell_time_sec": 0.5, "cooldown_sec": 2.0}
    gmc = {"method": "phase"}
    base = {"system": {"device": DEVICE},
            "detection": {"model": "yolov8s", "input_size": SIZE, "num_classes": 8,
                          "weights": WEIGHTS},
            "tracking": {"deepsort": {"embedder": EMBEDDER}, "botsort": {"embedder": EMBEDDER}},
            "profiling": {"warmup_frames": LIVE_WARMUP, "log_interval": 0}}

    def check_k1(name: str, diff: int, valid: int) -> None:
        out["mismatches"] += diff
        print(f"  K1 on the {name} path's inputs: valid {valid}, mismatches {diff}", flush=True)
        if diff:
            fail(f"K1 differs from its plain version on the {name} path")

    # (a) the appearance chunk program: deepsort + GMC, chunks of K 720p frames
    print(f"  (a) run_chunked, deepsort + GMC: {N_CHUNKS} chunks of {K} frames of {W}x{H}",
          flush=True)
    log = os.path.join(OUT_DIR, "events_deepsort_chunked.jsonl")
    if os.path.exists(log):
        os.remove(log)
    cfg = load_config(overrides=_merge(base, {
        "tracking": {"algorithm": "deepsort", "gmc": gmc},
        "parallel": {"chunk_size": K},
        "events": {"zones": [whole], "alert": {"log_path": log}},
        "profiling": {"per_stage": False, "warmup_frames": 0},
        "visualization": {"enabled": False}}))
    pipe = Pipeline(cfg)
    pipe.run_chunked(list(frames[:2 * K]))            # warm-up: cuDNN plans, allocator
    pipe.reset()
    torch.cuda.synchronize()
    nms_kernel.launches = 0
    summary = pipe.run_chunked(list(frames))
    launches = nms_kernel.launches
    out["launches"]["deepsort_gmc_chunk"] = {"launches": launches, "chunks": summary["chunks"],
                                             "frames": summary["frames"]}
    print("  " + json.dumps({"path": "deepsort_gmc_chunk", "card": smi, **summary}), flush=True)
    print(f"  K1 launches {launches} for {summary['chunks']} chunks", flush=True)
    if launches != summary["chunks"] or summary["frames"] != K * N_CHUNKS:
        fail(f"deepsort chunked: K1 launched {launches} times for {summary['chunks']} chunks")
    st = pipe.tracker.state
    confirmed = st.active & (st.tsu == 0) & (st.age >= pipe.tracker.cfg.n_init)
    births = int(st.next_id) - 1
    n_events = sum(1 for _ in open(log)) if os.path.exists(log) else 0
    print(f"  tracks: {int(confirmed.sum())} visible at the end, {births} ids born for "
          f"{N_OBJECTS} objects; {n_events} zone events", flush=True)
    if int(confirmed.sum()) < N_OBJECTS // 2 or births > 3 * N_OBJECTS or n_events == 0:
        fail(f"deepsort chunked: tracks not stable or no events ({int(confirmed.sum())} "
             f"visible, {births} ids, {n_events} events)")
    if not (torch.isfinite(st.boxes[st.active]).all() and torch.isfinite(st.feat).all()):
        fail("deepsort chunked: non-finite track state")
    (y, u, v), meta = pack_chunk(frames[:K], SIZE)
    planes = tuple(torch.from_numpy(p_).to(DEVICE) for p_ in (y, u, v))
    _, scores, diff = _k1_chunk(pipe, planes, meta)
    check_k1("deepsort chunked", diff, int((scores > 0).sum()))
    pipe.reset()
    chunk_ms = cuda_time_ms(lambda: pipe.submit_packed_yuv(planes, H, W), iters=5)
    chunk_dev_ms = device_ms(lambda: pipe.submit_packed_yuv(planes, H, W), iters=3)
    with torch.no_grad():
        res = pipe.detect_chunk(*planes, meta, to_source=False)
        crop_hw = tuple(pipe.tracker.cfg.crop_hw)
        yp, up, vp = pad_planes(*planes, SIZE, meta.pad_left, meta.pad_top)

        def crops_fn():   # as Pipeline.embed_chunk takes them: one batched gather
            return crop_yuv_rgb(yp.float(), up.float(), vp.float(), res.boxes, crop_hw)
        crops = crops_fn()
        flat = crops.reshape(-1, *crops.shape[2:])
        crop_ms = cuda_time_ms(crops_fn, iters=10)
        emb_ms = cuda_time_ms(lambda: pipe.tracker.embedder(flat), iters=10)
        emb_dev_ms = device_ms(lambda: pipe.tracker.embedder(flat), iters=5)
        grids = luma_grids(half_res_luma(planes[0]), cfg.tracking.gmc.grid)
        grid_ms = cuda_time_ms(lambda: luma_grids(half_res_luma(planes[0]),
                                                  cfg.tracking.gmc.grid), iters=10)
        shift_ms = cuda_time_ms(lambda: phase_shift(grids[0], grids[1]), iters=20)
    out["chunk"] = {"chunk_ms": chunk_ms, "chunk_dev_ms": chunk_dev_ms, "crop_ms": crop_ms,
                    "embed_ms": emb_ms, "embed_dev_ms": emb_dev_ms, "grid_ms": grid_ms,
                    "shift_ms": shift_ms}
    print(f"  chunk program {chunk_ms / K:.4f} ms/frame ({chunk_ms:.3f} ms per chunk of {K}, "
          f"CUDA events); device time "
          + ("not measured" if chunk_dev_ms is None else
             f"{chunk_dev_ms / K:.4f} ms/frame, device idle "
             f"{100 * (1 - chunk_dev_ms / chunk_ms):.1f} % of the chunk program")
          + f"; ROI crops {crop_ms / K:.4f} ms/frame ({flat.shape[0] // K} crops of "
          f"{crop_hw[0]}x{crop_hw[1]}), embedder {emb_ms / K:.4f} ms/frame (device "
          + ("not measured" if emb_dev_ms is None else f"{emb_dev_ms / K:.4f}")
          + f"; float32, TF32 off), GMC grids {grid_ms / K:.4f} ms/frame, phase_shift "
          f"{shift_ms:.4f} ms/frame", flush=True)
    del pipe
    torch.cuda.empty_cache()

    # (b)-(d) the per-frame paths on the 25-fps file of phase 6
    clip = os.path.join(OUT_DIR, "live720.mp4")
    n_file = N_LIVE + LIVE_WARMUP
    runs = {
        "botsort_gmc_per_stage": ("b", {"tracking": {"algorithm": "botsort", "gmc": gmc},
                                        "profiling": {"per_stage": True}}, n_file),
        "ocsort_gmc_packed": ("c", {"tracking": {"algorithm": "ocsort", "gmc": gmc},
                                    "profiling": {"per_stage": False},
                                    "parallel": {"pipeline_depth": 2}}, n_file),
        "bytetrack_lapjv_per_stage": ("d", {"tracking": {"bytetrack": {"assignment": "lapjv"}},
                                            "profiling": {"per_stage": True,
                                                          "warmup_frames": 4}}, N_LAPJV),
    }
    import cv2

    cap = cv2.VideoCapture(clip)
    for _ in range(N_LIVE // 2):
        ok, frame = cap.read()
    cap.release()
    if not ok:
        fail(f"cannot read {clip}")
    for name, (label, over, n) in runs.items():
        print(f"  ({label}) Pipeline.run, {name}: {n} frames of {W}x{H} at {LIVE_FPS:g} fps",
              flush=True)
        log = os.path.join(OUT_DIR, f"events_{name}.jsonl")
        if os.path.exists(log):
            os.remove(log)
        events = {"zones": [whole], "alert": {"log_path": log}}
        pipe = Pipeline(load_config(overrides=_merge(_merge(base, over), {
            "events": events, "visualization": {"enabled": True}})))
        torch.cuda.synchronize()
        nms_kernel.launches = 0
        summary = pipe.run(clip, max_frames=n)
        launches = nms_kernel.launches
        frames_done = pipe.profiler.frame_count
        out["launches"][name] = {"launches": launches, "frames": frames_done}
        print("  " + json.dumps({"path": name, "card": smi, "frames": frames_done, **summary}),
              flush=True)
        print(f"  K1 launches {launches} for {frames_done} frames + {WARMUP_ITERS} warmup",
              flush=True)
        if frames_done != n or launches != frames_done + WARMUP_ITERS:
            fail(f"{name}: K1 launched {launches} times for {frames_done} frames "
                 f"(+{WARMUP_ITERS} warmup) of {n}")
        n_events = sum(1 for _ in open(log)) if os.path.exists(log) else 0
        print(f"  {n_events} zone events; zone counts {json.dumps(pipe.events.zone_counts())}",
              flush=True)
        if n_events == 0:
            fail(f"{name}: no zone events were written")
        if pipe.tracker._host is None:
            st = pipe.tracker.state
            if not torch.isfinite(st.boxes[st.active]).all():
                fail(f"{name}: non-finite track boxes")
        _, scores, diff = _k1_at_b1(pipe.detector, frame, packed=name.endswith("packed"))
        check_k1(name, diff, int((scores > 0).sum()))
        del pipe
        torch.cuda.empty_cache()

    # (e) the oracle-detection scenarios of tools/compare_trackers_torch.py
    print("  (e) tools/compare_trackers_torch.py on the card (oracle detections)", flush=True)
    out["compare"] = {}
    for scenario, n in COMPARE.items():
        t0 = time.perf_counter()
        frames_bgr, gt = compare.build(scenario, n, pairs=3, objects=64)
        for name, kwargs in compare.tracker_configs(scenario, EMBEDDER):
            row = compare.run_tracker(name, kwargs, frames_bgr, gt, DEVICE)
            out["compare"][f"{scenario}/{name}"] = row
            print(f"    {scenario:6s} {name:28s} IDF1 {row['idf1']:.4f}  MOTA {row['mota']:.4f}"
                  f"  HOTA {row['hota']:.4f}  AssA {row['ass_a']:.4f}  switches "
                  f"{row['switches']}", flush=True)
            if scenario == "shake" and name.endswith("_gmc") and row["idf1"] < GMC_SHAKE_IDF1:
                fail(f"shake {name}: IDF1 {row['idf1']} < {GMC_SHAKE_IDF1}")
        print(f"    {scenario}: {n} frames in {time.perf_counter() - t0:.1f} s", flush=True)

    # (f) the dense scene, full detection, per stage, with the appearance trackers
    for algorithm in ("deepsort", "botsort"):
        print(f"  (f) dense_moving_scene seed {DENSE_SEED}, {DENSE_OBJECTS} objects, "
              f"{DENSE_FRAMES} frames, per stage, {algorithm} ({os.path.basename(EMBEDDER)})",
              flush=True)
        cfg = load_config(overrides=_merge(base, {
            "detection": {"conf_threshold": 0.35, "classes": None},
            "tracking": {"algorithm": algorithm,
                         "deepsort": {"min_confidence": 0.3},
                         "botsort": {"track_thresh": 0.3, "new_track_thresh": 0.3,
                                     "match_thresh": 0.8}},
            "events": {"enabled": False}, "visualization": {"enabled": False},
            "profiling": {"per_stage": True, "warmup_frames": 0}}))
        q, launches, seconds = dense_run(cfg)
        out["launches"][f"dense_{algorithm}"] = {"launches": launches, "frames": DENSE_FRAMES}
        out[f"dense_{algorithm}"] = q
        ref_idf1, ref_sw = DENSE_REF[algorithm]
        print(f"  dense {algorithm}: IDF1 {q['idf1']:.4f}, MOTA {q['mota']:.4f}, ID switches "
              f"{q['num_switches']}, HOTA {q['hota']:.4f} ({seconds:.1f} s, K1 launches "
              f"{launches}); reference {ref_idf1} IDF1 / {ref_sw} switches", flush=True)
        if launches != DENSE_FRAMES + WARMUP_ITERS:
            fail(f"dense {algorithm}: K1 launched {launches} times for {DENSE_FRAMES} frames")
        if q["idf1"] < IDF1_FLOOR:
            fail(f"dense {algorithm}: IDF1 {q['idf1']:.4f} < {IDF1_FLOOR}")
    return out


def _write_clip(path: str, n: int, h: int, w: int, t0: int) -> None:
    """``n`` frames of the moving-boxes scene from time ``t0`` (bench.py's
    phase-shifted streams) as a 25-fps mp4v file."""
    import cv2

    from rtmodt_tpu_torch.utils.synthetic import moving_boxes_frame

    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), LIVE_FPS, (w, h))
    if not vw.isOpened():
        fail(f"cannot open a video writer for {path}")
    for t in range(n):
        vw.write(moving_boxes_frame(t + t0, h, w, N_OBJECTS)[0])
    vw.release()


def _read_clips(paths: list[str], n: int) -> np.ndarray:
    """The first ``n`` decoded frames of each file: (n, S, H, W, 3)."""
    import cv2

    out = []
    for path in paths:
        cap = cv2.VideoCapture(path)
        frames = [cap.read()[1] for _ in range(n)]
        cap.release()
        if any(f is None for f in frames):
            fail(f"cannot read {n} frames of {path}")
        out.append(np.stack(frames))
    return np.stack(out, axis=1)


def _host_cpu() -> str:
    model, avx512 = "unknown", False
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name") and model == "unknown":
                    model = line.split(":", 1)[1].strip()
                if line.startswith("flags"):
                    avx512 = "avx512bw" in line.split()
    except OSError:
        pass
    return f"{model}, {os.cpu_count()} cpus, avx512bw {'yes' if avx512 else 'no'}"


def multistream_paths(smi: str) -> dict:
    """Phase 8: the native packer, ``MultiStreamPipeline`` on S streams, the
    streams' independence in float32, the chunk program's device time,
    deepsort + GMC and a degraded run.  Returns K1's launches per run and
    its time and bound at B = T * S."""
    from rtmodt_tpu_torch.config import load_config
    from rtmodt_tpu_torch.config.loader import DEFAULTS
    from rtmodt_tpu_torch.config.loader import _deep_merge as _merge
    from rtmodt_tpu_torch.ops import framepack, nms_kernel
    from rtmodt_tpu_torch.ops.yuv import content_dims, pack_chunk, packed_meta
    from rtmodt_tpu_torch.parallel.multistream import MultiStreamPipeline
    from rtmodt_tpu_torch.runtime.pipeline import Pipeline
    from rtmodt_tpu_torch.tracking.bytetrack import TrackOutputs
    from rtmodt_tpu_torch.utils.synthetic import moving_boxes_frame

    out: dict = {"launches": {}, "mismatches": 0}
    b = T_MULTI * S_STREAMS

    # (a) the packer: native against its plain versions, byte for byte
    print(f"  (a) native packer on the card's host ({_host_cpu()}; "
          f"{framepack.default_threads()} threads)", flush=True)
    rng = np.random.default_rng(8)
    out["packer"] = {}
    for label, (h, w, n) in {"720p 2x": (H, W, PACK_FRAMES),
                             "1080p 3x": (H2, W2, PACK_FRAMES // 2)}.items():
        frames = np.stack([moving_boxes_frame(t, h, w, N_OBJECTS)[0] for t in range(n)])
        frames[1::2] = rng.integers(0, 256, frames[1::2].shape, dtype=np.uint8)
        ch, cw = content_dims(h, w, SIZE)
        fac = h // ch
        if not framepack.native_pack_wins(h, w, ch, cw):
            fail(f"{label}: the native packer does not take this geometry")
        got = framepack.pack_i420_chunk_native(frames, ch, cw)
        want = tuple(np.empty_like(p) for p in got)
        t0 = time.perf_counter()
        if fac == 2:
            framepack._pack_2x(frames, want)
        else:
            framepack._pack_odd(frames, fac, want)
        plain_ms = (time.perf_counter() - t0) * 1e3 / n
        diff = sum(int((a != b_).sum()) for a, b_ in zip(got, want))
        reps = []
        for _ in range(5):
            t0 = time.perf_counter()
            framepack.pack_i420_chunk_native(frames, ch, cw, out=got)
            reps.append((time.perf_counter() - t0) * 1e3 / n)
        t0 = time.perf_counter()
        pack_chunk(frames, SIZE)
        dispatch_ms = (time.perf_counter() - t0) * 1e3 / n
        native_ms = float(np.median(reps))
        out["packer"][label] = {"native_ms": native_ms, "plain_ms": plain_ms,
                                "pack_chunk_ms": dispatch_ms, "mismatches": diff}
        print(f"  packer {label}: {n} frames {w}x{h} -> {cw}x{ch}: mismatches {diff}; native "
              f"{native_ms:.4f} ms/frame (median of 5), pack_chunk {dispatch_ms:.4f}, numpy "
              f"plain version {plain_ms:.4f} ms/frame (host clock)", flush=True)
        if diff:
            fail(f"native packer differs from its plain version on {label} ({diff} bytes)")

    whole = {"name": "whole_frame", "polygon": [[0, 0], [W, 0], [W, H], [0, H]],
             "trigger": "intrusion", "dwell_time_sec": 0.5, "cooldown_sec": 2.0}
    base = {"system": {"device": DEVICE},
            "detection": {"model": "yolov8s", "input_size": SIZE, "num_classes": 8,
                          "weights": WEIGHTS},
            "tracking": {"deepsort": {"embedder": EMBEDDER}},
            "profiling": {"log_interval": 0}, "visualization": {"enabled": False},
            "parallel": {"num_streams": S_STREAMS, "chunk_size": T_MULTI,
                         "pipeline_depth": MULTI_DEPTH}}
    files = [os.path.join(OUT_DIR, f"multi{si}.mp4") for si in range(S_STREAMS)]
    for si, path in enumerate(files):
        _write_clip(path, N_MULTI, H, W, 37 * si)
    short = os.path.join(OUT_DIR, "multi_short.mp4")
    _write_clip(short, N_MULTI // 2, H, W, 37 * (S_STREAMS - 1))

    def events_by_stream(log: str) -> list[int]:
        counts = [0] * S_STREAMS
        if os.path.exists(log):
            with open(log) as f:
                for line in f:
                    counts[json.loads(line)["metadata"]["stream"]] += 1
        return counts

    # (b) MultiStreamPipeline.run: S files, T = 8, ByteTrack, zone events
    print(f"  (b) MultiStreamPipeline.run: {S_STREAMS} x {N_MULTI} frames of {W}x{H} at "
          f"{LIVE_FPS:g} fps, T = {T_MULTI}, depth {MULTI_DEPTH}, ByteTrack", flush=True)
    log = os.path.join(OUT_DIR, "events_multistream.jsonl")
    if os.path.exists(log):
        os.remove(log)
    cfg = load_config(overrides=_merge(base, {"events": {
        "zones": DEFAULTS["events"]["zones"] + [whole], "alert": {"log_path": log}}}))
    msp = MultiStreamPipeline(cfg)
    msp.warmup((H, W), T_MULTI)
    c0 = msp.chunks_submitted
    nms_kernel.launches = 0
    t0 = time.perf_counter()
    summary = msp.run(files)
    seconds = time.perf_counter() - t0
    launches, chunks = nms_kernel.launches, msp.chunks_submitted - c0
    n_chunks = -(-N_MULTI // T_MULTI)
    out["launches"]["multistream_run"] = {"launches": launches, "chunks": chunks,
                                          "frames": summary["frames"]}
    out["run"] = {**summary, "seconds": seconds}
    print("  " + json.dumps({"path": "multistream_run", "card": smi, **summary,
                             "chunks": chunks, "seconds": seconds}), flush=True)
    print(f"  K1 launches {launches} for {chunks} chunks of B = {b} frames", flush=True)
    if launches != n_chunks or chunks != n_chunks or summary["frames"] != S_STREAMS * N_MULTI:
        fail(f"multi-stream run: K1 launched {launches} times for {chunks} chunks "
             f"({summary['frames']} frames)")
    if summary["per_stream_frames"] != [N_MULTI] * S_STREAMS:
        fail(f"multi-stream run: per-stream frames {summary['per_stream_frames']}")
    st = msp.state
    vis = (st.active & (st.tsu == 0)).sum(dim=1).tolist()
    births = (st.next_id - 1).tolist()
    per_events = events_by_stream(log)
    print(f"  per stream: visible at the end {vis}, ids born {births} for {N_OBJECTS} objects; "
          f"zone events {per_events}", flush=True)
    if min(vis) < N_OBJECTS // 2 or max(births) > 3 * N_OBJECTS or min(per_events) == 0:
        fail(f"multi-stream run: tracks not stable or a stream without events ({vis}, "
             f"{births}, {per_events})")
    if not torch.isfinite(st.boxes[st.active]).all():
        fail("multi-stream run: non-finite track boxes")
    frames_ts = _read_clips(files, max(T_MULTI, INDEP_CHUNKS * T_MULTI))
    meta = packed_meta(H, W, SIZE)

    def packed(block: np.ndarray, dev=DEVICE) -> tuple:
        t, s = block.shape[:2]
        (y, u, v), _ = pack_chunk(block.reshape(t * s, H, W, 3), SIZE)
        return tuple(torch.from_numpy(p.reshape(t, s, *p.shape[1:])).to(dev) for p in (y, u, v))

    planes = packed(frames_ts[:T_MULTI])
    flat = tuple(p.reshape(b, *p.shape[2:]) for p in planes)
    off, cs, diff = _k1_chunk(msp, flat, meta)
    out["mismatches"] += diff
    print(f"  K1 on a multi-stream chunk's candidates (B = {b}): valid "
          f"{int((cs > 0).sum())}, mismatches {diff}", flush=True)
    if diff:
        fail("K1 differs from its plain version on the multi-stream chunk")

    # (d) the chunk program's device time per frame slot, K1 at B = T * S
    msp.reset()
    chunk_ms = cuda_time_ms(lambda: msp.submit_chunk_packed(planes, H, W), iters=5)
    chunk_dev_ms = device_ms(lambda: msp.submit_chunk_packed(planes, H, W), iters=3)
    out["chunk"] = {"chunk_ms": chunk_ms, "chunk_dev_ms": chunk_dev_ms}
    print(f"  (d) submit_chunk_packed (T = {T_MULTI}, S = {S_STREAMS}): {chunk_ms / b:.4f} ms per "
          f"frame slot ({chunk_ms:.3f} ms per chunk, CUDA events); device time "
          + ("not measured" if chunk_dev_ms is None else
             f"{chunk_dev_ms / b:.4f} ms per frame slot, device idle "
             f"{100 * (1 - chunk_dev_ms / chunk_ms):.1f} % of the chunk program"), flush=True)
    out["b32"] = k1_times(off, cs, cfg.detection.iou_threshold, f"B = {b}")

    # (c) every stream of the batched program against the single-stream one
    chunks_ts = [frames_ts[c * T_MULTI:(c + 1) * T_MULTI] for c in range(INDEP_CHUNKS)]
    prev = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    out["independence"] = {}
    for dtype_name, half in (("float32", False), ("bf16", True)):
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
        c_cfg = load_config(overrides=_merge(base, {"detection": {"half": half},
                                                    "events": {"enabled": False}}))
        multi = MultiStreamPipeline(c_cfg)
        single = Pipeline(c_cfg)
        got = [multi.submit_chunk_packed(packed(blk), H, W)[0] for blk in chunks_ts]
        got = TrackOutputs(*(torch.cat(f).cpu() for f in zip(*got)))
        vis_diff = id_diff = 0
        box_gap = 0.0
        for si in range(S_STREAMS):
            single.reset()
            want = [single.submit_packed_yuv(tuple(p[:, si] for p in packed(blk)), H, W)[0]
                    for blk in chunks_ts]
            want = TrackOutputs(*(torch.cat(f).cpu() for f in zip(*want)))
            gv, wv = got.visible[:, si], want.visible
            vis_diff += int((gv != wv).sum())
            both = gv & wv
            id_diff += int((got.track_id[:, si][both] != want.track_id[both]).sum())
            if both.any():
                box_gap = max(box_gap, float((got.boxes[:, si][both] - want.boxes[both])
                                             .abs().max()))
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev
        out["independence"][dtype_name] = {"visible_diff": vis_diff, "id_diff": id_diff,
                                           "max_box_gap_px": box_gap}
        print(f"  (c) {dtype_name}: {S_STREAMS} streams x {INDEP_CHUNKS * T_MULTI} frames, "
              f"batched (B = {b}) vs single stream (B = {T_MULTI}): visibility mismatches "
              f"{vis_diff}, id mismatches {id_diff}, max box gap {box_gap:.6f} px"
              + (" (reported, not held)" if half else f" (tolerance {INDEP_BOX_TOL})"),
              flush=True)
        if not half and (vis_diff or id_diff or box_gap > INDEP_BOX_TOL):
            fail("float32: a stream of the batched program differs from the single stream")
        del multi, single
        torch.cuda.empty_cache()

    # (e) deepsort + GMC on two streams
    n_ds = DS_T * DS_CHUNKS
    print(f"  (e) MultiStreamPipeline.run, deepsort + GMC: {DS_STREAMS} streams, T = {DS_T}, "
          f"{DS_CHUNKS} chunks", flush=True)
    log = os.path.join(OUT_DIR, "events_multistream_deepsort.jsonl")
    if os.path.exists(log):
        os.remove(log)
    ds_cfg = load_config(overrides=_merge(base, {
        "tracking": {"algorithm": "deepsort", "gmc": {"method": "phase"}},
        "parallel": {"num_streams": DS_STREAMS, "chunk_size": DS_T},
        "events": {"zones": [whole], "alert": {"log_path": log}}}))
    ds = MultiStreamPipeline(ds_cfg)
    ds.warmup((H, W), DS_T)
    nms_kernel.launches = 0
    ds_summary = ds.run(files[:DS_STREAMS], max_frames=n_ds)
    launches = nms_kernel.launches
    out["launches"]["multistream_deepsort_gmc"] = {"launches": launches, "chunks": DS_CHUNKS,
                                                   "frames": ds_summary["frames"]}
    print("  " + json.dumps({"path": "multistream_deepsort_gmc", "card": smi, **ds_summary}),
          flush=True)
    print(f"  K1 launches {launches} for {DS_CHUNKS} chunks", flush=True)
    if launches != DS_CHUNKS or ds_summary["frames"] != DS_STREAMS * n_ds:
        fail(f"deepsort multi-stream: K1 launched {launches} times for {DS_CHUNKS} chunks")
    for si, st in enumerate(ds.state):
        if not (torch.isfinite(st.boxes[st.active]).all() and torch.isfinite(st.feat).all()):
            fail(f"deepsort multi-stream: non-finite state in stream {si}")
    ds_flat = tuple(p[:DS_T, :DS_STREAMS].reshape(DS_T * DS_STREAMS, *p.shape[2:])
                    for p in planes)
    _, ds_cs, diff = _k1_chunk(ds, ds_flat, meta)
    out["mismatches"] += diff
    print(f"  K1 on a deepsort chunk's candidates: valid {int((ds_cs > 0).sum())}, "
          f"mismatches {diff}", flush=True)
    if diff:
        fail("K1 differs from its plain version on the deepsort multi-stream chunk")
    del ds
    torch.cuda.empty_cache()

    # (f) a degraded run: the last stream's file is half as long
    print(f"  (f) degraded run: stream {S_STREAMS - 1} has {N_MULTI // 2} frames of {N_MULTI}",
          flush=True)
    msp.reset()
    nms_kernel.launches = 0
    deg = msp.run(files[:-1] + [short], max_frames=N_MULTI)
    launches = nms_kernel.launches
    out["launches"]["multistream_degraded"] = {"launches": launches, "chunks": n_chunks,
                                               "frames": deg["frames"]}
    print("  " + json.dumps({"path": "multistream_degraded", "card": smi, **deg}), flush=True)
    want_frames = [N_MULTI] * (S_STREAMS - 1) + [N_MULTI // 2]
    if (deg["dead_streams"] != [S_STREAMS - 1] or deg["per_stream_frames"] != want_frames
            or launches != n_chunks):
        fail(f"degraded run: dead {deg['dead_streams']}, frames {deg['per_stream_frames']}, "
             f"K1 launches {launches} for {n_chunks} chunks")
    del msp
    torch.cuda.empty_cache()
    return out


def _multipart(files: dict) -> tuple[bytes, str]:
    """{field: (filename, bytes, content type)} -> (body, Content-Type), as a
    browser's form upload frames it."""
    boundary = "smokeboundary7"
    body = b"".join(
        f'--{boundary}\r\nContent-Disposition: form-data; name="{name}"; '
        f'filename="{filename}"\r\nContent-Type: {ctype}\r\n\r\n'.encode() + content + b"\r\n"
        for name, (filename, content, ctype) in files.items())
    return body + f"--{boundary}--\r\n".encode(), f"multipart/form-data; boundary={boundary}"


def _http(base: str, method: str, path: str, body: bytes | None = None,
          ctype: str | None = None, timeout: float = 300.0) -> tuple[bytes, dict]:
    """One request; any status but 200 fails the run."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(base + path, data=body, method=method,
                                 headers={"Content-Type": ctype} if ctype else {})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.read(), dict(r.headers)
    except urllib.error.HTTPError as e:
        fail(f"{method} {path}: HTTP {e.code} {e.read()[:400]!r}")


def _mjpeg_parts(content: bytes, boundary: bytes) -> list[bytes]:
    """The JPEG payloads of a complete multipart/x-mixed-replace body."""
    if not content.endswith(b"--" + boundary + b"--\r\n"):
        fail("MJPEG body does not end with its closing boundary")
    out = []
    for piece in content.split(b"--" + boundary)[1:]:
        if piece.startswith(b"--"):
            continue
        head, rest = piece.split(b"\r\n\r\n", 1)
        n = int(head.split(b"Content-Length: ")[1].split(b"\r\n")[0])
        out.append(rest[:n])
    return out


def _jpeg(frame: np.ndarray) -> bytes:
    import cv2

    ok, buf = cv2.imencode(".jpg", frame)
    if not ok:
        fail("JPEG encode failed")
    return buf.tobytes()


def _unjpeg(data: bytes) -> np.ndarray:
    import cv2

    img = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    if img is None:
        fail("a served JPEG does not decode")
    return img


def _check_detection(data: dict, size: list[int], where: str) -> None:
    """The reference's detection schema, finite boxes inside the frame."""
    if set(data) - {"events", "zones"} != {"detections", "tracks", "inference_ms",
                                           "num_objects", "image_size"}:
        fail(f"{where}: keys {sorted(data)}")
    if data["image_size"] != size or data["num_objects"] != len(data["detections"]):
        fail(f"{where}: image_size {data['image_size']}, num_objects {data['num_objects']}")
    for d in data["detections"] + data["tracks"]:
        b = np.asarray(d["bbox"], np.float64)
        if (b.shape != (4,) or not np.isfinite(b).all() or b[0] > b[2] or b[1] > b[3]
                or not 0.0 < d["confidence"] <= 1.0 or not isinstance(d["class_name"], str)):
            fail(f"{where}: bad entry {d}")


def _watch_monitor(opened: list, want_parts: int, out: dict) -> None:
    """Viewer thread of a ``LiveMonitor``: waits for it, connects to
    ``/stream``, pulls ``/frame`` once a frame is published, then reads the
    stream until ``want_parts`` distinct parts arrived or it ended.  Errors
    go to ``out["error"]``."""
    import urllib.error
    import urllib.request

    try:
        deadline = time.monotonic() + 300.0
        while not opened:
            if time.monotonic() > deadline:
                raise TimeoutError("no LiveMonitor was opened")
            time.sleep(0.01)
        base = f"http://127.0.0.1:{opened[0].port}"
        with urllib.request.urlopen(base + "/stream", timeout=60) as stream:
            while True:
                try:
                    with urllib.request.urlopen(base + "/frame", timeout=30) as r:
                        out["frame"] = _unjpeg(r.read()).shape
                    break
                except urllib.error.HTTPError as e:
                    if e.code != 404 or time.monotonic() > deadline:
                        raise
                    time.sleep(0.01)
            buf, parts = b"", []
            while len({p.tobytes() for p in parts}) < want_parts:
                chunk = stream.read1(1 << 16)
                if not chunk:
                    break
                buf += chunk
                pieces = buf.split(b"--rtmodtlive")
                buf = pieces[-1]
                for piece in pieces[:-1]:
                    if b"\r\n\r\n" in piece and b"image/jpeg" in piece:
                        head, rest = piece.split(b"\r\n\r\n", 1)
                        n = int(head.split(b"Content-Length: ")[1].split(b"\r\n")[0])
                        parts.append(_unjpeg(rest[:n]))
        out["shapes"] = sorted({p.shape for p in parts})
        out["distinct"] = len({p.tobytes() for p in parts})
    except Exception as e:   # reported by the phase, which fails on it
        out["error"] = f"{type(e).__name__}: {e}"


def _counted_subprocess(module: str, argv: list[str], timeout: float = 600.0) -> tuple:
    """Run ``module``'s ``main(argv)`` in a fresh interpreter and read K1's
    launch count of that process from its last line.  Returns (process,
    launches, seconds)."""
    code = (f"import json, sys\nsys.path.insert(0, {ROOT!r})\n"
            f"from {module} import main\nfrom rtmodt_tpu_torch.ops import nms_kernel\n"
            f"rc = main({argv!r})\n"
            "print(json.dumps({'k1_launches': nms_kernel.launches}), flush=True)\n"
            "sys.exit(rc)\n")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=timeout)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        print(proc.stdout[-3000:], "\n", proc.stderr[-3000:], file=sys.stderr)
        fail(f"{module} {' '.join(argv[:2])} exited {proc.returncode}")
    launches = json.loads(proc.stdout.strip().splitlines()[-1])["k1_launches"]
    return proc, launches, seconds


def serving_paths(smi: str, dense_q: dict) -> dict:
    """Phase 9: the web app over a real socket (every route), the default
    detector build, K1 on a served frame, 8-way concurrency, request times,
    the MJPEG monitor behind ``Pipeline.run``, ``MultiStreamPipeline.run``
    and the CLI, and ``tools/run_inference_torch.py``'s two subcommands.
    Returns K1's launches per path, its mismatches, its time at B = 1 on a
    served frame and the times; ``dense_q`` is phase 6 (d)'s dense-scene
    quality, printed beside the tool's."""
    import threading
    from wsgiref.simple_server import make_server

    import cv2

    import rtmodt_tpu_torch.serving.monitor as monitor_mod
    import rtmodt_tpu_torch.serving.server as srv
    from rtmodt_tpu_torch.config import load_config
    from rtmodt_tpu_torch.config.loader import DetectionConfig
    from rtmodt_tpu_torch.config.loader import _deep_merge as _merge
    from rtmodt_tpu_torch.detection.detector import Detector
    from rtmodt_tpu_torch.ops import nms_kernel
    from rtmodt_tpu_torch.parallel.multistream import MultiStreamPipeline
    from rtmodt_tpu_torch.runtime.pipeline import Pipeline
    from rtmodt_tpu_torch.serving.wsgi import _QuietHandler, _ThreadingWSGIServer
    from rtmodt_tpu_torch.tracking.postprocess import write_mot_rows
    from rtmodt_tpu_torch.utils.synthetic import (dense_moving_scene, moving_boxes_frame,
                                                  write_synthetic_video)

    out: dict = {"launches": {}, "mismatches": 0, "times": {}}
    size = [W, H]
    whole = {"name": "whole_frame", "polygon": [[0, 0], [W, 0], [W, H], [0, H]]}

    def counted(name: str, want: int, fn):
        """fn() with K1's launches counted; they must equal ``want`` (one per
        frame detected, plus warmup or one per chunk where said)."""
        nms_kernel.launches = 0
        result = fn()
        launches = nms_kernel.launches
        out["launches"][name] = {"launches": launches, "expected": want}
        print(f"  {name}: K1 launches {launches} (expected {want})", flush=True)
        if launches != want:
            fail(f"{name}: K1 launched {launches} times, expected {want}")
        return result

    det = Detector(DetectionConfig(model="yolov8s", num_classes=8, input_size=SIZE,
                                   weights=WEIGHTS, conf_threshold=0.35, iou_threshold=0.45,
                                   classes=None),
                   device=DEVICE, warmup=True, warmup_shape=(H, W))
    srv._singleton.set(det)
    httpd = make_server("127.0.0.1", 0, srv.app, server_class=_ThreadingWSGIServer,
                        handler_class=_QuietHandler)
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    server = threading.Thread(target=httpd.serve_forever, name="smoke-web", daemon=True)
    server.start()
    try:
        # (a) every route over the socket, sequentially
        print(f"  (a) the web app on {base}: rich640d YOLOv8s at {SIZE}, {W}x{H} frames",
              flush=True)
        health = json.loads(_http(base, "GET", "/api/health")[0])
        print(f"  /api/health: {json.dumps(health)}", flush=True)
        if (health["status"] != "ok" or health["backend"] != torch.device(DEVICE).type
                or (DEVICE == "cuda" and torch.cuda.get_device_name(0) not in health["devices"])):
            fail(f"/api/health: {health}")
        samples = json.loads(_http(base, "GET", "/api/samples")[0])["samples"]
        if len(samples) < 3:
            fail(f"/api/samples lists {len(samples)} samples")

        def sample_requests():
            for s in samples:
                data = json.loads(_http(base, "GET", f"/api/detect/sample/{s['filename']}")[0])
                _check_detection(data, data["image_size"], s["filename"])
        counted("serve_samples", len(samples), sample_requests)

        upload = moving_boxes_frame(5, H, W, N_OBJECTS)[0]
        body, ctype = _multipart({"file": ("frame.jpg", _jpeg(upload), "image/jpeg")})
        data = counted("serve_image", 1, lambda: json.loads(
            _http(base, "POST", "/api/detect/image", body, ctype)[0]))
        _check_detection(data, size, "/api/detect/image")
        if data["num_objects"] < N_OBJECTS // 2:
            fail(f"/api/detect/image found {data['num_objects']} of {N_OBJECTS} objects")

        zones = [dict(whole, cooldown_sec=3600)]
        for algo in ("bytetrack", "deepsort"):
            def session(algo=algo):
                ids, n_events, last = set(), 0, None
                for t in range(SERVE_FRAMES):
                    payload = {"image": "data:image/jpeg;base64," + base64.b64encode(
                        _jpeg(moving_boxes_frame(t, H, W, N_OBJECTS)[0])).decode(),
                        "session_id": f"smoke-{algo}", "algorithm": algo}
                    if algo == "bytetrack":
                        payload["zones"] = zones
                    last = json.loads(_http(base, "POST", "/api/detect/frame",
                                            json.dumps(payload).encode(),
                                            "application/json")[0])
                    _check_detection(last, size, f"/api/detect/frame {algo} #{t}")
                    ids |= {tr["track_id"] for tr in last["tracks"]}
                    n_events += len(last.get("events", []))
                return ids, n_events, last
            ids, n_events, last = counted(f"serve_frames_{algo}", SERVE_FRAMES, session)
            print(f"  /api/detect/frame x{SERVE_FRAMES}, {algo}: {len(ids)} ids, "
                  f"{len(last['tracks'])} tracks on the last frame (ages "
                  f"{sorted(tr['age'] for tr in last['tracks'])}), {n_events} zone events",
                  flush=True)
            old = sum(tr["age"] >= SERVE_FRAMES // 2 for tr in last["tracks"])
            if (old < N_OBJECTS // 2 or len(ids) > 2 * N_OBJECTS
                    or (algo == "bytetrack" and n_events == 0)):
                fail(f"/api/detect/frame {algo}: ids do not persist or no zone event")

        clip = os.path.join(OUT_DIR, "serve25.mp4")
        write_synthetic_video(clip, frames=SERVE_CLIP, h=H, w=W, n_objects=N_OBJECTS,
                              fps=LIVE_FPS, seed=6)
        with open(clip, "rb") as f:
            clip_bytes = f.read()
        zone_json = json.dumps([dict(whole, dwell_time_sec=0.5)]).encode()
        for algo in ("bytetrack", "botsort"):
            body, ctype = _multipart({"file": ("clip.mp4", clip_bytes, "video/mp4"),
                                      "zones": ("zones.json", zone_json, "application/json")})
            data = counted(f"serve_track_video_{algo}", SERVE_CLIP, lambda: json.loads(
                _http(base, "POST", f"/api/track/video?algorithm={algo}&max_frames=600",
                      body, ctype)[0]))
            out["times"][f"track_video_{algo}_fps"] = data["processing_fps"]
            print(f"  /api/track/video, {algo}: {data['num_frames']} frames, "
                  f"{data['num_tracks']} tracks, {len(data['events'])} events, zone counts "
                  f"{json.dumps(data['zone_counts'])}; processing_fps {data['processing_fps']} "
                  f"(host clock, {smi})", flush=True)
            if (data["num_frames"] != SERVE_CLIP or data["image_size"] != size
                    or data["video_fps"] != LIVE_FPS or not data["events"]
                    or data["num_tracks"] > 3 * N_OBJECTS
                    or any(e["zone_name"] != "whole_frame" for e in data["events"])):
                fail(f"/api/track/video {algo}: {data['num_frames']} frames, "
                     f"{len(data['events'])} events, {data['num_tracks']} tracks")

        n_demo = int(STREAM_SECONDS * STREAM_FPS)
        content, headers = counted("serve_stream_demo", n_demo, lambda: _http(
            base, "GET", f"/api/stream/demo?seconds={STREAM_SECONDS:g}&fps={STREAM_FPS:g}"))
        parts = _mjpeg_parts(content, b"rtmodtframe")
        if len(parts) != n_demo or {_unjpeg(p).shape for p in parts} != {(480, 640, 3)}:
            fail(f"/api/stream/demo: {len(parts)} parts of {n_demo}")
        print(f"  /api/stream/demo: {len(parts)} MJPEG parts of 640x480 "
              f"({headers.get('Content-Type')})", flush=True)

        body, ctype = _multipart({"file": ("clip.mp4", clip_bytes, "video/mp4")})
        t0 = time.perf_counter()
        content, _ = counted("serve_stream_video", STREAM_VIDEO_FRAMES, lambda: _http(
            base, "POST", f"/api/stream/video?max_frames={STREAM_VIDEO_FRAMES}", body, ctype))
        seconds = time.perf_counter() - t0
        parts = _mjpeg_parts(content, b"rtmodtframe")
        if len(parts) != STREAM_VIDEO_FRAMES or {_unjpeg(p).shape for p in parts} != {(H, W, 3)}:
            fail(f"/api/stream/video: {len(parts)} parts of {STREAM_VIDEO_FRAMES}")
        out["times"]["stream_video_fps"] = len(parts) / seconds
        print(f"  /api/stream/video: {len(parts)} annotated parts of {W}x{H} in "
              f"{seconds:.3f} s: {len(parts) / seconds:.2f} frames/s (host clock, {smi})",
              flush=True)

        # (c) K1 at B = 1 on a served frame's own candidates
        served = _unjpeg(_jpeg(upload))        # the frame the server decoded
        boxes, scores, diff = _k1_at_b1(det, served, packed=False)
        out["mismatches"] += diff
        print(f"  (c) K1 at B=1 on a served frame's candidates: valid "
              f"{int((scores > 0).sum())}, mismatches {diff}", flush=True)
        if diff:
            fail("K1 differs from its plain version on a served frame")
        out["b1"] = k1_times(boxes, scores, det.cfg.iou_threshold, "B=1 (served frame)")

        # (d) + (e) 8-way concurrency against sequential responses, with times
        images = [_jpeg(moving_boxes_frame(3 * t, H, W, N_OBJECTS, seed=t)[0])
                  for t in range(CONC_REQUESTS)]
        bodies = [_multipart({"file": (f"{i}.jpg", img, "image/jpeg")}) for i, img in
                  enumerate(images)]

        def detect(i: int) -> tuple[dict, float]:
            t0 = time.perf_counter()
            data = json.loads(_http(base, "POST", "/api/detect/image", *bodies[i])[0])
            return data, (time.perf_counter() - t0) * 1e3

        want = [detect(i)[0] for i in range(CONC_REQUESTS)]
        seq_ms = []
        t0 = time.perf_counter()
        for rep in range(CONC_THREADS):
            for i in range(CONC_REQUESTS):
                seq_ms.append(detect(i)[1])
        seq_s = time.perf_counter() - t0
        got: list = []
        errors: list = []
        lock = threading.Lock()

        def client(k: int) -> None:
            try:
                for j in range(CONC_REQUESTS):
                    i = (j + k) % CONC_REQUESTS
                    data, ms = detect(i)
                    with lock:
                        got.append((i, data, ms))
            except BaseException as e:   # noqa: BLE001 - reported below, fails the phase
                with lock:
                    errors.append(f"client {k}: {type(e).__name__}: {e}")

        clients = [threading.Thread(target=client, args=(k,)) for k in range(CONC_THREADS)]
        t0 = time.perf_counter()
        for c in clients:
            c.start()
        for c in clients:
            c.join(timeout=600)
        par_s = time.perf_counter() - t0
        if errors or any(c.is_alive() for c in clients) or len(got) != CONC_THREADS * CONC_REQUESTS:
            fail(f"(d) concurrent clients: {errors[:3]} ({len(got)} responses)")
        gap = score_gap = 0.0
        for i, data, _ in got:
            w_ = want[i]
            if ([d["class_id"] for d in data["detections"]]
                    != [d["class_id"] for d in w_["detections"]]):
                fail(f"(d) image {i}: concurrent classes differ from the sequential response")
            if data["detections"]:
                gap = max(gap, float(np.abs(np.array([d["bbox"] for d in data["detections"]])
                                            - np.array([d["bbox"] for d in w_["detections"]]))
                                     .max()))
                score_gap = max(score_gap, max(abs(a["confidence"] - b["confidence"]) for a, b
                                               in zip(data["detections"], w_["detections"])))
        par_ms = [ms for _, _, ms in got]
        n_req = CONC_THREADS * CONC_REQUESTS
        out["times"]["detect_image"] = {
            "seq_p50_ms": float(np.percentile(seq_ms, 50)),
            "seq_p95_ms": float(np.percentile(seq_ms, 95)), "seq_rps": n_req / seq_s,
            "par_p50_ms": float(np.percentile(par_ms, 50)),
            "par_p95_ms": float(np.percentile(par_ms, 95)), "par_rps": n_req / par_s}
        tm = out["times"]["detect_image"]
        out["concurrency"] = {"box_gap_px": gap, "score_gap": score_gap}
        print(f"  (d) {CONC_THREADS} threads x {CONC_REQUESTS} /api/detect/image: counts and "
              f"classes equal the sequential responses; max box gap {gap:.6f} px (tolerance "
              f"{CONC_BOX_TOL}), max score gap {score_gap:.2e}", flush=True)
        print(f"  (e) /api/detect/image {W}x{H} JPEG, host clock ({smi}): sequential p50 "
              f"{tm['seq_p50_ms']:.2f} ms, p95 {tm['seq_p95_ms']:.2f} ms, "
              f"{tm['seq_rps']:.2f} requests/s; {CONC_THREADS}-way p50 {tm['par_p50_ms']:.2f} "
              f"ms, p95 {tm['par_p95_ms']:.2f} ms, {tm['par_rps']:.2f} requests/s", flush=True)
        if gap > CONC_BOX_TOL:
            fail(f"(d) concurrent boxes differ from the sequential ones by {gap} px")

        # why the server runs the device work on one thread: PyTorch keeps
        # cuDNN's execution plans per thread, so a thread's first forward plans
        # every convolution again
        def detect_ms() -> float:
            t0 = time.perf_counter()
            det.detect(served)
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e3

        def on_fresh_thread() -> float:
            res: dict = {}
            th = threading.Thread(target=lambda: res.setdefault("ms", detect_ms()))
            th.start()
            th.join(timeout=120)
            return res["ms"]

        same = [detect_ms() for _ in range(5)]
        fresh = [on_fresh_thread() for _ in range(5)]
        out["times"]["detect_thread"] = {"same_ms": float(np.median(same)),
                                         "fresh_ms": float(np.median(fresh))}
        print(f"  (e) Detector.detect of a served {W}x{H} frame, host clock with a sync: "
              f"{np.median(same):.2f} ms on a thread that ran it before, "
              f"{np.median(fresh):.2f} ms on a fresh thread each call (median of 5)",
              flush=True)

        # (b) the default build: RTMODT_WEIGHTS unset -> random-init 80-class YOLOv8s
        os.environ.pop("RTMODT_WEIGHTS", None)
        srv._singleton.set(None)
        data = counted("serve_default_build", 1, lambda: json.loads(_http(
            base, "GET", f"/api/detect/sample/{samples[0]['filename']}")[0]))
        built = srv._singleton.loaded()
        print(f"  (b) default build: {built.cfg.model}, {built.cfg.num_classes} classes on "
              f"{built.device}; {data['num_objects']} detections (random weights)", flush=True)
        if (built is None or built.device.type != torch.device(DEVICE).type
                or built.cfg.num_classes != 80
                or next(built.model.parameters()).device.type != torch.device(DEVICE).type):
            fail("(b) the default detector was not built on the card")
        srv._singleton.set(det)
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.join(timeout=10)

    # (f) the monitor behind Pipeline.run, MultiStreamPipeline.run and the CLI
    opened: list = []
    inner_monitor = monitor_mod.LiveMonitor

    class Watched(inner_monitor):
        """The pipelines' monitor, held until the viewer thread is attached
        so that the viewer sees the run from its first frame."""

        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            opened.append(self)
            deadline = time.monotonic() + 60.0
            while self._viewers == 0:
                if time.monotonic() > deadline:
                    fail("(f) no viewer attached to the monitor")
                time.sleep(0.01)

    base_cfg = {"system": {"device": DEVICE, "log_dir": os.path.join(OUT_DIR, "logs")},
                "detection": {"model": "yolov8s", "input_size": SIZE, "num_classes": 8,
                              "weights": WEIGHTS},
                "events": {"enabled": False},
                "profiling": {"warmup_frames": 4, "log_interval": 0},
                "visualization": {"enabled": False, "mjpeg_port": 0}}
    monitor_mod.LiveMonitor = Watched
    try:
        for label, name, make, run, shape, launches in (
                ("Pipeline.run per stage", "monitor_pipeline_run",
                 lambda: Pipeline(load_config(overrides=_merge(base_cfg, {
                     "profiling": {"per_stage": True}}))),
                 lambda p: p.run(clip), (H, W, 3), SERVE_CLIP + WARMUP_ITERS),
                ("MultiStreamPipeline.run, S = 2", "monitor_multistream_run",
                 lambda: MultiStreamPipeline(load_config(overrides=_merge(base_cfg, {
                     "visualization": {"enabled": True},
                     "parallel": {"num_streams": 2, "chunk_size": T_MULTI}}))),
                 lambda p: p.run([clip, clip]), (H, 2 * W, 3), SERVE_CLIP // T_MULTI)):
            print(f"  (f) {label} with visualization.mjpeg_port 0 on {os.path.basename(clip)}",
                  flush=True)
            opened.clear()
            pipe = make()
            if isinstance(pipe, MultiStreamPipeline):
                pipe.warmup((H, W), T_MULTI)
            watch: dict = {}
            reader = threading.Thread(target=_watch_monitor,
                                      args=(opened, MONITOR_PARTS, watch))
            reader.start()
            torch.cuda.synchronize()
            summary = counted(name, launches, lambda: run(pipe))
            reader.join(timeout=120)
            m = opened[0] if opened else None
            print(f"  monitor: /frame {watch.get('frame')}, /stream {watch.get('distinct')} "
                  f"distinct parts of {watch.get('shapes')}; {m and m._seq} frames "
                  f"published, closed {m and m._closed}; run fps "
                  f"{summary.get('fps_mean', summary.get('fps_aggregate'))}", flush=True)
            if (reader.is_alive() or "error" in watch or watch.get("frame") != shape
                    or watch.get("shapes") != [shape]
                    or watch.get("distinct", 0) < MONITOR_PARTS
                    or m is None or not m._closed or m._seq != SERVE_CLIP):
                fail(f"(f) {label}: monitor {watch}")
            del pipe
            torch.cuda.empty_cache()
    finally:
        monitor_mod.LiveMonitor = inner_monitor

    cli_cfg = os.path.join(OUT_DIR, "cli_monitor.yaml")
    with open(cli_cfg, "w") as f:
        json.dump(_merge(base_cfg, {"visualization": {"mjpeg_port": None},
                                    "profiling": {"per_stage": True}}), f)
    print("  (f) tools/run_pipeline_torch.py --mjpeg-port 0 as a subprocess", flush=True)
    proc, launches, seconds = _counted_subprocess(
        "tools.run_pipeline_torch", ["-c", cli_cfg, "-s", clip, "--mjpeg-port", "0"])
    line = next((ln for ln in proc.stderr.splitlines() if "live monitor on http://" in ln), None)
    out["launches"]["monitor_cli"] = {"launches": launches, "frames": SERVE_CLIP}
    print(f"  CLI exit 0 in {seconds:.1f} s; {line and line.split('|')[-1].strip()}; K1 "
          f"launches {launches} for {SERVE_CLIP} frames + {WARMUP_ITERS} warmup", flush=True)
    if line is None or launches != SERVE_CLIP + WARMUP_ITERS:
        fail(f"the CLI with --mjpeg-port: monitor line {line!r}, K1 launches {launches}")

    # (g) tools/run_inference_torch.py detect and track
    dev_flag = [] if DEVICE == "cuda" else ["--cpu"]
    png_fast = [int(cv2.IMWRITE_PNG_COMPRESSION), 1]
    img_dir = os.path.join(OUT_DIR, "ri_detect")
    os.makedirs(img_dir, exist_ok=True)
    coco = {"images": [], "annotations": [],
            "categories": [{"id": c + 1, "name": str(c)} for c in range(8)]}
    for t in range(RI_IMAGES):
        frame, gt_boxes, labels, _ = dense_moving_scene(7 * t, H, W, n_objects=RI_OBJECTS,
                                                        seed=DENSE_SEED)
        cv2.imwrite(os.path.join(img_dir, f"{t + 1:06d}.png"), frame, png_fast)
        coco["images"].append({"id": t + 1, "file_name": f"{t + 1:06d}.png"})
        for (x1, y1, x2, y2), c in zip(gt_boxes, labels):
            coco["annotations"].append({
                "id": len(coco["annotations"]) + 1, "image_id": t + 1, "category_id": int(c) + 1,
                "bbox": [float(x1), float(y1), float(x2 - x1), float(y2 - y1)], "iscrowd": 0})
    gt_json = os.path.join(OUT_DIR, "ri_gt.json")
    with open(gt_json, "w") as f:
        json.dump(coco, f)
    print(f"  (g) run_inference_torch detect --evaluate: {RI_IMAGES} {W}x{H} frames, "
          f"{len(coco['annotations'])} GT boxes", flush=True)
    proc, launches, seconds = _counted_subprocess("tools.run_inference_torch", [
        "detect", "--images", img_dir, "--gt-json", gt_json, "--weights", WEIGHTS,
        "--num-classes", "8", "--input-size", str(SIZE), "--evaluate",
        "--out", os.path.join(OUT_DIR, "ri_predictions.json"), *dev_flag])
    m_det = json.loads("\n".join(proc.stdout.strip().splitlines()[:-1]))
    out["launches"]["run_inference_detect"] = {"launches": launches, "frames": RI_IMAGES}
    out["detect_eval"] = m_det
    print(f"  detect: {json.dumps(m_det)} ({seconds:.1f} s, K1 launches {launches})", flush=True)
    if launches != RI_IMAGES or not m_det["mAP"] > 0.3:
        fail(f"run_inference_torch detect: mAP {m_det['mAP']}, K1 launches {launches}")
    # K1 on this path's own shape: the tool's detector (conf 0.001, K = 1000)
    # on the frames it read, bit-equal to the plain version
    tool_det = Detector(DetectionConfig(model="yolov8s", weights=WEIGHTS, num_classes=8,
                                        input_size=SIZE, conf_threshold=0.001, classes=None,
                                        max_detections=300, nms_candidates=1000),
                        device=DEVICE, warmup=False)
    diff, valid = 0, []
    for img in coco["images"]:
        boxes, scores, d = _k1_at_b1(
            tool_det, cv2.imread(os.path.join(img_dir, img["file_name"])), packed=False)
        diff += d
        valid.append(int((scores > 0).sum()))
    out["mismatches"] += diff
    print(f"  K1 at B=1 on the detect frames' candidates (K = {scores.shape[1]}): valid "
          f"{valid}, mismatches {diff}", flush=True)
    if diff:
        fail("K1 differs from its plain version on run_inference_torch detect's frames")
    out["b1_detect"] = k1_times(boxes, scores, tool_det.cfg.iou_threshold,
                                "B=1 (run_inference detect, last frame)")
    del tool_det
    torch.cuda.empty_cache()

    seq_dir = os.path.join(OUT_DIR, "ri_dense")
    os.makedirs(seq_dir, exist_ok=True)
    gt_rows = []
    for t in range(DENSE_FRAMES):
        frame, gt_boxes, _, ids = dense_moving_scene(t, H, W, n_objects=DENSE_OBJECTS,
                                                     seed=DENSE_SEED)
        cv2.imwrite(os.path.join(seq_dir, f"{t + 1:06d}.png"), frame, png_fast)
        gt_rows += [(t + 1, int(i) + 1, x1, y1, x2 - x1, y2 - y1, 1.0)
                    for (x1, y1, x2, y2), i in zip(gt_boxes, ids)]
    gt_mot = os.path.join(OUT_DIR, "ri_dense_gt.txt")
    write_mot_rows(gt_mot, gt_rows)
    out["track_eval"] = {}
    for gap in (0, 20):
        print(f"  (g) run_inference_torch track --gt-mot: dense scene seed {DENSE_SEED}, "
              f"{DENSE_OBJECTS} objects, {DENSE_FRAMES} frames, --interpolate {gap}", flush=True)
        proc, launches, seconds = _counted_subprocess("tools.run_inference_torch", [
            "track", "--video", seq_dir, "--gt-mot", gt_mot, "--weights", WEIGHTS,
            "--num-classes", "8", "--input-size", str(SIZE), "--track-thresh", "0.3",
            "--interpolate", str(gap), "--out", os.path.join(OUT_DIR, f"ri_tracks{gap}.txt"),
            *dev_flag])
        q = json.loads("\n".join(proc.stdout.strip().splitlines()[:-1]))
        out["launches"][f"run_inference_track_i{gap}"] = {"launches": launches,
                                                          "frames": DENSE_FRAMES}
        out["track_eval"][gap] = q
        print(f"  track --interpolate {gap}: IDF1 {q['idf1']:.4f}, MOTA {q['mota']:.4f}, "
              f"ID switches {q['num_switches']}, HOTA {q['hota']:.4f} ({seconds:.1f} s, K1 "
              f"launches {launches}); phase 6 (d)'s per-stage run: IDF1 "
              f"{dense_q['idf1']:.4f}, switches {dense_q['num_switches']}", flush=True)
        if launches != DENSE_FRAMES or q["idf1"] < IDF1_FLOOR:
            fail(f"run_inference_torch track: IDF1 {q['idf1']}, K1 launches {launches}")
    return out


def _event_rows(path: str) -> list[dict]:
    """A zone-event JSONL without the wall-clock ``timestamp_utc``."""
    if not os.path.exists(path):
        return []
    with open(path) as f:
        rows = [json.loads(line) for line in f]
    for r in rows:
        r.pop("timestamp_utc")
    return rows


def _same_events(got_log: str, want_log: str, what: str) -> int:
    """Fail unless the two logs hold the same events (``bbox_xyxy`` within
    RESUME_BOX_TOL px); returns their number."""
    got, want = _event_rows(got_log), _event_rows(want_log)
    if not want:
        fail(f"{what}: the uninterrupted run wrote no event")
    gap = 0.0
    if len(got) == len(want):
        gap = max(float(np.abs(np.subtract(g.pop("bbox_xyxy"), w.pop("bbox_xyxy"))).max())
                  for g, w in zip(got, want))
    if len(got) != len(want) or got != want or gap > RESUME_BOX_TOL:
        fail(f"{what}: {len(got)} events against the uninterrupted run's {len(want)} "
             f"(box gap {gap})")
    return len(want)


def _fresh(*paths: str) -> None:
    for p in paths:
        if os.path.exists(p):
            os.remove(p)


def _cli_child(argv: list[str], saves: str) -> str:
    """Child code that runs the CLI's ``main(argv)``.  Each time the pipeline
    writes a snapshot it first records K1's launch count under that
    snapshot's ``frames_done`` in ``saves`` (so a child killed after a
    snapshot has left that snapshot's count there); when it exits it prints
    the count and the wall time of its first consumed frame."""
    return (f"import json, os, sys, time\nsys.path.insert(0, {ROOT!r})\n"
            "from rtmodt_tpu_torch.events import zone_engine\n"
            "from rtmodt_tpu_torch.ops import nms_kernel\n"
            "from rtmodt_tpu_torch.runtime import pipeline\n"
            "from tools.run_pipeline_torch import main\n"
            "first = []\ninner = zone_engine.ZoneEventEngine.process_chunk\n"
            "def process_chunk(self, *a, **k):\n"
            "    first.append(first[0] if first else time.time())\n"
            "    return inner(self, *a, **k)\n"
            "zone_engine.ZoneEventEngine.process_chunk = process_chunk\n"
            "counts = {}\ninner_save = pipeline.Pipeline.save_runtime_state\n"
            "def save_runtime_state(self, path, frames_done=0, last_ts=0.0):\n"
            "    counts[str(int(frames_done))] = nms_kernel.launches\n"
            f"    with open({saves + '.tmp'!r}, 'w') as f:\n"
            "        json.dump(counts, f)\n"
            f"    os.replace({saves + '.tmp'!r}, {saves!r})\n"
            "    return inner_save(self, path, frames_done, last_ts)\n"
            "pipeline.Pipeline.save_runtime_state = save_runtime_state\n"
            f"rc = main({argv!r})\n"
            "print(json.dumps({'k1_launches': nms_kernel.launches,\n"
            "                  'first_frame': first[0] if first else None}), flush=True)\n"
            "sys.exit(rc)\n")


def resume_paths(smi: str) -> dict:
    """Phase 10: kill-and-resume on the chunked, per-stage and multi-stream
    paths and through a killed CLI, device zone masks, the x6 / x24 / bgr
    transports.  Every resumed run must write the uninterrupted run's events.
    Returns K1's launches per run and its mismatches."""
    import signal

    from rtmodt_tpu_torch.config import load_config
    from rtmodt_tpu_torch.config.loader import DEFAULTS
    from rtmodt_tpu_torch.config.loader import _deep_merge as _merge
    from rtmodt_tpu_torch.ops import nms_kernel
    from rtmodt_tpu_torch.ops.polygon import points_in_polygons
    from rtmodt_tpu_torch.ops.yuv import pack_chunk, planes_to_x6, planes_to_x24
    from rtmodt_tpu_torch.parallel.multistream import MultiStreamPipeline
    from rtmodt_tpu_torch.runtime.pipeline import Pipeline
    from rtmodt_tpu_torch.utils.synthetic import write_synthetic_video

    out: dict = {"launches": {}, "mismatches": 0}
    whole = {"name": "whole_frame", "polygon": [[0, 0], [W, 0], [W, H], [0, H]],
             "trigger": "intrusion", "dwell_time_sec": 0.5, "cooldown_sec": 2.0}
    zones = DEFAULTS["events"]["zones"] + [whole]
    base = {"system": {"device": DEVICE, "log_dir": os.path.join(OUT_DIR, "logs")},
            "detection": {"model": "yolov8s", "input_size": SIZE, "num_classes": 8,
                          "weights": WEIGHTS},
            "profiling": {"warmup_frames": 0, "log_interval": 0},
            "visualization": {"enabled": False},
            "parallel": {"chunk_size": K}}

    def cfg_for(log: str, **over):
        return load_config(overrides=_merge(_merge(base, over), {
            "events": {"zones": zones, "alert": {"log_path": log}}}))

    def counted(name: str, frames: int, fn):
        torch.cuda.synchronize()
        nms_kernel.launches = 0
        result = fn()
        torch.cuda.synchronize()
        out["launches"][name] = {"launches": nms_kernel.launches, "frames": frames}
        return result, nms_kernel.launches

    clip = os.path.join(OUT_DIR, "resume720.mp4")
    write_synthetic_video(clip, frames=RESUME_FRAMES, h=H, w=W, n_objects=N_OBJECTS,
                          fps=LIVE_FPS, seed=11)
    half = RESUME_FRAMES // 2
    chunk_cfg = {"profiling": {"per_stage": False}}

    # (a) the chunked path: uninterrupted, then half + a fresh pipeline
    print(f"  (a) run_chunked resume: {RESUME_FRAMES} frames of {W}x{H} at {LIVE_FPS:g} fps, "
          f"K = {K}, state_interval {RESUME_INTERVAL}", flush=True)
    logs = {n: os.path.join(OUT_DIR, f"resume_{n}.jsonl") for n in ("whole", "cut", "masks",
                                                                      "bgr")}
    snap = os.path.join(OUT_DIR, "resume_state.npz")
    _fresh(*logs.values(), snap)
    pipe = Pipeline(cfg_for(logs["whole"], **chunk_cfg))
    pipe.run_chunked(clip, max_frames=2 * K)              # warm-up: cuDNN plans
    pipe.reset()
    _fresh(logs["whole"])
    whole_summary, _ = counted("resume_chunk_whole", RESUME_FRAMES,
                               lambda: pipe.run_chunked(clip))
    whole_counts = pipe.events.zone_counts()
    first = Pipeline(cfg_for(logs["cut"], **chunk_cfg))
    counted("resume_chunk_first_half", half, lambda: first.run_chunked(
        clip, max_frames=half, state_path=snap, state_interval=RESUME_INTERVAL))
    save_ms = []
    timing = snap[:-len(".npz")] + "_timing.npz"
    for _ in range(5):      # the same snapshot again, to another path
        t0 = time.perf_counter()
        first.save_runtime_state(timing, half, (half - 1) / LIVE_FPS)
        save_ms.append((time.perf_counter() - t0) * 1e3)
    _fresh(timing)
    nbytes = os.path.getsize(snap)
    resumed = Pipeline(cfg_for(logs["cut"], **chunk_cfg))
    t0 = time.perf_counter()
    skip = resumed.load_runtime_state(snap)
    load_ms = (time.perf_counter() - t0) * 1e3
    if skip != half:
        fail(f"the chunked snapshot holds frames_done {skip}, not {half}")
    summary, launches = counted("resume_chunk_resumed", RESUME_FRAMES - half, lambda:
                                resumed.run_chunked(clip, state_path=snap, skip_frames=skip))
    n_ev = _same_events(logs["cut"], logs["whole"], "chunked resume")
    if resumed.events.zone_counts() != whole_counts or launches != summary["chunks"]:
        fail(f"chunked resume: zone counts {resumed.events.zone_counts()} against "
             f"{whole_counts}; K1 launches {launches} for {summary['chunks']} chunks")
    out["snapshot"] = {"bytes": nbytes, "save_ms": float(np.median(save_ms)),
                       "load_ms": load_ms}
    print(f"  chunked resume: {n_ev} events equal to the uninterrupted run's, zone counts "
          f"{json.dumps(whole_counts)}; snapshot {nbytes} bytes, save "
          f"{out['snapshot']['save_ms']:.3f} ms (median of 5), load {load_ms:.3f} ms "
          f"(host clock); uninterrupted e2e {whole_summary['fps']:.2f} frames/s", flush=True)
    # K1 on the first resumed chunk's real candidates
    import cv2

    cap = cv2.VideoCapture(clip)
    frames = [cap.read()[1] for _ in range(half + K)][half:]
    cap.release()
    planes, meta = pack_chunk(np.stack(frames), SIZE)
    dev_planes = tuple(torch.from_numpy(p).to(DEVICE) for p in planes)
    _, cs, diff = _k1_chunk(resumed, dev_planes, meta)
    out["mismatches"] += diff
    print(f"  K1 on the first resumed chunk's candidates (B={K}): valid "
          f"{int((cs > 0).sum())}, mismatches {diff}", flush=True)
    if diff:
        fail("K1 differs from its plain version on a resumed chunk")

    # (b) the per-stage path, where the reference's warmup wipes the restored state
    n_live = RESUME_LIVE_FRAMES
    print(f"  (b) Pipeline.run per stage: resume at {n_live // 2} of {n_live} frames", flush=True)
    stage = {"profiling": {"per_stage": True}}
    slog, scut, ssnap = (os.path.join(OUT_DIR, n) for n in (
        "resume_stage_whole.jsonl", "resume_stage_cut.jsonl", "resume_stage.npz"))
    _fresh(slog, scut, ssnap)
    p_whole = Pipeline(cfg_for(slog, **stage))
    counted("resume_stage_whole", n_live, lambda: p_whole.run(clip, max_frames=n_live))
    p1 = Pipeline(cfg_for(scut, **stage))
    counted("resume_stage_first_half", n_live // 2, lambda: p1.run(
        clip, max_frames=n_live // 2, state_path=ssnap, state_interval=RESUME_LIVE_INTERVAL))
    p2 = Pipeline(cfg_for(scut, **stage))
    skip = p2.load_runtime_state(ssnap)
    restored_ids = int(p2.tracker.state.next_id)
    _, launches = counted("resume_stage_resumed", n_live - skip, lambda: p2.run(
        clip, max_frames=n_live - skip, state_path=ssnap, skip_frames=skip))
    n_ev = _same_events(scut, slog, "per-stage resume")
    if p2.events.zone_counts() != p_whole.events.zone_counts():
        fail("per-stage resume: zone counts differ from the uninterrupted run's")
    if launches != n_live - skip + WARMUP_ITERS:
        fail(f"per-stage resume: K1 launched {launches} times for {n_live - skip} frames")
    print(f"  per-stage resume at frame {skip} (next_id {restored_ids} restored and kept "
          f"through warmup): {n_ev} events equal", flush=True)

    # (c) a real kill: the CLI as a subprocess, SIGKILL after its first snapshot
    print(f"  (c) the CLI killed after its first snapshot and started again "
          f"(--state-interval {CLI_KILL_INTERVAL}, {CLI_KILL_FRAMES} frames)", flush=True)
    kclip = os.path.join(OUT_DIR, "resume_cli720.mp4")
    write_synthetic_video(kclip, frames=CLI_KILL_FRAMES, h=H, w=W, n_objects=N_OBJECTS,
                          fps=LIVE_FPS, seed=12)
    klog, kwhole, ksnap, kwsnap, saves = (os.path.join(OUT_DIR, n) for n in (
        "resume_cli.jsonl", "resume_cli_whole.jsonl", "resume_cli.npz",
        "resume_cli_whole.npz", "resume_cli_saves.json"))
    _fresh(klog, kwhole, ksnap, kwsnap, saves)

    def cli_cfg(log: str) -> str:
        path = log[:-len(".jsonl")] + ".yaml"
        with open(path, "w") as f:
            json.dump(_merge(_merge(base, chunk_cfg), {
                "events": {"zones": zones, "alert": {"log_path": log}}}), f)
        return path

    def argv(log: str, state: str) -> list[str]:
        return ["-c", cli_cfg(log), "-s", kclip, "--resume-state", state,
                "--state-interval", str(CLI_KILL_INTERVAL)]

    def finish(proc, what: str) -> dict:
        stdout, stderr = proc.communicate(timeout=600)
        if proc.returncode != 0:
            print(stdout[-3000:], "\n", stderr[-3000:], file=sys.stderr)
            fail(f"{what}: the CLI exited {proc.returncode}")
        return json.loads(stdout.strip().splitlines()[-1])

    def spawn(args: list[str]):
        return subprocess.Popen([sys.executable, "-c", _cli_child(args, saves)], cwd=ROOT,
                                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

    r = finish(spawn(argv(kwhole, kwsnap)), "uninterrupted CLI")
    whole_launches = r["k1_launches"]
    if whole_launches != CLI_KILL_FRAMES // K:
        fail(f"uninterrupted CLI: K1 launched {whole_launches} times for "
             f"{CLI_KILL_FRAMES // K} chunks")
    out["launches"]["resume_cli_whole"] = {"launches": whole_launches,
                                           "frames": CLI_KILL_FRAMES}
    _fresh(saves)
    t_spawn = time.time()
    proc = spawn(argv(klog, ksnap))
    deadline = time.perf_counter() + 600
    while not os.path.exists(ksnap):
        if proc.poll() is not None or time.perf_counter() > deadline:
            proc.kill()
            fail("the CLI ended before its first snapshot")
        time.sleep(0.02)
    proc.send_signal(signal.SIGKILL)
    proc.communicate(timeout=60)
    if proc.returncode != -signal.SIGKILL:
        fail(f"the killed CLI exited {proc.returncode}, not by SIGKILL")
    with np.load(ksnap) as z:
        kmeta = json.loads(str(z["meta"]))
    at, offset = kmeta["frames_done"], kmeta["events"]["log_offset"]
    with open(saves) as f:
        # K1's count when the snapshot that survived the kill was written
        killed = json.load(f).get(str(at))
    if killed != at // K:
        fail(f"the killed CLI's snapshot at frame {at} was written after {killed} K1 "
             f"launches, not {at // K} (one a chunk, the window drained)")
    size = os.path.getsize(klog) if os.path.exists(klog) else 0
    if at >= CLI_KILL_FRAMES or offset > size:
        fail(f"the kill came too late: snapshot at frame {at}, log offset {offset} of {size}")
    with open(klog, "ab") as f:      # a consumer drops what follows the snapshot
        f.truncate(offset)
    out["launches"]["resume_cli_killed"] = {"launches": killed, "frames": at,
                                            "note": "at the snapshot that survived"}
    _fresh(saves)
    t_restart = time.time()
    r = finish(spawn(argv(klog, ksnap)), "restarted CLI")
    if killed + r["k1_launches"] != whole_launches:
        fail(f"K1 launched {killed} times up to the snapshot and {r['k1_launches']} after "
             f"the restart, against {whole_launches} in the uninterrupted CLI")
    out["launches"]["resume_cli_restarted"] = {"launches": r["k1_launches"],
                                               "frames": CLI_KILL_FRAMES - at}
    restart_s = r["first_frame"] - t_restart
    n_ev = _same_events(klog, kwhole, "killed and restarted CLI")
    with np.load(ksnap) as z:
        end = json.loads(str(z["meta"]))["frames_done"]
    if end != CLI_KILL_FRAMES:
        fail(f"the restarted CLI's last snapshot holds frames_done {end}")
    out["restart_s"] = restart_s
    print(f"  killed (SIGKILL) {time.time() - t_spawn:.1f} s after the start, snapshot at "
          f"frame {at}, log cut at {offset} of {size} bytes; restart to first resumed frame "
          f"{restart_s:.2f} s (host clock, process start included); {n_ev} events equal to "
          f"the uninterrupted CLI's", flush=True)

    # (d) several streams: half, then resume; per_stream_frames counts on
    print(f"  (d) MultiStreamPipeline.run resume: S = {S_STREAMS}, T = {T_MULTI}, "
          f"{N_MULTI} frames a stream, resume at {N_MULTI // 2}", flush=True)
    files = [os.path.join(OUT_DIR, f"resume_multi{si}.mp4") for si in range(S_STREAMS)]
    for si, path in enumerate(files):
        _write_clip(path, N_MULTI, H, W, 37 * si)
    mlog, mcut, msnap = (os.path.join(OUT_DIR, n) for n in (
        "resume_multi_whole.jsonl", "resume_multi_cut.jsonl", "resume_multi.npz"))
    _fresh(mlog, mcut, msnap)
    mcfg = {"parallel": {"chunk_size": T_MULTI, "pipeline_depth": MULTI_DEPTH,
                         "num_streams": S_STREAMS}}
    m_whole = MultiStreamPipeline(cfg_for(mlog, **mcfg))
    want, _ = counted("resume_multi_whole", S_STREAMS * N_MULTI, lambda: m_whole.run(files))
    m1 = MultiStreamPipeline(cfg_for(mcut, **mcfg))
    counted("resume_multi_first_half", S_STREAMS * N_MULTI // 2, lambda: m1.run(
        files, max_frames=N_MULTI // 2, state_path=msnap,
        state_interval=S_STREAMS * T_MULTI * 2))
    m2 = MultiStreamPipeline(cfg_for(mcut, **mcfg))
    got, launches = counted("resume_multi_resumed", S_STREAMS * N_MULTI // 2,
                            lambda: m2.run(files, state_path=msnap))
    rows = {n: _event_rows(p) for n, p in (("want", mlog), ("got", mcut))}
    for si in range(S_STREAMS):
        per = {n: [e for e in r if e["metadata"]["stream"] == si] for n, r in rows.items()}
        if len(per["got"]) != len(per["want"]) or any(
                {k: v for k, v in g.items() if k != "bbox_xyxy"}
                != {k: v for k, v in w.items() if k != "bbox_xyxy"}
                or np.abs(np.subtract(g["bbox_xyxy"], w["bbox_xyxy"])).max() > RESUME_BOX_TOL
                for g, w in zip(per["got"], per["want"])):
            fail(f"multi-stream resume: stream {si}'s events differ")
    if (got["per_stream_frames"] != [N_MULTI] * S_STREAMS
            or got["zone_counts"] != want["zone_counts"] or launches == 0):
        fail(f"multi-stream resume: per_stream_frames {got['per_stream_frames']}, zone counts "
             f"equal {got['zone_counts'] == want['zone_counts']}, K1 launches {launches}")
    print(f"  multi-stream resume: per_stream_frames {got['per_stream_frames']}; events per "
          f"stream equal ({len(rows['want'])} in all)", flush=True)

    # (e) device zone masks on run_chunked
    print("  (e) run_chunked with events.device_masks", flush=True)
    mpipe = Pipeline(cfg_for(logs["masks"], **chunk_cfg, events={"device_masks": True}))
    seen = []
    inner_mask = mpipe.mask_chunk

    def mask_chunk(boxes):
        m = inner_mask(boxes)
        seen.append((boxes.cpu(), m.cpu()))
        return m

    mpipe.mask_chunk = mask_chunk
    counted("masks_chunk", RESUME_FRAMES, lambda: mpipe.run_chunked(clip))
    n_ev = _same_events(logs["masks"], logs["whole"], "device masks")
    polys = mpipe._mask_polys.cpu()
    mask_diff = 0
    for boxes, m in seen:
        cents = (boxes[..., 0:2] + boxes[..., 2:4]) * 0.5
        want_m = points_in_polygons(cents.reshape(-1, 2), polys).reshape(m.shape)
        mask_diff += int((want_m != m).sum())
    boxes_dev = seen[-1][0].to(DEVICE)
    mask_ms = cuda_time_ms(lambda: inner_mask(boxes_dev), iters=50)
    out["mask_ms"] = mask_ms
    print(f"  device masks: {n_ev} events equal to the host masks' run; masks of {len(seen)} "
          f"chunks ({tuple(seen[-1][1].shape)}) against points_in_polygons on the CPU: "
          f"{mask_diff} differ; mask step {mask_ms:.4f} ms per chunk (CUDA events)", flush=True)
    if mask_diff:
        fail(f"device masks differ from the CPU's in {mask_diff} places")

    # (f) transports: planes, x6 and x24 give bit-equal tracks; bgr runs
    print("  (f) transports: planes, x6, x24 (submit_packed_yuv, submit_chunk_packed); "
          "bgr through run_chunked", flush=True)
    tpipe = Pipeline(cfg_for(os.path.join(OUT_DIR, "resume_transport.jsonl"), **chunk_cfg))
    y, u, v = planes
    results = {}
    for name, arg in (("planes", (y, u, v)), ("x6", planes_to_x6(y, u, v)),
                      ("x24", planes_to_x24(y, u, v))):
        tpipe.reset()
        results[name], _ = counted(f"transport_{name}", K, lambda arg=arg: tpipe.submit_packed_yuv(
            arg, H, W))
    for name in ("x6", "x24"):
        if not all(torch.equal(a, b) for a, b in zip(results[name][0], results["planes"][0])):
            fail(f"submit_packed_yuv: the {name} chunk's tracks differ from the planes'")
    clips = _read_clips(files, T_MULTI)                     # (T, S, H, W, 3)
    mplanes, _ = pack_chunk(clips.reshape(-1, H, W, 3), SIZE)
    ts_planes = tuple(p.reshape(T_MULTI, S_STREAMS, *p.shape[1:]) for p in mplanes)
    x6 = planes_to_x6(*mplanes).reshape(T_MULTI, S_STREAMS, *ts_planes[1].shape[2:], 6)
    mres = {}
    for name, arg in (("planes", ts_planes), ("x6", x6)):
        m2.reset()
        mres[name], _ = counted(f"transport_multi_{name}", T_MULTI * S_STREAMS,
                                lambda arg=arg: m2.submit_chunk_packed(arg, H, W))
    if not all(torch.equal(a, b) for a, b in zip(mres["x6"][0], mres["planes"][0])):
        fail("submit_chunk_packed: the x6 chunk's tracks differ from the planes'")
    bpipe = Pipeline(cfg_for(logs["bgr"], **chunk_cfg, parallel={"transport": "bgr"}))
    bsum, launches = counted("transport_bgr_chunk", RESUME_FRAMES,
                             lambda: bpipe.run_chunked(clip))
    st = bpipe.tracker.state
    vis_end, births = int((st.active & (st.tsu == 0)).sum()), int(st.next_id) - 1
    n_bgr = len(_event_rows(logs["bgr"]))
    print(f"  x6 and x24 tracks bit-equal to the planes' ({int(results['planes'][0].visible.sum())}"
          f" visible slots), multi-stream x6 too; bgr run_chunked {bsum['fps']:.2f} frames/s, "
          f"{n_bgr} events, {vis_end} visible at the end, {births} ids, K1 launches {launches} "
          f"for {bsum['chunks']} chunks", flush=True)
    if launches != bsum["chunks"] or n_bgr == 0 or vis_end < N_OBJECTS // 2:
        fail(f"bgr transport: K1 {launches} for {bsum['chunks']} chunks, {n_bgr} events, "
             f"{vis_end} visible")
    return out


class _Broker:
    """An MQTT broker for one client on localhost: CONNACK after CONNECT,
    every PUBLISH kept as (topic, payload) until the client disconnects."""

    def __init__(self):
        import socket
        import threading

        self.srv = socket.socket()
        self.srv.bind(("127.0.0.1", 0))
        self.srv.listen(1)
        self.srv.settimeout(60.0)
        self.port = self.srv.getsockname()[1]
        self.raw = b""
        self.error: BaseException | None = None
        self.thread = threading.Thread(target=self._serve, daemon=True)
        self.thread.start()

    def _serve(self) -> None:
        try:
            conn, _ = self.srv.accept()
            conn.settimeout(60.0)
            with conn:
                while True:
                    data = conn.recv(65536)
                    if not data:
                        return
                    if not self.raw:
                        conn.sendall(bytes([0x20, 0x02, 0x00, 0x00]))   # CONNACK
                    self.raw += data
                    if self.raw.endswith(bytes([0xE0, 0x00])):           # DISCONNECT
                        return
        except BaseException as e:   # noqa: BLE001 - reported by the phase, which fails on it
            self.error = e
        finally:
            self.srv.close()

    def publishes(self) -> list[tuple[str, bytes]]:
        self.thread.join(60.0)
        if self.error is not None or self.thread.is_alive():
            fail(f"the MQTT broker thread failed: {self.error!r}")
        out, buf = [], self.raw
        while buf:
            rl, mult, i = 0, 1, 1
            while True:
                byte = buf[i]
                rl += (byte & 0x7F) * mult
                mult *= 128
                i += 1
                if not byte & 0x80:
                    break
            body, ptype, buf = buf[i:i + rl], buf[0] >> 4, buf[i + rl:]
            if ptype == 3:
                n = int.from_bytes(body[:2], "big")
                out.append((body[2:2 + n].decode(), body[2 + n:]))
        return out


def _ultralytics_state(model: torch.nn.Module) -> dict[str, torch.Tensor]:
    """``model``'s weights under ultralytics' DetectionModel names (the
    inverse of ``models/weights.py::_LAYER_MAP`` and its head naming), with
    the DFL's fixed arange conv."""
    from rtmodt_tpu_torch.models.weights import _LAYER_MAP

    inv = {v: k for k, v in _LAYER_MAP.items()}
    out = {}
    for name, t in model.state_dict().items():
        top, *rest = name.split(".")
        if top == "head":
            branch, leaf = rest[0], rest[1:]                   # box0_1, [conv, weight]
            key = ["model.22", "cv2" if branch[:3] == "box" else "cv3", branch[3], branch[5],
                   *leaf]
        else:
            key = [f"model.{inv[top]}"]
            for p in rest:
                key += ["m", p[1:]] if p[0] == "m" and p[1:].isdigit() else [p]
        out[".".join(key)] = t.detach().cpu().clone()
    out["model.22.dfl.conv.weight"] = torch.arange(16, dtype=torch.float32).reshape(1, 16, 1, 1)
    return out


def _save_pickled_model(state: dict[str, torch.Tensor], path: str) -> None:
    """torch.save ``{"model": DetectionModel}`` whose module classes belong to
    a module that no longer exists when the file is loaded (as a real
    ``yolov8s.pt`` pickles ultralytics' classes)."""
    import types

    mod = types.ModuleType("smoke_vanished_yolo")

    class DetectionModel(torch.nn.Module):
        pass

    class Block(torch.nn.Module):
        pass

    for cls in (DetectionModel, Block):
        cls.__module__, cls.__qualname__ = mod.__name__, cls.__name__
        setattr(mod, cls.__name__, cls)
    root = DetectionModel()
    for key, t in state.items():
        *parts, leaf = key.split(".")
        m = root
        for p in parts:
            if p not in m._modules:
                m.add_module(p, Block())
            m = m._modules[p]
        if leaf.startswith(("running_", "num_batches")):
            m.register_buffer(leaf, t)
        else:
            m.register_parameter(leaf, torch.nn.Parameter(t, requires_grad=False))
    sys.modules[mod.__name__] = mod
    try:
        torch.save({"model": root, "epoch": 0}, path)
    finally:
        del sys.modules[mod.__name__]


def int8_paths(smi: str, frames: np.ndarray, bf16: dict, detect_map: float) -> dict:
    """Phase 11: int8 (synthetic PTQ chunked, the int8 GEMM against its int64
    plain version, frozen QAT scales per stage, S = 2 streams, the offline
    tool's mAP), the per-frame ``transport: bgr`` loop, the mqtt backend and
    ultralytics ``.pt`` weights.  ``bf16`` holds phase 5's figures of the
    same call.  Returns K1's launches per run, its mismatches and the int8
    readings."""
    import cv2

    from rtmodt_tpu_torch.config import load_config
    from rtmodt_tpu_torch.config.loader import DEFAULTS
    from rtmodt_tpu_torch.config.loader import _deep_merge as _merge
    from rtmodt_tpu_torch.detection.detector import Detector
    from rtmodt_tpu_torch.models.weights import load_into, load_npz
    from rtmodt_tpu_torch.models.yolov8 import build_model
    from rtmodt_tpu_torch.ops import int8_conv, nms, nms_kernel
    from rtmodt_tpu_torch.ops.yuv import pack_chunk, planar_letterbox
    from rtmodt_tpu_torch.parallel.multistream import MultiStreamPipeline
    from rtmodt_tpu_torch.quant.ptq import QuantizedConvBN, load_act_scales
    from rtmodt_tpu_torch.runtime.pipeline import Pipeline

    out: dict = {"launches": {}, "mismatches": 0}
    whole = {"name": "whole_frame", "polygon": [[0, 0], [W, 0], [W, H], [0, H]],
             "trigger": "intrusion", "dwell_time_sec": 0.5, "cooldown_sec": 2.0}
    zones = DEFAULTS["events"]["zones"] + [whole]
    base = {"system": {"device": DEVICE},
            "detection": {"model": "yolov8s", "input_size": SIZE, "num_classes": 8,
                          "weights": WEIGHTS},
            "profiling": {"log_interval": 0}, "visualization": {"enabled": False}}
    int8 = {"detection": {"quant": "int8"}}

    def cfg_with(log: str, *overs: dict, alert: dict | None = None):
        _fresh(log)
        c = base
        for o in overs:
            c = _merge(c, o)
        return load_config(overrides=_merge(c, {"events": {
            "zones": zones, "alert": {"log_path": log, **(alert or {})}}}))

    def n_lines(log: str) -> int:
        return len(_event_rows(log))

    def quantized(model) -> list:
        return [m for m in model.modules() if isinstance(m, QuantizedConvBN)]

    # (a) int8 with synthetic calibration on the chunked path
    print(f"  (a) run_chunked, int8 (synthetic calibration, bf16 float layers): "
          f"{N_CHUNKS} chunks of {K} {W}x{H} frames", flush=True)
    log = os.path.join(OUT_DIR, "events_int8.jsonl")
    pipe = Pipeline(cfg_with(log, int8, {"parallel": {"chunk_size": K}}), device=DEVICE)
    qmods = quantized(pipe.detector.model)
    if len(qmods) != INT8_LAYERS:
        fail(f"int8 model holds {len(qmods)} quantized layers, not {INT8_LAYERS}")
    pipe.run_chunked(list(frames[:2 * K]))            # warm-up: cuDNN and cuBLASLt plans
    pipe.reset()
    _fresh(log)
    torch.cuda.synchronize()
    nms_kernel.launches = int8_conv.launches = 0
    summary = pipe.run_chunked(list(frames))
    launches, mm_launches = nms_kernel.launches, int8_conv.launches
    out["launches"]["int8_chunk"] = {"launches": launches, "frames": summary["frames"]}
    print(f"  run: {json.dumps(summary)}; K1 launches {launches}, int8 GEMM launches "
          f"{mm_launches}", flush=True)
    if (launches != summary["chunks"] or summary["frames"] != K * N_CHUNKS
            or (DEVICE == "cuda" and mm_launches != summary["chunks"] * INT8_LAYERS)):
        fail(f"int8 run: K1 launched {launches}, the int8 GEMM {mm_launches} times for "
             f"{summary['chunks']} chunks")
    st = pipe.tracker.state
    vis_end, births = int((st.active & (st.tsu == 0)).sum()), int(st.next_id) - 1
    print(f"  tracks: {vis_end} visible at the end, {births} ids born for {N_OBJECTS} objects; "
          f"{n_lines(log)} zone events", flush=True)
    if vis_end < N_OBJECTS // 2 or births > 3 * N_OBJECTS or n_lines(log) == 0:
        fail(f"int8 run: tracks not stable or no events ({vis_end} visible, {births} ids)")
    if not torch.isfinite(st.boxes[st.active]).all():
        fail("int8 run: non-finite track boxes")
    # K1 against its plain version on every chunk of a second run
    checked = {"calls": 0, "mismatches": 0}
    inner = nms.greedy_suppress

    def checking(boxes, scores, iou):
        keep = inner(boxes, scores, iou)
        want = nms_kernel.greedy_suppress_reference(boxes, scores, iou)
        checked["calls"] += 1
        checked["mismatches"] += int((keep.cpu() != want.cpu()).sum())
        return keep

    nms.greedy_suppress = checking
    try:
        pipe.reset()
        pipe.run_chunked(list(frames))
    finally:
        nms.greedy_suppress = inner
    out["mismatches"] += checked["mismatches"]
    print(f"  K1 against its plain version on each of the {checked['calls']} chunks: "
          f"mismatches {checked['mismatches']}", flush=True)
    if checked["calls"] != N_CHUNKS or checked["mismatches"]:
        fail(f"int8 run: K1 differs from its plain version ({checked})")
    # the chunk program's times, int8 beside phase 5's bf16 of this call
    (y, u, v), meta = pack_chunk(frames[:K], SIZE)
    planes = tuple(torch.from_numpy(p).to(DEVICE) for p in (y, u, v))
    pipe.reset()
    chunk_ms = cuda_time_ms(lambda: pipe.submit_packed_yuv(planes, H, W), iters=10)
    chunk_dev_ms = device_ms(lambda: pipe.submit_packed_yuv(planes, H, W), iters=3)
    with torch.no_grad():
        x16 = planar_letterbox(*planes, SIZE, meta.pad_left, meta.pad_top).permute(0, 3, 1, 2)
        fwd_ms = cuda_time_ms(lambda: pipe.detector.model(x16), iters=20)
        fwd_dev_ms = device_ms(lambda: pipe.detector.model(x16), iters=5)
    idle = None if chunk_dev_ms is None else 100 * (1 - chunk_dev_ms / chunk_ms)
    out["int8"] = {"chunk_ms_per_frame": chunk_ms / K, "forward_ms_per_frame": fwd_ms / K,
                   "e2e_fps": summary["fps"],
                   "chunk_device_ms_per_frame": None if chunk_dev_ms is None
                   else chunk_dev_ms / K,
                   "forward_device_ms_per_frame": None if fwd_dev_ms is None
                   else fwd_dev_ms / K, "device_idle_pct": idle}

    def ms(v):
        return "not measured" if v is None else f"{v:.4f}"

    print(f"  int8 vs bf16 ({smi}), ms/frame at K = {K}: forward (CUDA events) "
          f"{fwd_ms / K:.4f} vs {bf16['fwd_ms'] / K:.4f}; forward device time "
          f"{ms(None if fwd_dev_ms is None else fwd_dev_ms / K)}; chunk program "
          f"{chunk_ms / K:.4f} vs {bf16['chunk_ms'] / K:.4f}, device time "
          f"{ms(None if chunk_dev_ms is None else chunk_dev_ms / K)} vs "
          f"{ms(None if bf16['chunk_dev_ms'] is None else bf16['chunk_dev_ms'] / K)}; "
          f"device idle {ms(idle)} % vs {ms(bf16['idle'])} %; e2e {summary['fps']:.2f} vs "
          f"{bf16['fps']:.2f} frames/s", flush=True)

    # (b) the int8 GEMM against its int64 plain version on every quantized
    # layer of one chunk, and its time on the largest
    caps: list = []
    hooks = [m.register_forward_pre_hook(lambda mod, args: caps.append((mod, args[0])))
             for m in qmods]
    with torch.no_grad():
        pipe.detector.model(x16)
    for hk in hooks:
        hk.remove()
    mism, largest = 0, None
    for mod, x in caps:
        with torch.no_grad():
            xq = mod.quantize_input(x)
            a, _ = int8_conv.im2col_int8(xq, mod.kernel, mod.stride)
            got = int8_conv.int8_mm(a, mod.qweight)
            want = int8_conv.int8_mm_reference(a, mod.qweight)
        mism += int((got.long() != want).sum())
        work = a.shape[0] * a.shape[1] * mod.qweight.shape[1]
        if largest is None or work > largest[0]:
            largest = (work, mod, x)
        del a, got, want
    out["mismatches"] += mism
    print(f"  (b) int8 GEMM against its int64 plain version on all {len(caps)} quantized "
          f"layers of one chunk: mismatches {mism}", flush=True)
    if len(caps) != INT8_LAYERS or mism:
        fail(f"int8 GEMM differs from its plain version ({mism} of {len(caps)} layers)")
    _, mod, x = largest
    name = next(n for n, m in pipe.detector.model.named_modules() if m is mod)
    fm = pipe.detector._float_model.get_submodule(name).conv
    with torch.no_grad():
        xq = mod.quantize_input(x)
        a, _ = int8_conv.im2col_int8(xq, mod.kernel, mod.stride)
        mm = lambda: int8_conv.int8_mm(a, mod.qweight)  # noqa: E731
        m_, k_ = a.shape
        n_ = mod.qweight.shape[1]
        mm_ms = cuda_time_ms(mm, iters=20)
        mm_dev = device_ms(mm, iters=20)
        conv_ms = cuda_time_ms(lambda: mod(x), iters=20)
        wb = fm.weight.to(torch.bfloat16).to(memory_format=torch.channels_last)
        bb = fm.bias.to(torch.bfloat16)
        cudnn_ms = cuda_time_ms(lambda: torch.nn.functional.conv2d(
            x, wb, bb, fm.stride, fm.padding), iters=20)
    nbytes = m_ * k_ + k_ * n_ + m_ * n_ * 4
    t_bytes, t_ops = nbytes / HBM_RATE, 2.0 * m_ * k_ * n_ / INT8_PEAK
    bound = (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")
    out["int8"].update({"int_mm_layer": name, "int_mm_shape": [m_, k_, n_], "int_mm_ms": mm_ms,
                        "int_mm_device_ms": mm_dev, "int_mm_bound_ms": bound[0],
                        "int_mm_bound_by": bound[1], "int8_layer_ms": conv_ms,
                        "bf16_cudnn_layer_ms": cudnn_ms})
    print(f"  _int_mm on the largest layer ({name}: M={m_}, K={k_}, N={n_}): {mm_ms:.4f} ms "
          f"(CUDA events), device {ms(mm_dev)} ms, bound {bound[0]:.5f} ms ({bound[1]}); the "
          f"whole int8 layer (quantize + im2col + GEMM + rescale + SiLU) {conv_ms:.4f} ms "
          f"against cuDNN's bf16 conv of it {cudnn_ms:.4f} ms", flush=True)
    del pipe, caps, largest, a, x16
    torch.cuda.empty_cache()

    # (c) frozen QAT scales on ema_final.npz, per stage on the 25-fps file
    clip = os.path.join(OUT_DIR, "live720.mp4")
    n_file = N_LIVE + LIVE_WARMUP
    print(f"  (c) Pipeline.run per stage, int8 with the frozen QAT scales "
          f"{os.path.relpath(QAT_SCALES, ROOT)}: {n_file} frames", flush=True)
    log = os.path.join(OUT_DIR, "events_int8_qat.jsonl")
    pipe = Pipeline(cfg_with(log, {"detection": {"quant": "int8", "quant_scales": QAT_SCALES}},
                             {"profiling": {"per_stage": True,
                                            "warmup_frames": LIVE_WARMUP}}), device=DEVICE)
    scales = load_act_scales(QAT_SCALES)
    names = {n.replace(".", "/") for n, m in pipe.detector.model.named_modules()
             if isinstance(m, QuantizedConvBN)}
    if len(names) != INT8_LAYERS or not names <= set(scales):
        fail(f"frozen scales: {len(names)} quantized layers, {len(set(scales) - names)} "
             "scales unused")
    torch.cuda.synchronize()
    nms_kernel.launches = 0
    summary = pipe.run(clip)
    launches, n = nms_kernel.launches, pipe.profiler.frame_count
    out["launches"]["int8_qat_per_stage"] = {"launches": launches, "frames": n}
    print("  " + json.dumps({"path": "int8_qat_per_stage", "card": smi, "frames": n,
                             **summary}), flush=True)
    print(f"  K1 launches {launches} for {n} frames + {WARMUP_ITERS} warmup; "
          f"{n_lines(log)} zone events", flush=True)
    if n != n_file or launches != n + WARMUP_ITERS or n_lines(log) == 0:
        fail(f"frozen-scale run: {n} frames, K1 launched {launches} times, "
             f"{n_lines(log)} events")
    del pipe
    torch.cuda.empty_cache()

    # (d) int8 on S = 2 streams
    s2 = 2
    files = [os.path.join(OUT_DIR, f"multi{si}.mp4") for si in range(s2)]
    print(f"  (d) MultiStreamPipeline.run, int8: {s2} x {N_MULTI} frames, T = {T_MULTI}",
          flush=True)
    log = os.path.join(OUT_DIR, "events_int8_multi.jsonl")
    msp = MultiStreamPipeline(cfg_with(log, int8, {"parallel": {
        "num_streams": s2, "chunk_size": T_MULTI, "pipeline_depth": MULTI_DEPTH}}))
    if len(quantized(msp.detector.model)) != INT8_LAYERS:
        fail("int8 multi-stream model is not quantized")
    msp.warmup((H, W), T_MULTI)
    c0 = msp.chunks_submitted
    nms_kernel.launches = 0
    summary = msp.run(files)
    launches, chunks = nms_kernel.launches, msp.chunks_submitted - c0
    out["launches"]["int8_multistream"] = {"launches": launches, "chunks": chunks,
                                           "frames": summary["frames"]}
    per_stream = [0] * s2
    for row in _event_rows(log):
        per_stream[row["metadata"]["stream"]] += 1
    print("  " + json.dumps({"path": "int8_multistream", "card": smi, **summary,
                             "chunks": chunks}), flush=True)
    print(f"  K1 launches {launches} for {chunks} chunks of B = {T_MULTI * s2}; zone events "
          f"per stream {per_stream}", flush=True)
    if (launches != chunks or chunks != -(-N_MULTI // T_MULTI)
            or summary["frames"] != s2 * N_MULTI or min(per_stream) == 0):
        fail(f"int8 multi-stream run: K1 {launches} for {chunks} chunks, "
             f"{summary['frames']} frames, events {per_stream}")
    del msp
    torch.cuda.empty_cache()

    # (e) transport: bgr on the per-frame loop (the BGR program, never the packed one)
    for depth in (0, 2):
        print(f"  (e) Pipeline.run, transport bgr, per_stage false, depth {depth}: "
              f"{BGR_FRAMES} frames", flush=True)
        log = os.path.join(OUT_DIR, f"events_bgr_d{depth}.jsonl")
        pipe = Pipeline(cfg_with(log, {"profiling": {"per_stage": False,
                                                     "warmup_frames": LIVE_WARMUP},
                                       "parallel": {"transport": "bgr", "chunk_size": 1,
                                                    "pipeline_depth": depth}}), device=DEVICE)
        calls = {"packed": 0}
        inner_pd = pipe.packed_detect

        def packed_detect(*a, **kw):
            calls["packed"] += 1
            return inner_pd(*a, **kw)

        pipe.packed_detect = packed_detect
        torch.cuda.synchronize()
        nms_kernel.launches = 0
        summary = pipe.run(clip, max_frames=BGR_FRAMES)
        launches, n = nms_kernel.launches, pipe.profiler.frame_count
        out["launches"][f"bgr_per_frame_d{depth}"] = {"launches": launches, "frames": n}
        print(f"  fps_mean {summary.get('fps_mean', 0.0):.2f}; K1 launches {launches} for {n} "
              f"frames + {WARMUP_ITERS} warmup; packed program calls {calls['packed']}; "
              f"{n_lines(log)} zone events", flush=True)
        if (n != BGR_FRAMES or launches != n + WARMUP_ITERS or calls["packed"]
                or n_lines(log) == 0):
            fail(f"bgr per-frame run at depth {depth}: {n} frames, K1 {launches}, packed "
                 f"calls {calls['packed']}, {n_lines(log)} events")
        del pipe

    # (f) the mqtt backend: every logged event published to a broker on localhost
    broker = _Broker()
    log = os.path.join(OUT_DIR, "events_mqtt.jsonl")
    print(f"  (f) run_chunked with events.alert.backend mqtt (broker on 127.0.0.1:"
          f"{broker.port}): {N_CHUNKS} chunks of {K}", flush=True)
    pipe = Pipeline(cfg_with(log, {"parallel": {"chunk_size": K}}, alert={
        "backend": "mqtt", "mqtt_host": "127.0.0.1", "mqtt_port": broker.port,
        "mqtt_topic": "rtmodt/smoke"}), device=DEVICE)
    torch.cuda.synchronize()
    nms_kernel.launches = 0
    summary = pipe.run_chunked(list(frames))
    launches = nms_kernel.launches
    out["launches"]["mqtt_chunk"] = {"launches": launches, "frames": summary["frames"]}
    if pipe.events._mqtt is not None:
        pipe.events._mqtt.close()
    got = broker.publishes()
    with open(log) as f:
        lines = f.read().splitlines()
    print(f"  {len(got)} PUBLISH packets for {len(lines)} JSONL lines; K1 launches "
          f"{launches}", flush=True)
    if (not lines or len(got) != len(lines) or any(t != "rtmodt/smoke" for t, _ in got)
            or [p.decode() for _, p in got] != lines or launches != summary["chunks"]):
        fail(f"mqtt: {len(got)} packets for {len(lines)} events, K1 {launches}")
    del pipe

    # (g) ultralytics .pt weights: plain tensors and a pickled model of
    # unimportable classes, against the .npz route on phase 5's frames
    ref = build_model("yolov8s", 8)
    load_into(ref, load_npz(WEIGHTS))
    state = _ultralytics_state(ref)
    pts = {"pt_plain": os.path.join(OUT_DIR, "rich640d_state.pt"),
           "pt_pickled": os.path.join(OUT_DIR, "rich640d_model.pth")}
    torch.save(state, pts["pt_plain"])
    _save_pickled_model(state, pts["pt_pickled"])
    print(f"  (g) ultralytics-named rich640d ({len(state)} tensors) as a tensor .pt and as a "
          f"pickled model: detections on {PT_FRAMES} frames against the .npz route", flush=True)
    dcfg = dict(model="yolov8s", num_classes=8, input_size=SIZE, conf_threshold=0.25,
                classes=None)
    want = Detector(_merge(dcfg, {"weights": WEIGHTS}), device=DEVICE, warmup=False)
    want_dets = [want.detect(frames[7 * t]) for t in range(PT_FRAMES)]
    del want
    for key, path in pts.items():
        det = Detector(_merge(dcfg, {"weights": path}), device=DEVICE, warmup=False)
        nms_kernel.launches = 0
        dets = [det.detect(frames[7 * t]) for t in range(PT_FRAMES)]
        launches = nms_kernel.launches
        out["launches"][key] = {"launches": launches, "frames": PT_FRAMES}
        same = all(np.array_equal(a.xyxy, b.xyxy) and np.array_equal(a.confidence, b.confidence)
                   and np.array_equal(a.class_id, b.class_id) for a, b in zip(dets, want_dets))
        print(f"  {key}: {sum(len(d) for d in dets)} detections, equal to the .npz route: "
              f"{same}; K1 launches {launches}", flush=True)
        if not same or launches != PT_FRAMES or not sum(len(d) for d in dets):
            fail(f"{key}: detections differ from the .npz route or K1 launched {launches}")
        del det
    torch.cuda.empty_cache()

    # (h) run_inference_torch detect --quant int8 on phase 9's frames
    img_dir, gt_json = os.path.join(OUT_DIR, "ri_detect"), os.path.join(OUT_DIR, "ri_gt.json")
    dev_flag = [] if DEVICE == "cuda" else ["--cpu"]
    proc, launches, seconds = _counted_subprocess("tools.run_inference_torch", [
        "detect", "--images", img_dir, "--gt-json", gt_json, "--weights", WEIGHTS,
        "--num-classes", "8", "--input-size", str(SIZE), "--evaluate", "--quant", "int8",
        "--out", os.path.join(OUT_DIR, "ri_predictions_int8.json"), *dev_flag])
    m_det = json.loads("\n".join(proc.stdout.strip().splitlines()[:-1]))
    out["launches"]["int8_detect"] = {"launches": launches, "frames": RI_IMAGES}
    out["int8"]["detect_map50"] = m_det["mAP_50"]
    print(f"  (h) run_inference_torch detect --quant int8: {json.dumps(m_det)} ({seconds:.1f} s, "
          f"K1 launches {launches}); mAP@0.5 int8 {m_det['mAP_50']:.4f} against bf16's "
          f"{detect_map:.4f} in phase 9 of this call", flush=True)
    if launches != RI_IMAGES or not m_det["mAP_50"] > 0.3:
        fail(f"int8 detect: mAP@0.5 {m_det['mAP_50']}, K1 launches {launches}")
    print(json.dumps({"int8": out["int8"], "card": smi}), flush=True)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this smoke run needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    from rtmodt_tpu_torch import _build
    from rtmodt_tpu_torch.config import load_config
    from rtmodt_tpu_torch.config.loader import DEFAULTS
    from rtmodt_tpu_torch.models.weights import load_into, load_npz
    from rtmodt_tpu_torch.models.yolov8 import build_model
    from rtmodt_tpu_torch.ops import nms_kernel
    from rtmodt_tpu_torch.ops.nms import (CLASS_OFFSET, candidates_from_logits,
                                          suppress_and_pack)
    from rtmodt_tpu_torch.ops.yuv import pack_chunk, planar_letterbox
    from rtmodt_tpu_torch.runtime.pipeline import Pipeline
    from rtmodt_tpu_torch.utils.synthetic import moving_boxes_frame

    dev = torch.device(DEVICE)
    t_start = time.perf_counter()

    phase("1/11 card")
    smi = smi_line()
    print(f"card: {smi}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}", flush=True)

    phase("2/11 build kernels (nvcc -> ctypes)")
    t0 = time.perf_counter()
    built = _build.build_all()
    print(f"built {sorted(built)} in {time.perf_counter() - t0:.2f} s "
          f"(per source: {json.dumps({n: round(s, 2) for n, s in built.items()})}) "
          f"into {_build.build_dir()}", flush=True)
    for log in sorted(os.listdir(_build.build_dir())):
        if log.endswith(".log"):
            with open(os.path.join(_build.build_dir(), log)) as f:
                for line in f:
                    if any(w in line for w in ("registers", "smem", "stack frame")):
                        print(f"  ptxas {log[:-4]}: {line.strip()}", flush=True)

    phase(f"3/11 NMS kernel vs plain version (B={K}, K={CANDIDATES}, then the kernel's edges)")
    gen = torch.Generator().manual_seed(0)
    max_err = 0.0
    nms_cases = [(name, K, CANDIDATES, 0.45) for name in (
        "random", "tied", "zero_score", "class_offset", "holes", "identical", "no_valid",
        "one_valid", "degenerate")] + [("holes", K, k, 0.45) for k in (1, 33, 65, 1024)] + [
        ("random", K, 1024, 0.45), ("random", 1, CANDIDATES, 0.45), ("holes", 1, 65, 0.45),
        ("random", 64, CANDIDATES, 0.45), ("holes", 64, CANDIDATES, 0.45),
        ("identical", 1, 1024, 0.45), ("no_valid", 1, 33, 0.45),
        ("one_valid", 16, 1024, 0.45)] + [
        (name, K, CANDIDATES, t) for name in ("random", "degenerate") for t in (-0.1, 0.0, 0.9999)]
    for name, b, k, t in nms_cases:
        boxes, scores = synthetic_case(name, gen, b, k)
        want = nms_kernel.greedy_suppress_reference(boxes, scores, t)
        got = nms_kernel.greedy_suppress(boxes.to(dev), scores.to(dev), t)
        torch.cuda.synchronize()
        diff = int((got.cpu() != want).sum())
        print(f"  {name} B={b} K={k} t={t}: valid {int((scores > 0).sum())}, kept "
              f"{int(want.sum())}/{want.numel()}, mismatches {diff}", flush=True)
        if diff:
            fail(f"NMS kernel keep mask differs from the plain version "
                 f"({name}, B={b}, K={k}, t={t}: {diff})")

    phase("4/11 rich640d weights: bf16 channels_last vs float32 (TF32 off)")
    cfg = load_config(overrides={
        "detection": {"model": "yolov8s", "input_size": SIZE, "num_classes": 8,
                      "weights": WEIGHTS},
        "parallel": {"chunk_size": K},
        "events": {"alert": {"log_path": os.path.join(OUT_DIR, "events.jsonl")},
                   "zones": DEFAULTS["events"]["zones"] + [
                       {"name": "whole_frame", "polygon": [[0, 0], [W, 0], [W, H], [0, H]],
                        "trigger": "intrusion", "dwell_time_sec": 0.5, "cooldown_sec": 2.0}]},
    })
    os.makedirs(OUT_DIR, exist_ok=True)
    if os.path.exists(cfg.events.alert.log_path):
        os.remove(cfg.events.alert.log_path)
    t0 = time.perf_counter()
    pipe = Pipeline(cfg, device=DEVICE)
    print(f"pipeline built (weights {os.path.relpath(WEIGHTS, ROOT)}) in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    frames = np.stack([moving_boxes_frame(t, H, W, N_OBJECTS)[0]
                       for t in range(K * N_CHUNKS)])
    (y, u, v), meta = pack_chunk(frames[:K], SIZE)
    planes = tuple(torch.from_numpy(p).to(dev) for p in (y, u, v))
    ref = build_model("yolov8s", 8)
    load_into(ref, load_npz(WEIGHTS))
    ref = ref.eval().fuse_bn().to(dev)
    prev = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    with torch.no_grad():
        img32 = planar_letterbox(*planes, SIZE, meta.pad_left, meta.pad_top,
                                 dtype=torch.float32)
        rb, rc = ref(img32.permute(0, 3, 1, 2).contiguous())
        img16 = planar_letterbox(*planes, SIZE, meta.pad_left, meta.pad_top)
        hb, hc = pipe.detector.model(img16.permute(0, 3, 1, 2))
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev
    for label, lo, hi in (("box", rb, hb), ("cls", rc, hc)):
        if not torch.isfinite(hi).all():
            fail(f"bf16 {label} head has non-finite values")
        err = float((hi.float() - lo).abs().max())
        scale = float(lo.abs().max())
        print(f"  {label} head: max|bf16 - f32| = {err:.4f} on a range of {scale:.2f} "
              f"(rel {err / scale:.4f}, tolerance {MODEL_REL_TOL})", flush=True)
        if err > MODEL_REL_TOL * scale:
            fail(f"bf16 {label} head differs from float32 by {err} (> {MODEL_REL_TOL} x {scale})")

    phase(f"5/11 slice: Pipeline.run_chunked, {N_CHUNKS} chunks of {K} 720p frames")
    pipe.run_chunked(list(frames[:2 * K]))            # warm-up: cuDNN plans, allocator
    pipe.reset()
    torch.cuda.synchronize()
    nms_kernel.launches = 0
    summary = pipe.run_chunked(list(frames))
    launches = nms_kernel.launches
    print(f"  run: {json.dumps(summary)}; NMS kernel launches {launches}", flush=True)
    if launches == 0 or launches != summary["chunks"] or summary["frames"] != K * N_CHUNKS:
        fail(f"NMS kernel launched {launches} times for {summary['chunks']} NMS calls")
    st = pipe.tracker.state
    n_active = int(st.active.sum())
    births = int(st.next_id) - 1
    vis_end = int((st.active & (st.tsu == 0)).sum())
    n_events = 0
    if os.path.exists(cfg.events.alert.log_path):
        with open(cfg.events.alert.log_path) as f:
            n_events = sum(1 for _ in f)
    counts = pipe.events.zone_counts()
    print(f"  tracks: {vis_end} visible at the end, {n_active} active, {births} ids born for "
          f"{N_OBJECTS} objects; {n_events} zone events; zone counts {json.dumps(counts)}",
          flush=True)
    if vis_end < N_OBJECTS // 2 or births > 3 * N_OBJECTS:
        fail(f"tracks not stable: {vis_end} visible, {births} ids for {N_OBJECTS} objects")
    if n_events == 0:
        fail("no zone events were written")
    if not torch.isfinite(st.boxes[st.active]).all():
        fail("non-finite track boxes")

    # timings, CUDA events, on packed planes already on the card
    pipe.reset()
    chunk_ms = cuda_time_ms(lambda: pipe.submit_packed_yuv(planes, H, W), iters=10)
    d = cfg.detection
    with torch.no_grad():
        x16 = planar_letterbox(*planes, SIZE, meta.pad_left, meta.pad_top).permute(0, 3, 1, 2)
        pre_ms = cuda_time_ms(lambda: planar_letterbox(*planes, SIZE, meta.pad_left,
                                                       meta.pad_top), iters=20)
        fwd_ms = cuda_time_ms(lambda: pipe.detector.model(x16), iters=20)
        bd, cl = pipe.detector.model(x16)
        nms_ms = cuda_time_ms(lambda: pipe.detect_chunk(*planes, meta), iters=10) - pre_ms - fwd_ms
        res = pipe.detect_chunk(*planes, meta)
        pipe.reset()
        track_ms = cuda_time_ms(lambda: pipe.track_chunk(res), iters=5)
        cb, cs, cc, _ = candidates_from_logits(bd, cl, SIZE, d.conf_threshold, CANDIDATES,
                                               pipe.detector._class_mask)
        off = (cb + (cc.float() * CLASS_OFFSET)[..., None]).contiguous()
        cs = cs.contiguous()
    want = nms_kernel.greedy_suppress_reference(off, cs, d.iou_threshold)
    got = nms_kernel.greedy_suppress(off, cs, d.iou_threshold)
    real_err = float((got.int() - want.int()).abs().max())
    max_err = max(max_err, real_err)
    if real_err:
        fail("NMS kernel differs from the plain version on the main path's candidates")
    # the kernel's own time: its duration in the profiler's trace (a CUDA
    # graph of 100 launches as the cross-check); per Python call of the
    # wrapper it is bound by the host's issue rate instead
    launch = lambda: nms_kernel.greedy_suppress(off, cs, d.iou_threshold)  # noqa: E731
    kernel_trace_ms = device_ms(launch, iters=100, name="nms_greedy_kernel")
    kernel_graph_ms = graph_ms(launch, iters=100)
    kernel_call_ms = cuda_time_ms(launch, iters=200, warmup=10)
    kernel_ms = kernel_trace_ms if kernel_trace_ms is not None else kernel_graph_ms
    # where the kernel's time goes: the same kernel on inputs that change
    # one part of its work (conflict words and scan steps grow with the valid
    # rows; frames run on separate SMs)
    rand_boxes, rand_scores = synthetic_case("random", gen, K, CANDIDATES)
    big_boxes, big_scores = synthetic_case("random", gen, K, 1024)
    variants = {
        "all 300 valid": (rand_boxes.to(dev), rand_scores.to(dev)),
        "no valid candidate": (off, torch.zeros_like(cs)),
        "one frame": (off[:1].contiguous(), cs[:1].contiguous()),
        "K=1024 all valid": (big_boxes.to(dev), big_scores.to(dev)),
    }
    variant_ms = {label: (device_ms(lambda bx=bx, sc=sc: nms_kernel.greedy_suppress(
        bx, sc, d.iou_threshold), iters=50, name="nms_greedy_kernel"), nms_bound_ms(bx, sc))
        for label, (bx, sc) in variants.items()}
    # the NMS stage's device time split: decode (top-k + DFL) and
    # suppress-and-pack (class offset + K1 + max_det pack)
    with torch.no_grad():
        decode_dev_ms = device_ms(lambda: candidates_from_logits(
            bd, cl, SIZE, d.conf_threshold, CANDIDATES, pipe.detector._class_mask), iters=20)
        pack_dev_ms = device_ms(lambda: suppress_and_pack(
            cb, cs, cc, d.iou_threshold, d.max_detections, d.agnostic_nms), iters=20)
    plain = lambda: nms_kernel.greedy_suppress_reference(off, cs, d.iou_threshold)  # noqa: E731
    plain_ms = cuda_time_ms(plain, iters=20)   # host-synced rounds: wall time on the stream
    plain_dev_ms = device_ms(plain, iters=5)
    chunk_dev_ms = device_ms(lambda: pipe.submit_packed_yuv(planes, H, W), iters=3)
    bound_ms, bound_by = nms_bound_ms(off, cs)
    valid = (cs > 0).sum(dim=1)
    print(f"  e2e {summary['fps']:.2f} frames/s (host clock, 720p, pack + detect + track + "
          f"events, depth {cfg.parallel.pipeline_depth})", flush=True)
    print(f"  chunk program {chunk_ms / K:.4f} ms/frame ({chunk_ms:.3f} ms per chunk of {K}); "
          f"letterbox {pre_ms / K:.4f}, forward {fwd_ms / K:.4f}, NMS {nms_ms / K:.4f}, "
          f"tracker {track_ms / K:.4f} ms/frame", flush=True)
    if chunk_dev_ms is not None:
        print(f"  chunk program device time {chunk_dev_ms / K:.4f} ms/frame (profiler trace); "
              f"device idle {100 * (1 - chunk_dev_ms / chunk_ms):.1f} % of the chunk program",
              flush=True)
    print(f"  NMS kernel {kernel_ms:.5f} ms per chunk (B={K}, K={CANDIDATES}, valid "
          f"candidates/frame {valid.min().item()}-{valid.max().item()}; "
          f"{'profiler trace' if kernel_trace_ms is not None else 'no profiler time: CUDA graph'}); "
          f"in a CUDA graph {kernel_graph_ms:.5f} ms; per wrapper call {kernel_call_ms:.5f} ms; "
          f"plain version {plain_ms:.4f} ms (device time "
          f"{'not measured' if plain_dev_ms is None else f'{plain_dev_ms:.4f} ms'}); "
          f"bound {bound_ms:.6f} ms ({bound_by})", flush=True)
    print("  NMS stage device time per chunk (profiler trace): decode "
          + ("not measured" if decode_dev_ms is None else f"{decode_dev_ms:.5f} ms")
          + ", suppress-and-pack (offset + K1 + max_det pack) "
          + ("not measured" if pack_dev_ms is None else f"{pack_dev_ms:.5f} ms"), flush=True)
    print("  NMS kernel on other inputs (profiler trace, ms per launch; bound): "
          + ", ".join(f"{label} {'not measured' if t is None else f'{t:.5f}'} "
                      f"(bound {bnd:.6f}, {by})"
                      for label, (t, (bnd, by)) in variant_ms.items()), flush=True)

    phase("6/11 live per-frame paths: Pipeline.run per stage and packed, the CLI, "
          "dense-scene quality")
    live = live_paths(smi)
    phase("7/11 the other trackers and GMC: deepsort chunked, botsort per stage, ocsort "
          "packed, host LAPJV; oracle-detection comparison; dense scene")
    trackers = tracker_paths(smi, frames)
    phase(f"8/11 several streams: the native packer, MultiStreamPipeline.run at S = {S_STREAMS}, "
          "per-stream equality in float32, device time, deepsort + GMC, a degraded run")
    multi = multistream_paths(smi)
    phase("9/11 serving: the web app over a socket, the default build, 8-way concurrency, "
          "the MJPEG monitor, run_inference_torch")
    t9 = time.perf_counter()
    serving = serving_paths(smi, live["quality"])
    print(f"  phase 9 took {time.perf_counter() - t9:.1f} s", flush=True)
    phase("10/11 kill-and-resume (chunked, per stage, a killed CLI, several streams), device "
          "zone masks, the x6 / x24 / bgr transports")
    t10 = time.perf_counter()
    resume = resume_paths(smi)
    max_err = max(max_err, float(resume["mismatches"]))
    print(f"  phase 10 took {time.perf_counter() - t10:.1f} s", flush=True)
    phase("11/11 int8 (synthetic calibration chunked, the int8 GEMM against its int64 plain "
          "version, frozen QAT scales per stage, S = 2), the per-frame bgr loop, mqtt, .pt "
          "weights, int8 mAP")
    t11 = time.perf_counter()
    bf16 = {"fwd_ms": fwd_ms, "chunk_ms": chunk_ms, "chunk_dev_ms": chunk_dev_ms,
            "idle": None if chunk_dev_ms is None else 100 * (1 - chunk_dev_ms / chunk_ms),
            "fps": summary["fps"]}
    quant = int8_paths(smi, frames, bf16, serving["detect_eval"]["mAP_50"])
    max_err = max(max_err, float(quant["mismatches"]))
    print(f"  phase 11 took {time.perf_counter() - t11:.1f} s", flush=True)
    by_path = {"chunk": {"launches": launches, "frames": summary["frames"]},
               **live["launches"], **trackers["launches"], **multi["launches"],
               **serving["launches"], **resume["launches"], **quant["launches"]}
    launches = sum(r["launches"] for r in by_path.values())
    print(f"  K1 launches by run: {json.dumps(by_path)}; total {launches}", flush=True)
    print(f"  total smoke time {time.perf_counter() - t_start:.1f} s", flush=True)

    kernels = [{
        "name": "nms_greedy", "route": "cuda",
        "source": "rtmodt_tpu_torch/csrc/nms_kernel.cu",
        "replaces": "rtmodt_tpu/ops/pallas/nms_kernel.py:24",
        "launches": launches, "launches_by_path": by_path, "max_abs_err": max_err,
        "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None,   # no single PyTorch call computes greedy NMS
        # K1 at the multi-stream chunk's B = T * S (phase 8 (d))
        f"b{T_MULTI * S_STREAMS}": {"ms": multi["b32"]["trace_ms"],
                                    "graph_ms": multi["b32"]["graph_ms"],
                                    "plain_ms": multi["b32"]["plain_ms"],
                                    "bound_ms": multi["b32"]["bound"][0],
                                    "bound_by": multi["b32"]["bound"][1]},
        # K1 at B = 1 on served frames
        **{key: {"ms": t["trace_ms"], "graph_ms": t["graph_ms"], "plain_ms": t["plain_ms"],
                 "bound_ms": t["bound"][0], "bound_by": t["bound"][1]}
           for key, t in (("b1_served", serving["b1"]),            # phase 9 (c)
                          ("b1_detect", serving["b1_detect"]))},   # phase 9 (g), K = 1000
    }]
    print(smi, flush=True)                   # name, power limit as nvidia-smi gives them
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
