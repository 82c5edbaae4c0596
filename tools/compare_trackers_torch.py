#!/usr/bin/env python
"""Tracker comparison on oracle-detection scenarios, with the PyTorch port.

The port's copy of ``tools/compare_trackers.py``: the same four scenarios
(bounce: head-on crossing pairs that occlude and bounce back; stopgo: fast
movers that vanish and re-appear where they were last seen; dense: a
persistent-id crowd; shake: white-noise camera jumps), the same tracker
configurations and the same flags, run through ``rtmodt_tpu_torch``'s
tracker facade and ``evaluation/mot_eval.py``.  Detections are the ground
truth boxes of the unoccluded objects, so tracker quality is isolated from
detector quality.  Prints one row per tracker: IDF1 / MOTA / HOTA / DetA /
AssA / ID switches.

The ``random`` embedder rows use the port's seeded init, which is not the
reference's flax init: their numbers are not the reference's.

Usage: python tools/compare_trackers_torch.py [--scenario bounce|stopgo|dense|shake]
       [--embedder checkpoints/embedder.npz] [--frames 60] [--pairs 3]
       [--objects 64] [--gap 8] [--json out.json] [--cpu]
(the card by default; ``--cpu`` runs on the CPU).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def build_scenario(frames: int, pairs: int, h: int = 480, w: int = 840,
                   seed: int = 0):
    """Bouncing-pair scenes. Returns (frames_bgr, gt) where gt[f][tid] =
    xyxy of every VISIBLE (unoccluded) object."""
    from rtmodt_tpu_torch.utils.synthetic import reid_patch

    rng = np.random.default_rng(seed)
    bw, bh = 64, 96
    objs = []        # (tid, x_of_t, y, patch_fn)
    tid = 1
    for p in range(pairs):
        y = 60 + p * ((h - 160) // max(1, pairs - 1) if pairs > 1 else 0)
        meet = frames // 2
        x_left0 = 40.0 + rng.uniform(-10, 10)
        x_right0 = w - 40.0 - bw + rng.uniform(-10, 10)
        x_meet = (x_left0 + x_right0) / 2 + rng.uniform(-30, 30)
        vl = (x_meet - x_left0) / meet
        vr = (x_meet - x_right0) / meet

        def traj(x0, v, meet=meet):
            def f(t):
                # advance to the meeting point, then bounce straight back
                return x0 + v * t if t <= meet else x0 + v * (2 * meet - t)
            return f

        objs.append((tid, traj(x_left0, vl), y, p * 2))
        objs.append((tid + 1, traj(x_right0, vr), y, p * 2 + 1))
        tid += 2

    frames_bgr, gt = [], {}
    for t in range(frames):
        frame = np.full((h, w, 3), 28, np.uint8)
        frame += rng.integers(0, 14, (h, w, 3), np.uint8)
        boxes = {}
        for oid, fx, y, ident in objs:
            x = float(fx(t))
            patch = reid_patch(ident, t, (bh, bw), seed=seed + 77)
            x0, y0 = int(round(x)), int(y)
            x0 = max(0, min(w - bw, x0))
            frame[y0:y0 + bh, x0:x0 + bw] = patch
            boxes[oid] = np.array([x0, y0, x0 + bw, y0 + bh], np.float32)
        # occlusion: the later-drawn object covers the earlier one; a
        # mostly-covered object emits NO detection that frame
        vis = {}
        ids = list(boxes)
        for i, a in enumerate(ids):
            xa = boxes[a]
            covered = 0.0
            for b in ids[i + 1:]:
                xb = boxes[b]
                iw = max(0.0, min(xa[2], xb[2]) - max(xa[0], xb[0]))
                ih = max(0.0, min(xa[3], xb[3]) - max(xa[1], xb[1]))
                covered = max(covered, iw * ih / ((xa[2] - xa[0]) * (xa[3] - xa[1])))
            if covered < 0.6:
                vis[a] = xa
        frames_bgr.append(frame)
        gt[t + 1] = vis
    return frames_bgr, gt


def build_stopgo(frames: int, objects: int, h: int = 480, w: int = 840,
                 gap: int = 8, seed: int = 0):
    """Stop-and-go occlusion: fast movers vanish mid-sequence for ``gap``
    frames and RE-APPEAR WHERE THEY WERE LAST SEEN (stationary from then
    on) - e.g. a pedestrian stepping behind a pillar and stopping.  A
    Kalman-only tracker's prediction sails ~gap*v past the pillar, so the
    IoU gate fails on re-appearance and the id churns; OC-SORT's OCR stage
    associates against last observations and keeps it."""
    from rtmodt_tpu_torch.utils.synthetic import reid_patch

    rng = np.random.default_rng(seed)
    bw, bh = 64, 96
    t_hide = frames // 3
    objs = []
    for i in range(objects):
        y = 40 + int(rng.uniform(0, h - bh - 80))
        x0 = 30.0 + rng.uniform(0, 60)
        v = 18.0 + rng.uniform(0, 8)             # fast: > box width over gap
        objs.append((i + 1, x0, y, v, i))

    frames_bgr, gt = [], {}
    for t in range(frames):
        frame = np.full((h, w, 3), 28, np.uint8)
        frame += rng.integers(0, 14, (h, w, 3), np.uint8)
        vis = {}
        for oid, x0, y, v, ident in objs:
            if t_hide <= t < t_hide + gap:
                continue                          # occluded: no detection
            # advance until the hide point, then frozen there
            x = x0 + v * min(t, t_hide - 1)
            xi = int(round(max(0, min(w - bw, x))))
            frame[y:y + bh, xi:xi + bw] = reid_patch(ident, t, (bh, bw),
                                                     seed=seed + 77)
            vis[oid] = np.array([xi, y, xi + bw, y + bh], np.float32)
        frames_bgr.append(frame)
        gt[t + 1] = vis
    return frames_bgr, gt


def build_dense(frames: int, objects: int, h: int = 480, w: int = 840,
                seed: int = 0):
    """Dense persistent-id crowd (``utils/synthetic.py::dense_moving_scene``):
    oracle detections at density, isolating association cost/quality from
    the detector."""
    from rtmodt_tpu_torch.utils.synthetic import dense_moving_scene

    frames_bgr, gt = [], {}
    for t in range(frames):
        frame, boxes, _labels, ids = dense_moving_scene(
            t, h, w, n_objects=objects, seed=seed)
        frames_bgr.append(frame)
        gt[t + 1] = {int(i): np.asarray(b, np.float32)
                     for i, b in zip(ids, boxes)}
    return frames_bgr, gt


def build_shake(frames: int, objects: int, h: int = 480, w: int = 840,
                amp: float = 35.0, seed: int = 0):
    """Camera-shake scenario (the GMC case, ``ops/gmc.py``): a textured world
    canvas viewed through a camera window that JUMPS uniform(-amp, amp)
    each frame - white-noise jerk no Kalman velocity can predict - while
    the objects drift slowly in world coordinates.  At amp=35 and 48 px
    boxes, consecutive frames routinely have ZERO box overlap, so every
    uncompensated IoU gate fails fleet-wide; phase correlation reads the
    jump off the background and restores association."""
    import cv2

    from rtmodt_tpu_torch.utils.synthetic import reid_patch

    rng = np.random.default_rng(seed)
    m = int(np.ceil(amp)) + 40                    # canvas margin
    # multi-scale texture: natural scenes have structure at ALL scales;
    # single-scale fine noise washes out under the GMC luma downsample
    ch, cw = h + 2 * m, w + 2 * m
    acc = np.zeros((ch, cw, 3), np.float32)
    for sigma, wgt in ((3, 1.0), (12, 2.0), (48, 4.0)):
        n = rng.integers(0, 255, (ch, cw, 3)).astype(np.float32)
        acc += wgt * (cv2.GaussianBlur(n, (0, 0), sigma) - 127.5)
    acc = (acc - acc.min()) / (acc.max() - acc.min() + 1e-9)
    canvas = (20 + 200 * acc).astype(np.uint8)

    bw, bh = 48, 64
    objs = []                                     # world-coord positions
    for i in range(objects):
        wx = m + 60.0 + rng.uniform(0, w - 200)
        wy = m + 60.0 + rng.uniform(0, h - 200)
        vx, vy = rng.uniform(-2, 2, 2)            # slow world drift
        objs.append((i + 1, wx, wy, vx, vy, i))

    frames_bgr, gt = [], {}
    ox, oy = float(m), float(m)
    for t in range(frames):
        if t:
            ox = float(np.clip(m + rng.uniform(-amp, amp), 0, 2 * m))
            oy = float(np.clip(m + rng.uniform(-amp, amp), 0, 2 * m))
        oxi, oyi = int(round(ox)), int(round(oy))
        frame = canvas[oyi:oyi + h, oxi:oxi + w].copy()
        vis = {}
        for oid, wx, wy, vx, vy, ident in objs:
            x = wx + vx * t - oxi                 # image coords
            y = wy + vy * t - oyi
            xi = int(round(max(0, min(w - bw, x))))
            yi = int(round(max(0, min(h - bh, y))))
            frame[yi:yi + bh, xi:xi + bw] = reid_patch(ident, t, (bh, bw),
                                                       seed=seed + 77)
            vis[oid] = np.array([xi, yi, xi + bw, yi + bh], np.float32)
        frames_bgr.append(frame)
        gt[t + 1] = vis
    return frames_bgr, gt


def run_tracker(name: str, kwargs: dict, frames_bgr, gt, device: str = "cuda") -> dict:
    """One tracker configuration over a scenario: the MOT metrics of its
    visible tracks against the ground truth."""
    from rtmodt_tpu_torch.detection.detector import Detections
    from rtmodt_tpu_torch.evaluation.mot_eval import evaluate_mot
    from rtmodt_tpu_torch.tracking.tracker import MultiObjectTracker

    del name
    tr = MultiObjectTracker(device=device, **kwargs)
    pred = {}
    for t, frame in enumerate(frames_bgr):
        vis = gt[t + 1]
        dets = Detections(
            np.stack(list(vis.values())) if vis else np.zeros((0, 4), np.float32),
            np.full(len(vis), 0.9, np.float32),
            np.zeros(len(vis), np.int32), ["obj"])
        tracks = tr.update(dets, frame)
        pred[t + 1] = {tk.track_id: np.asarray(tk.xyxy, np.float64) for tk in tracks}
    gt_xywh = {f: {i: np.array([b[0], b[1], b[2] - b[0], b[3] - b[1]])
                   for i, b in d.items()} for f, d in gt.items()}
    pr_xywh = {f: {i: np.array([b[0], b[1], b[2] - b[0], b[3] - b[1]])
                   for i, b in d.items()} for f, d in pred.items()}
    m = evaluate_mot(gt_xywh, pr_xywh)
    return {"idf1": round(float(m["idf1"]), 4),
            "mota": round(float(m["mota"]), 4),
            "hota": round(float(m["hota"]), 4),
            "det_a": round(float(m["det_a"]), 4),
            "ass_a": round(float(m["ass_a"]), 4),
            "switches": int(m["num_switches"])}


def build(scenario: str, frames: int, pairs: int = 3, objects: int = 64, gap: int = 8):
    """(frames_bgr, gt) of a scenario, as the reference tool builds it."""
    if scenario == "stopgo":
        return build_stopgo(frames, pairs * 2, gap=gap)
    if scenario == "dense":
        return build_dense(frames, objects)
    if scenario == "shake":
        return build_shake(frames, pairs * 2)
    return build_scenario(frames, pairs)


def tracker_configs(scenario: str, embedder: str) -> list[tuple[str, dict]]:
    """The reference tool's tracker rows for a scenario."""
    have = os.path.exists(embedder)
    ds_base = dict(n_init=1, max_age=30, min_confidence=0.3, max_dist=0.4)
    gmc_on = dict(method="phase")
    if scenario == "shake":
        return [
            ("bytetrack_canonical", dict(algorithm="bytetrack",
             bytetrack=dict(match_metric="iou_distance"))),
            ("bytetrack_gmc", dict(algorithm="bytetrack",
             bytetrack=dict(match_metric="iou_distance"), gmc=gmc_on)),
            ("ocsort", dict(algorithm="ocsort",
             ocsort=dict(det_thresh=0.5, min_hits=1, max_age=30))),
            ("ocsort_gmc", dict(algorithm="ocsort",
             ocsort=dict(det_thresh=0.5, min_hits=1, max_age=30), gmc=gmc_on)),
            ("deepsort_gmc", dict(algorithm="deepsort",
             deepsort=dict(ds_base, embedder=embedder if have else "random"), gmc=gmc_on)),
            ("botsort_gmc", dict(algorithm="botsort",
             botsort=dict(track_thresh=0.5, new_track_thresh=0.5,
                          embedder=embedder if have else "random"), gmc=gmc_on)),
        ]
    configs = [
        ("bytetrack_reference_iou", dict(algorithm="bytetrack",
         bytetrack=dict(match_metric="iou"))),
        ("bytetrack_canonical", dict(algorithm="bytetrack",
         bytetrack=dict(match_metric="iou_distance"))),
        ("deepsort_random_embedder", dict(algorithm="deepsort",
         deepsort=dict(ds_base, embedder="random"))),
        ("ocsort", dict(algorithm="ocsort",
         ocsort=dict(det_thresh=0.5, min_hits=1, max_age=30))),
        ("botsort", dict(algorithm="botsort",
         botsort=dict(track_thresh=0.5, new_track_thresh=0.5,
                      embedder=embedder if have else "random"))),
    ]
    if have:
        configs.append(("deepsort_trained_embedder", dict(
            algorithm="deepsort", deepsort=dict(ds_base, embedder=embedder))))
    else:
        print(f"note: {embedder} not found - no trained-embedder row", file=sys.stderr)
    return configs


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--embedder", default="checkpoints/embedder.npz")
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--pairs", type=int, default=3)
    ap.add_argument("--scenario", choices=["bounce", "stopgo", "dense", "shake"],
                    default="bounce",
                    help="bounce: head-on crossing pairs (appearance wins); "
                         "stopgo: re-appearance at last observation "
                         "(observation-centric recovery wins); "
                         "dense: persistent-id crowd at --objects density; "
                         "shake: white-noise camera jumps (GMC wins)")
    ap.add_argument("--gap", type=int, default=8, help="stopgo occlusion length (frames)")
    ap.add_argument("--objects", type=int, default=64, help="dense scenario object count")
    ap.add_argument("--json", default=None)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (default: the card)")
    args = ap.parse_args(argv)

    device = "cpu" if args.cpu else "cuda"
    frames_bgr, gt = build(args.scenario, args.frames, args.pairs, args.objects, args.gap)
    results = {}
    for name, kwargs in tracker_configs(args.scenario, args.embedder):
        results[name] = run_tracker(name, kwargs, frames_bgr, gt, device)
        print(f"{name:28s} " + "  ".join(f"{k}={v}" for k, v in results[name].items()),
              flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(results, f, indent=1)
    return results


if __name__ == "__main__":
    main()
