#!/usr/bin/env python
"""Offline inference with the PyTorch/CUDA port -> COCO predictions / MOT files.

The port's counterpart of ``tools/run_inference.py``, with the same two
subcommands and flags (and ``--cpu``: the card by default):

  * ``detect``: run the port's ``Detector`` over a COCO GT json's images (or
    an image directory) and write predictions in COCO results format, then
    optionally evaluate mAP in-process (``--evaluate``, the repository's
    numpy COCOeval);
  * ``track``: run the port's ``Pipeline`` (detect + track) over a video
    (or MOT image sequence) and write MOT15-2D rows, optionally fill track
    gaps offline (``--interpolate MAX_GAP``), then optionally evaluate
    IDF1 / MOTA against a GT file (``--gt-mot``).

``--quant int8`` is not ported (ROADMAP item 10) and exits non-zero.

    python tools/run_inference_torch.py detect --images img/ --gt-json gt.json --evaluate
    python tools/run_inference_torch.py track --video clip.mp4 --gt-mot gt.txt --interpolate 20
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

ALGORITHMS = ("bytetrack", "deepsort", "botsort", "ocsort")


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="command", required=True)

    d = sub.add_parser("detect", help="Detection over images -> COCO results json "
                                      "(+ optional mAP).")
    d.add_argument("--images", required=True, help="image directory")
    d.add_argument("--gt-json", default=None, help="COCO GT json (ids + optional eval)")
    d.add_argument("--out", default="outputs/predictions.json")
    d.add_argument("--model", default="yolov8s")
    d.add_argument("--weights", default=None)
    d.add_argument("--num-classes", default=80, type=int)
    d.add_argument("--input-size", default=640, type=int)
    d.add_argument("--conf", default=0.001, type=float, help="low conf for mAP sweeps")
    d.add_argument("--quant", default="none", choices=["none", "int8"],
                   help="int8 is not ported (ROADMAP item 10)")
    d.add_argument("--quant-scales", default=None,
                   help="QAT frozen activation scales (int8 only)")
    d.add_argument("--evaluate", dest="do_eval", action="store_true")

    t = sub.add_parser("track", help="Detect+track over a video -> MOT15-2D rows "
                                     "(+ optional IDF1/MOTA).")
    t.add_argument("--video", required=True, help="video file or image-sequence dir")
    t.add_argument("--out", default="outputs/tracks.txt")
    t.add_argument("--model", default="yolov8s")
    t.add_argument("--weights", default=None)
    t.add_argument("--num-classes", default=80, type=int)
    t.add_argument("--input-size", default=640, type=int)
    t.add_argument("--gt-mot", default=None, help="MOT15-2D GT for evaluation")
    t.add_argument("--conf", default=0.35, type=float)
    t.add_argument("--match-thresh", default=0.8, type=float)
    t.add_argument("--track-thresh", default=0.5, type=float,
                   help="min confidence to BIRTH a track (ByteTrack high gate)")
    t.add_argument("--max-frames", default=None, type=int)
    t.add_argument("--algorithm", default="bytetrack", choices=ALGORITHMS)
    t.add_argument("--interpolate", default=0, type=int, metavar="MAX_GAP",
                   help="offline post-processing: linearly fill per-id track gaps "
                        "up to MAX_GAP frames")
    t.add_argument("--embedder", default=None,
                   help="appearance embedder .npz override for deepsort/botsort "
                        "(default: the shipped checkpoints/embedder.npz)")
    for p in (d, t):
        p.add_argument("--cpu", action="store_true", help="run on the CPU (default: the card)")
    return ap.parse_args(argv)


def detect(args: argparse.Namespace) -> dict | None:
    """Detection over images -> COCO results json (+ optional mAP)."""
    import cv2

    from rtmodt_tpu_torch.config.loader import DetectionConfig
    from rtmodt_tpu_torch.detection.detector import Detector
    from rtmodt_tpu_torch.utils.logging import logger

    if args.quant == "int8":
        raise SystemExit("run_inference_torch: --quant int8 is not ported: ROADMAP item 10")
    if args.quant_scales:
        raise SystemExit("run_inference_torch: --quant-scales (QAT frozen scales) "
                         "requires --quant int8")
    try:
        det = Detector(DetectionConfig(
            model=args.model, weights=args.weights, num_classes=args.num_classes,
            input_size=args.input_size, conf_threshold=args.conf, classes=None,
            max_detections=300, nms_candidates=1000),
            device="cpu" if args.cpu else "cuda", warmup=False)
    except RuntimeError as e:     # asked for the card where there is none
        raise SystemExit(f"run_inference_torch: {e}")

    images = args.images
    cat_ids = None
    if args.gt_json:
        with open(args.gt_json) as f:
            gt = json.load(f)
        entries = [(img["id"], os.path.join(images, img["file_name"]))
                   for img in gt["images"]]
        # real COCO category ids have gaps (12, 26, ...): map the model's
        # contiguous class index through the GT's sorted category list
        if gt.get("categories"):
            cat_ids = sorted(c["id"] for c in gt["categories"])
    else:
        files = sorted(f for f in os.listdir(images)
                       if f.lower().endswith((".jpg", ".jpeg", ".png")))
        entries = list(enumerate([os.path.join(images, f) for f in files], 1))

    preds = []
    for img_id, path in entries:
        frame = cv2.imread(path)
        if frame is None:
            logger.warning(f"unreadable: {path}")
            continue
        d = det.detect(frame)
        for i in range(len(d)):
            x1, y1, x2, y2 = d.xyxy[i]
            ci = int(d.class_id[i])
            preds.append({
                "image_id": img_id,
                "category_id": (cat_ids[ci] if cat_ids and ci < len(cat_ids)
                                else ci + 1),
                "bbox": [float(x1), float(y1), float(x2 - x1), float(y2 - y1)],
                "score": float(d.confidence[i]),
            })
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(preds, f)
    logger.info(f"wrote {len(preds)} predictions -> {args.out}")

    if args.do_eval and args.gt_json:
        from rtmodt_tpu_torch.evaluation.metrics import evaluate_detection

        result = evaluate_detection(args.gt_json, args.out)
        print(json.dumps(result, indent=2))
        return result
    return None


def track(args: argparse.Namespace) -> dict | None:
    """Detect+track over a video -> MOT15-2D rows (+ optional IDF1/MOTA)."""
    import cv2

    from rtmodt_tpu_torch.config import load_config
    from rtmodt_tpu_torch.runtime.pipeline import Pipeline
    from rtmodt_tpu_torch.utils.logging import logger

    th, emb = args.track_thresh, ({"embedder": args.embedder} if args.embedder else {})
    cfg = load_config(overrides={
        "system": {"device": "cpu" if args.cpu else "cuda"},
        "detection": {"model": args.model, "weights": args.weights,
                      "conf_threshold": args.conf, "num_classes": args.num_classes,
                      "input_size": args.input_size, "classes": None},
        "tracking": {"algorithm": args.algorithm,
                     "bytetrack": {"match_thresh": args.match_thresh,
                                   "track_thresh": th, "new_track_thresh": th},
                     "deepsort": {"min_confidence": th, **emb},
                     "botsort": {"track_thresh": th, "new_track_thresh": th,
                                 "match_thresh": args.match_thresh, **emb},
                     "ocsort": {"det_thresh": th}},
        "events": {"enabled": False},
        "visualization": {"enabled": False},
        "profiling": {"per_stage": False, "warmup_frames": 0, "log_interval": 0},
    })
    try:
        pipe = Pipeline(cfg)
    except RuntimeError as e:     # asked for the card where there is none
        raise SystemExit(f"run_inference_torch: {e}")

    video = args.video

    def frames():
        if os.path.isdir(video):
            for i, f in enumerate(sorted(os.listdir(video)), 1):
                if f.lower().endswith((".jpg", ".jpeg", ".png")):
                    yield i, cv2.imread(os.path.join(video, f))
        else:
            cap = cv2.VideoCapture(video)
            i = 0
            while True:
                ok, frame = cap.read()
                if not ok:
                    break
                i += 1
                yield i, frame
            cap.release()

    out = args.out
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    n = 0
    with open(out, "w") as f:
        for fid, frame in frames():
            if frame is None:
                continue
            tracks, _, _ = pipe.step(frame, fid, fid / 30.0)
            for t in tracks:
                x1, y1, x2, y2 = t.xyxy
                f.write(f"{fid},{t.track_id},{x1:.2f},{y1:.2f},"
                        f"{x2 - x1:.2f},{y2 - y1:.2f},{t.confidence:.3f},-1,-1,-1\n")
            n += 1
            if args.max_frames and n >= args.max_frames:
                break
    logger.info(f"tracked {n} frames -> {out}")

    if args.interpolate > 0:
        from rtmodt_tpu_torch.tracking.postprocess import (interpolate_mot_rows,
                                                           load_mot_rows, write_mot_rows)

        rows = load_mot_rows(out)
        filled = interpolate_mot_rows(rows, max_gap=args.interpolate)
        write_mot_rows(out, filled)
        logger.info(f"interpolated {len(filled) - len(rows)} gap rows "
                    f"(max_gap={args.interpolate}) -> {out}")

    if args.gt_mot:
        from rtmodt_tpu_torch.evaluation.metrics import evaluate_tracking

        result = evaluate_tracking(args.gt_mot, out)
        print(json.dumps(result, indent=2))
        return result
    return None


def main(argv: list[str] | None = None) -> int:
    args = parse_args(argv)
    (detect if args.command == "detect" else track)(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
