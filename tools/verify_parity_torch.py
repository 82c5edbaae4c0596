#!/usr/bin/env python
"""Weight-conversion parity harness for the PyTorch/CUDA port.

The port's counterpart of ``tools/verify_parity.py``, with its flags (and
``--cpu``: the card by default).  One command checks that a checkpoint
loads weight-exactly into the port (``rtmodt_tpu_torch/models/weights.py``):

  1. load the weights: convert an ultralytics ``--pt`` (fails loudly on any
     unconsumed tensor) or read a reference ``--weights`` ``.npz``;
  2. detect on the sample gallery with the float32 unfused model;
  3. detect again with the BN-fused float32 model and diff the boxes (the
     fold must be exact to 0.05 px, every box matched), and with the bf16
     fused deploy model (small drift expected);
  4. where ``ultralytics`` is importable, run its torch model on the same
     images and IoU-match the boxes against the port's (skipped otherwise);
  5. write every box and diff to a JSON artifact.

With no weights at all it prints a SKIP line and exits 0.

    python tools/verify_parity_torch.py [--pt yolov8s.pt | --weights ckpt.npz]
        [--model yolov8s] [--samples web/static/samples] [--out parity.json] [--cpu]
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _iou_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(N, 4), (M, 4) xyxy -> (N, M) IoU."""
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)))
    tl = np.maximum(a[:, None, :2], b[None, :, :2])
    br = np.minimum(a[:, None, 2:], b[None, :, 2:])
    inter = np.prod(np.clip(br - tl, 0, None), axis=-1)
    area_a = np.prod(a[:, 2:] - a[:, :2], axis=-1)
    area_b = np.prod(b[:, 2:] - b[:, :2], axis=-1)
    return inter / np.maximum(area_a[:, None] + area_b[None, :] - inter, 1e-9)


def _detect_all(det, frames: list[np.ndarray]) -> list[dict]:
    out = []
    for f in frames:
        d = det.detect(f)
        out.append({"boxes": np.asarray(d.xyxy, np.float64).tolist(),
                    "scores": np.asarray(d.confidence, np.float64).tolist(),
                    "classes": np.asarray(d.class_id).tolist()})
    return out


def _diff(a: list[dict], b: list[dict], name_a: str, name_b: str) -> dict:
    """Greedy IoU matching per image: box and score deltas, unmatched boxes."""
    per_img, worst_box, worst_score, unmatched = [], 0.0, 0.0, 0
    for da, db in zip(a, b):
        ba, bb = np.asarray(da["boxes"]), np.asarray(db["boxes"])
        sa, sb = np.asarray(da["scores"]), np.asarray(db["scores"])
        m = _iou_matrix(ba.reshape(-1, 4), bb.reshape(-1, 4))
        pairs = []
        used_b: set[int] = set()
        for i in np.argsort(-sa):
            if m.shape[1] == 0:
                break
            j = int(np.argmax(np.where(np.isin(np.arange(m.shape[1]), list(used_b)),
                                       -1.0, m[i])))
            if m[i, j] >= 0.5 and j not in used_b:
                used_b.add(j)
                pairs.append((int(i), j))
        un = (len(ba) - len(pairs)) + (len(bb) - len(pairs))
        unmatched += un
        if pairs:
            ii = [p[0] for p in pairs]
            jj = [p[1] for p in pairs]
            worst_box = max(worst_box, float(np.abs(ba[ii] - bb[jj]).max()))
            worst_score = max(worst_score, float(np.abs(sa[ii] - sb[jj]).max()))
        per_img.append({"matched": len(pairs), "unmatched": un})
    return {"a": name_a, "b": name_b, "per_image": per_img,
            "max_box_delta_px": worst_box, "max_score_delta": worst_score,
            "total_unmatched": unmatched}


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pt", default=None,
                    help="ultralytics .pt to convert (default: the first checkpoints/*.pt)")
    ap.add_argument("--weights", default=None, help="reference .npz instead of --pt")
    ap.add_argument("--model", default="yolov8s")
    ap.add_argument("--num-classes", type=int, default=80)
    ap.add_argument("--input-size", type=int, default=640)
    ap.add_argument("--conf", type=float, default=0.25)
    ap.add_argument("--samples", default="web/static/samples")
    ap.add_argument("--out", default="outputs/parity.json")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (default: the card)")
    return ap.parse_args(argv)


def main(argv: list[str] | None = None) -> int:
    args = parse_args(argv)
    weights = args.weights
    if weights is None:
        pt = args.pt or next(iter(sorted(glob.glob("checkpoints/*.pt"))), None)
        if pt and os.path.exists(pt):
            weights = pt
    if weights is None or not os.path.exists(weights):
        print("verify_parity_torch: SKIP - no checkpoint found (supply --pt or "
              "--weights); conversion parity needs real weights")
        return 0

    import cv2

    from rtmodt_tpu_torch.detection.detector import Detector

    frames = []
    for p in sorted(glob.glob(os.path.join(args.samples, "*.jpg")))[:8]:
        img = cv2.imread(p)
        if img is not None:
            frames.append(img)
    if not frames:
        rng = np.random.default_rng(0)
        frames = [rng.integers(0, 256, (720, 1280, 3), np.uint8) for _ in range(4)]
        print("verify_parity_torch: no gallery images; using random frames")

    device = "cpu" if args.cpu else "cuda"
    base = dict(model=args.model, num_classes=args.num_classes, input_size=args.input_size,
                weights=weights, conf_threshold=args.conf)
    report: dict = {"weights": weights, "n_images": len(frames), "diffs": []}

    def detector(**kw) -> Detector:
        try:
            return Detector({**base, **kw}, device=device, warmup=False)
        except RuntimeError as e:     # asked for the card where there is none
            raise SystemExit(f"verify_parity_torch: {e}")

    # float32 unfused: the numerical ground truth of the loaded tree
    ref_boxes = _detect_all(detector(half=False, fuse_bn=False), frames)
    report["fp32_unfused"] = ref_boxes

    # BN-fused float32: the fold must be numerically exact
    d = _diff(ref_boxes, _detect_all(detector(half=False, fuse_bn=True), frames),
              "fp32_unfused", "fp32_bn_fused")
    report["diffs"].append(d)
    fused_ok = d["max_box_delta_px"] < 0.05 and d["total_unmatched"] == 0

    # the bf16 fused deploy model: small drift expected
    report["diffs"].append(_diff(
        ref_boxes, _detect_all(detector(half=True, fuse_bn=True), frames),
        "fp32_unfused", "bf16_bn_fused"))

    # the definitive check where the ultralytics package is importable
    try:
        from ultralytics import YOLO  # type: ignore

        if weights.endswith((".pt", ".pth")):
            yolo = YOLO(weights)
            ultra = []
            for f in frames:
                r = yolo.predict(f, conf=args.conf, imgsz=args.input_size, verbose=False)[0]
                ultra.append({
                    "boxes": r.boxes.xyxy.cpu().numpy().tolist(),
                    "scores": r.boxes.conf.cpu().numpy().tolist(),
                    "classes": r.boxes.cls.cpu().numpy().astype(int).tolist()})
            du = _diff(ref_boxes, ultra, "fp32_unfused", "ultralytics_torch")
            report["diffs"].append(du)
            report["ultralytics_parity"] = (du["max_box_delta_px"] < 1.0
                                            and du["total_unmatched"] == 0)
    except ImportError:
        report["ultralytics_parity"] = "unavailable (ultralytics not installed)"

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print(f"verify_parity_torch: {len(frames)} images")
    for d in report["diffs"]:
        print(f"  {d['a']} vs {d['b']}: max box delta {d['max_box_delta_px']:.4f}px, "
              f"score delta {d['max_score_delta']:.4f}, unmatched {d['total_unmatched']}")
    print(f"  report -> {args.out}")
    if not fused_ok:
        print("verify_parity_torch: FAIL - BN fusion is not numerically exact")
        return 1
    print("verify_parity_torch: OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
