"""The offline dataset writers of ``tools/download_dataset.py``: synthetic
YOLO-layout sets with COCO (and MOT) ground truth, and dense tracking
sequences, byte for byte as the reference writes them (the same scenes from
``utils/synthetic.py``, the same JPEG / PNG encoder calls, the same label
and JSON text).  The reference's download branches need the network and are
not here.  cv2 is imported inside the writers.

CLI: ``tools/make_dataset_torch.py``.
"""

from __future__ import annotations

import json
import os

import numpy as np

from rtmodt_tpu_torch.utils.logging import logger


def make_synthetic(root: str, n_train: int, n_val: int, h: int, w: int,
                   n_objects: int, seed: int) -> None:
    """Generate a YOLO-layout dataset + COCO GT + MOT GT from the synthetic
    scene generator (zero-egress fallback)."""
    import cv2

    from rtmodt_tpu_torch.utils.synthetic import moving_boxes_frame

    coco = {"images": [], "annotations": [], "categories": [{"id": 1, "name": "object"}]}
    aid = 1
    mot_rows = []
    for split, count, offset in (("train", n_train, 0), ("val", n_val, n_train)):
        img_dir = os.path.join(root, "images", split)
        lbl_dir = os.path.join(root, "labels", split)
        os.makedirs(img_dir, exist_ok=True)
        os.makedirs(lbl_dir, exist_ok=True)
        for i in range(count):
            t = offset + i
            frame, boxes = moving_boxes_frame(t, h, w, n_objects, seed)
            name = f"{t:06d}"
            cv2.imwrite(os.path.join(img_dir, name + ".jpg"), frame)
            with open(os.path.join(lbl_dir, name + ".txt"), "w") as f:
                for b in boxes:
                    cx, cy = (b[0] + b[2]) / 2 / w, (b[1] + b[3]) / 2 / h
                    bw, bh = (b[2] - b[0]) / w, (b[3] - b[1]) / h
                    f.write(f"0 {cx:.6f} {cy:.6f} {bw:.6f} {bh:.6f}\n")
            if split == "val":
                img_id = t
                coco["images"].append({"id": img_id, "file_name": name + ".jpg",
                                       "width": w, "height": h})
                for oi, b in enumerate(boxes):
                    coco["annotations"].append({
                        "id": aid, "image_id": img_id, "category_id": 1,
                        "bbox": [float(b[0]), float(b[1]),
                                 float(b[2] - b[0]), float(b[3] - b[1])],
                        "area": float((b[2] - b[0]) * (b[3] - b[1])),
                        "iscrowd": 0})
                    aid += 1
                    mot_rows.append(f"{i+1},{oi+1},{b[0]:.1f},{b[1]:.1f},"
                                    f"{b[2]-b[0]:.1f},{b[3]-b[1]:.1f},1,-1,-1,-1")
    with open(os.path.join(root, "val_coco_gt.json"), "w") as f:
        json.dump(coco, f)
    with open(os.path.join(root, "val_mot_gt.txt"), "w") as f:
        f.write("\n".join(mot_rows) + "\n")
    with open(os.path.join(root, "dataset.yaml"), "w") as f:
        f.write(f"path: {os.path.abspath(root)}\ntrain: images/train\n"
                f"val: images/val\nnames:\n  0: object\n")
    logger.info(f"synthetic dataset at {root}: {n_train} train / {n_val} val")


def make_synthetic_rich(root: str, n_train: int, n_val: int, h: int, w: int,
                        n_classes: int, seed: int,
                        dense_frac: float = 0.0) -> None:
    """coco128-scale multi-class synthetic: 8 shape classes, occlusion,
    distractor clutter (utils/synthetic.py::cluttered_scene).  YOLO layout +
    COCO GT for the val split, same contract as ``make_synthetic``.

    ``dense_frac`` > 0 renders that fraction of each split as DENSE
    SMALL-OBJECT crowd frames (utils/synthetic.py::dense_moving_scene at
    720x1280, 24-64 objects, the deployment frame geometry) so a 640-input
    checkpoint's training distribution covers the ~20-40 px objects the
    dense-mot eval regime serves (a set of large objects alone left a 640
    checkpoint weak on crowds of small ones).  Seeds are offset from
    the eval generator's so no training frame repeats an eval sequence."""
    import cv2

    from rtmodt_tpu_torch.utils.synthetic import (SHAPE_CLASSES, cluttered_scene,
                                            dense_moving_scene)

    n_classes = min(n_classes, len(SHAPE_CLASSES))
    coco = {"images": [], "annotations": [],
            "categories": [{"id": c + 1, "name": SHAPE_CLASSES[c]}
                           for c in range(n_classes)]}
    aid = 1
    for split, count, offset in (("train", n_train, 0), ("val", n_val, n_train)):
        img_dir = os.path.join(root, "images", split)
        lbl_dir = os.path.join(root, "labels", split)
        os.makedirs(img_dir, exist_ok=True)
        os.makedirs(lbl_dir, exist_ok=True)
        for i in range(count):
            t = offset + i
            if dense_frac > 0 and (i % 10) < round(dense_frac * 10):
                # crowd frame: persistent-identity scene sampled at a
                # random phase; 0x9D0000 seed offset keeps it disjoint
                # from eval sequences (their seeds are small ints)
                d_rng = np.random.default_rng((seed << 16) ^ (0x9D0000 + t))
                frame, boxes, labels, _ = dense_moving_scene(
                    t=int(d_rng.integers(0, 400)), h=720, w=1280,
                    n_objects=int(d_rng.integers(24, 65)),
                    n_classes=n_classes,
                    seed=int(0x9D0000 + (seed << 10) + t))
            else:
                frame, boxes, labels = cluttered_scene(
                    t, h, w, n_classes=n_classes, seed=seed)
            name = f"{t:06d}"
            fh, fw = frame.shape[:2]        # dense frames are 720x1280
            cv2.imwrite(os.path.join(img_dir, name + ".jpg"), frame)
            with open(os.path.join(lbl_dir, name + ".txt"), "w") as f:
                for b, c in zip(boxes, labels):
                    cx, cy = (b[0] + b[2]) / 2 / fw, (b[1] + b[3]) / 2 / fh
                    bw, bh = (b[2] - b[0]) / fw, (b[3] - b[1]) / fh
                    f.write(f"{int(c)} {cx:.6f} {cy:.6f} {bw:.6f} {bh:.6f}\n")
            if split == "val":
                coco["images"].append({"id": t, "file_name": name + ".jpg",
                                       "width": fw, "height": fh})
                for b, c in zip(boxes, labels):
                    coco["annotations"].append({
                        "id": aid, "image_id": t, "category_id": int(c) + 1,
                        "bbox": [float(b[0]), float(b[1]),
                                 float(b[2] - b[0]), float(b[3] - b[1])],
                        "area": float((b[2] - b[0]) * (b[3] - b[1])),
                        "iscrowd": 0})
                    aid += 1
    with open(os.path.join(root, "val_coco_gt.json"), "w") as f:
        json.dump(coco, f)
    with open(os.path.join(root, "dataset.yaml"), "w") as f:
        names = "\n".join(f"  {c}: {SHAPE_CLASSES[c]}" for c in range(n_classes))
        f.write(f"path: {os.path.abspath(root)}\ntrain: images/train\n"
                f"val: images/val\nnames:\n{names}\n")
    logger.info(f"rich synthetic dataset at {root}: {n_train} train / "
               f"{n_val} val, {n_classes} classes")


def make_dense_mot(root: str, n_frames: int, h: int, w: int,
                   n_objects: int, seed: int) -> None:
    """Dense tracking sequence: PNG frames + MOT15-2D ground truth with
    PERSISTENT object ids (utils/synthetic.py::dense_moving_scene).  Feeds
    ``run_inference_torch.py track --video <root>/img --gt-mot <root>/gt.txt``
    for IDF1/MOTA at density (the quality companion to
    tools/bench_dense_torch.py's device-cost sweep)."""
    import cv2

    from rtmodt_tpu_torch.utils.synthetic import dense_moving_scene

    img_dir = os.path.join(root, "img")
    os.makedirs(img_dir, exist_ok=True)
    with open(os.path.join(root, "gt.txt"), "w") as f:
        for t in range(n_frames):
            frame, boxes, _labels, ids = dense_moving_scene(
                t, h, w, n_objects=n_objects, seed=seed)
            cv2.imwrite(os.path.join(img_dir, f"{t + 1:06d}.png"), frame)
            for b, oid in zip(boxes, ids):
                # MOT15-2D: frame, id, x, y, w, h, conf, -1, -1, -1 (1-based)
                f.write(f"{t + 1},{int(oid) + 1},{b[0]:.2f},{b[1]:.2f},"
                        f"{b[2] - b[0]:.2f},{b[3] - b[1]:.2f},1,-1,-1,-1\n")
    logger.info(f"dense MOT sequence at {root}: {n_frames} frames, "
               f"{n_objects} objects")
