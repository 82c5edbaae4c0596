"""Synthetic scenes for tests and smoke runs (no dataset downloads).

The port's copies of the reference package's generators of the same names,
pixel for pixel: ``moving_boxes_frame`` (numpy only), ``write_synthetic_video``
and ``dense_moving_scene`` (cv2 draws the shapes and writes the file; it is
imported inside the functions that need it)."""

from __future__ import annotations

import numpy as np


def moving_boxes_frame(t: int, h: int = 720, w: int = 1280, n_objects: int = 6,
                       seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """Frame t of a deterministic scene of colored rectangles bouncing off
    the frame edges at constant speed.  Returns (BGR uint8 (h, w, 3),
    gt boxes (n, 4) xyxy float32)."""
    rng = np.random.default_rng(seed)
    base_xy = rng.uniform([0.05, 0.05], [0.7, 0.7], (n_objects, 2))
    sizes = rng.uniform([0.06, 0.1], [0.12, 0.22], (n_objects, 2))
    vel = rng.uniform(-0.01, 0.01, (n_objects, 2))
    colors = rng.integers(60, 255, (n_objects, 3))

    frame = np.full((h, w, 3), 30, np.uint8)
    boxes = np.zeros((n_objects, 4), np.float32)
    for i in range(n_objects):
        span = 1.0 - sizes[i]
        pos = base_xy[i] + vel[i] * t
        pos = np.abs(((pos / span) % 2.0) - 1.0) * span   # reflect off the walls
        x1, y1 = int(pos[0] * w), int(pos[1] * h)
        x2, y2 = int((pos[0] + sizes[i][0]) * w), int((pos[1] + sizes[i][1]) * h)
        frame[y1:y2, x1:x2] = colors[i]
        boxes[i] = (x1, y1, x2, y2)
    return frame, boxes


def write_synthetic_video(path: str, frames: int = 100, h: int = 720, w: int = 1280,
                          n_objects: int = 6, fps: float = 30.0, seed: int = 0) -> None:
    """Write ``frames`` frames of ``moving_boxes_frame`` to ``path`` (mp4v)."""
    import cv2

    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    if not vw.isOpened():
        raise RuntimeError(f"cannot open video writer for {path}")
    for t in range(frames):
        frame, _ = moving_boxes_frame(t, h, w, n_objects, seed)
        vw.write(frame)
    vw.release()


SHAPE_CLASSES = ["box", "disc", "triangle", "ring", "cross", "diamond",
                 "stripe_v", "star"]


def _draw_shape(frame, cls: int, cx: int, cy: int, s: int, color) -> list:
    """Draw one SHAPE_CLASSES[cls] instance; returns its xyxy box."""
    import cv2

    x1, y1, x2, y2 = cx - s, cy - s, cx + s, cy + s
    name = SHAPE_CLASSES[cls]
    if name == "box":
        cv2.rectangle(frame, (x1, y1), (x2, y2), color, -1)
    elif name == "disc":
        cv2.circle(frame, (cx, cy), s, color, -1)
    elif name == "triangle":
        pts = np.array([[cx, y1], [x1, y2], [x2, y2]], np.int32)
        cv2.fillPoly(frame, [pts], color)
    elif name == "ring":
        cv2.circle(frame, (cx, cy), s, color, max(3, s // 3))
    elif name == "cross":
        t_ = max(3, s // 3)
        cv2.rectangle(frame, (cx - t_, y1), (cx + t_, y2), color, -1)
        cv2.rectangle(frame, (x1, cy - t_), (x2, cy + t_), color, -1)
    elif name == "diamond":
        pts = np.array([[cx, y1], [x2, cy], [cx, y2], [x1, cy]], np.int32)
        cv2.fillPoly(frame, [pts], color)
    elif name == "stripe_v":
        t_ = max(3, s // 2)
        cv2.rectangle(frame, (cx - t_, y1), (cx + t_, y2), color, -1)
    elif name == "star":
        a = np.linspace(-np.pi / 2, 1.5 * np.pi, 11)[:-1]
        r = np.where(np.arange(10) % 2 == 0, s, s * 0.45)
        pts = np.stack([cx + r * np.cos(a), cy + r * np.sin(a)], -1)
        cv2.fillPoly(frame, [pts.astype(np.int32)], color)
    return [x1, y1, x2, y2]


def dense_moving_scene(
    t: int,
    h: int = 720,
    w: int = 1280,
    n_objects: int = 64,
    n_classes: int = 8,
    seed: int = 0,
):
    """Frame t of a dense scene of PERSISTENT moving shapes.

    Unlike ``cluttered_scene`` (independent random placement per frame, for
    detector training), every object here keeps its (class, size, color)
    identity and bounces with constant velocity - so consecutive frames are
    a real tracking sequence and steady-state tracker occupancy scales with
    ``n_objects``.  Sizes shrink as density grows so crowds stay largely
    visible.  Deterministic in (t, seed).

    Returns (frame BGR uint8, gt_boxes (N, 4) xyxy f32, labels (N,) i32,
    ids (N,) i32) with >70%-occluded boxes dropped from the GT like
    ``cluttered_scene``; ``ids`` are the persistent per-object identities
    (stable across frames - usable as MOT ground-truth track ids).
    """
    rng = np.random.default_rng(seed)
    n_classes = min(n_classes, len(SHAPE_CLASSES))
    # persistent identity attributes (independent of t)
    cls = rng.integers(0, n_classes, n_objects)
    # scale target: keep total object area <= ~45% of the canvas
    s_hi = 0.5 * np.sqrt(0.45 * h * w / max(1, n_objects))
    sizes = np.maximum(14, rng.uniform(0.55, 1.0, n_objects) * s_hi).astype(int)
    colors = rng.integers(90, 255, (n_objects, 3))
    base = rng.uniform(0.0, 1.0, (n_objects, 2))
    vel = rng.uniform(0.004, 0.012, (n_objects, 2)) * rng.choice(
        [-1.0, 1.0], (n_objects, 2))

    # textured background (per-scene, deterministic; same family the rich
    # training set uses so trained checkpoints transfer)
    bg_rng = np.random.default_rng(seed ^ 0x5EED)
    gy, gx = np.mgrid[0:h, 0:w].astype(np.float32)
    ang = bg_rng.uniform(0, 2 * np.pi)
    grad = np.cos(ang) * gx / w + np.sin(ang) * gy / h
    grad = (grad - grad.min()) / (np.ptp(grad) + 1e-9)
    bg = (30 + 70 * grad)[..., None] * bg_rng.uniform(0.5, 1.0, (3,))
    frame = np.clip(bg + bg_rng.normal(0, 8, (h, w, 3)), 0, 255).astype(np.uint8)

    boxes, labels = [], []
    for i in range(n_objects):
        s = int(sizes[i])
        span_x = max(1, w - 2 * s)
        span_y = max(1, h - 2 * s)
        px = abs(((base[i, 0] + vel[i, 0] * t) % 2.0) - 1.0)
        py = abs(((base[i, 1] + vel[i, 1] * t) % 2.0) - 1.0)
        cx = s + int(px * span_x)
        cy = s + int(py * span_y)
        color = tuple(int(c) for c in colors[i])
        boxes.append(_draw_shape(frame, int(cls[i]), cx, cy, s, color))
        labels.append(int(cls[i]))

    boxes_a = np.asarray(boxes, np.float32)
    keep = _occlusion_keep(boxes_a)
    boxes_a = np.clip(boxes_a[keep], 0, [w - 1, h - 1, w - 1, h - 1])
    return (frame, boxes_a, np.asarray(labels, np.int32)[keep],
            np.arange(n_objects, dtype=np.int32)[keep])


def _occlusion_keep(boxes_a: np.ndarray, thresh: float = 0.7) -> np.ndarray:
    """Keep-mask dropping boxes whose area is > thresh covered by any single
    later-drawn (= on top) box."""
    n = len(boxes_a)
    keep = np.ones(n, bool)
    for i in range(n):
        xi1, yi1, xi2, yi2 = boxes_a[i]
        area = max(1.0, (xi2 - xi1) * (yi2 - yi1))
        covered = 0.0
        for j in range(i + 1, n):
            xj1, yj1, xj2, yj2 = boxes_a[j]
            iw = max(0.0, min(xi2, xj2) - max(xi1, xj1))
            ih = max(0.0, min(yi2, yj2) - max(yi1, yj1))
            covered = max(covered, iw * ih)
        if covered / area > thresh:
            keep[i] = False
    return keep
