"""Synthetic scenes for tests and smoke runs (no dataset downloads).

The port's copies of the reference package's generators of the same names,
pixel for pixel: ``moving_boxes_frame`` (numpy only), ``write_synthetic_video``,
``dense_moving_scene``, ``cluttered_scene`` and ``reid_patch`` (cv2 draws the
shapes and writes the file; it is imported inside the functions that need
it)."""

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


def cluttered_scene(
    idx: int,
    h: int = 512,
    w: int = 512,
    n_classes: int = 8,
    min_objects: int = 3,
    max_objects: int = 14,
    seed: int = 0,
):
    """Render one multi-class detection scene with clutter and occlusion.

    A harder synthetic than ``moving_boxes_frame`` (training data for more
    than single-class rectangles): 8 shape classes at 3x scale variation, textured gradient+noise
    background, distractor strokes that are NOT objects, and real occlusion
    (later shapes draw over earlier ones; boxes with > 70% of their area
    covered are dropped from the labels, like crowd-filtered GT).

    Deterministic in (idx, seed).  Returns (frame BGR uint8, boxes (N,4)
    xyxy f32, labels (N,) i32).
    """
    import cv2

    rng = np.random.default_rng((seed << 20) ^ idx)
    n_classes = min(n_classes, len(SHAPE_CLASSES))

    # background: directional gradient + per-pixel noise + big soft blobs
    gy, gx = np.mgrid[0:h, 0:w].astype(np.float32)
    ang = rng.uniform(0, 2 * np.pi)
    base = (np.cos(ang) * gx / w + np.sin(ang) * gy / h)
    base = (base - base.min()) / (np.ptp(base) + 1e-9)
    bg = (30 + 70 * base)[..., None] * rng.uniform(0.5, 1.0, (3,))
    frame = np.clip(bg + rng.normal(0, 12, (h, w, 3)), 0, 255).astype(np.uint8)
    for _ in range(rng.integers(2, 6)):       # distractor strokes (no label)
        p1 = rng.integers(0, [w, h]); p2 = rng.integers(0, [w, h])
        cv2.line(frame, tuple(p1), tuple(p2),
                 tuple(int(c) for c in rng.integers(40, 120, 3)),
                 int(rng.integers(1, 4)))

    n = int(rng.integers(min_objects, max_objects + 1))
    order = []
    for _ in range(n):
        cls = int(rng.integers(0, n_classes))
        s = int(rng.uniform(0.05, 0.16) * min(h, w) * rng.choice([1.0, 1.0, 2.0]))
        s = max(12, min(s, min(h, w) // 3))
        cx = int(rng.uniform(s, w - s)); cy = int(rng.uniform(s, h - s))
        color = tuple(int(c) for c in rng.integers(90, 255, 3))
        order.append((cls, cx, cy, s, color))

    boxes, labels = [], []
    for cls, cx, cy, s, color in order:
        boxes.append(_draw_shape(frame, cls, cx, cy, s, color))
        labels.append(cls)

    # occlusion filter: drop a box when later shapes cover > 70% of it
    boxes_a = np.asarray(boxes, np.float32)
    keep = _occlusion_keep(boxes_a)
    boxes_a = np.clip(boxes_a[keep], 0, [w - 1, h - 1, w - 1, h - 1])
    return frame, boxes_a, np.asarray(labels, np.int32)[keep]


def reid_patch(
    identity: int,
    view: int,
    hw: tuple[int, int] = (64, 32),
    seed: int = 0,
):
    """Render one augmented view of a persistent synthetic identity.

    An identity is a (shape, base color, stripe texture) triple; views vary
    pose (shift/scale/rotation), background, lighting, noise, and partial
    occlusion - the supervision signal for training the DeepSORT appearance
    embedder on re-identification (tools/train_embedder.py).  Deterministic
    in (identity, view, seed).  Returns uint8 BGR (h, w, 3).
    """
    import cv2

    h, w = hw
    id_rng = np.random.default_rng((seed << 24) ^ (identity * 2 + 1))
    vw_rng = np.random.default_rng((seed << 24) ^ (identity * 2 + 1) ^ (view * 0x9E3779B9 + 7))

    color = id_rng.integers(70, 255, 3)
    color2 = id_rng.integers(40, 220, 3)
    shape = int(id_rng.integers(0, 5))
    n_stripes = int(id_rng.integers(0, 4))
    stripe_vertical = bool(id_rng.integers(0, 2))

    # view augmentation
    light = vw_rng.uniform(0.6, 1.3)
    bgc = vw_rng.integers(10, 90, 3)
    big = max(h, w) * 2
    canvas = np.clip(
        bgc[None, None] + vw_rng.normal(0, 10, (big, big, 3)), 0, 255
    ).astype(np.uint8)
    cx = cy = big // 2
    s = int(min(h, w) * vw_rng.uniform(0.55, 0.95))
    c1 = tuple(int(np.clip(c * light, 0, 255)) for c in color)
    c2 = tuple(int(np.clip(c * light, 0, 255)) for c in color2)
    if shape == 0:
        cv2.rectangle(canvas, (cx - s, cy - int(s * 1.4)),
                      (cx + s, cy + int(s * 1.4)), c1, -1)
    elif shape == 1:
        cv2.ellipse(canvas, (cx, cy), (s, int(s * 1.4)), 0, 0, 360, c1, -1)
    elif shape == 2:
        pts = np.array([[cx, cy - int(s * 1.4)], [cx - s, cy + s],
                        [cx + s, cy + s]], np.int32)
        cv2.fillPoly(canvas, [pts], c1)
    elif shape == 3:
        cv2.circle(canvas, (cx, cy), s, c1, max(3, s // 3))
    else:
        cv2.rectangle(canvas, (cx - s, cy - int(s * 1.4)),
                      (cx + s, cy + int(s * 1.4)), c1, -1)
        cv2.circle(canvas, (cx, cy), s // 2, c2, -1)
    for k in range(n_stripes):      # identity texture
        off = int((k + 1) * s / (n_stripes + 1))
        if stripe_vertical:
            cv2.line(canvas, (cx - s + 2 * off, cy - int(s * 1.4)),
                     (cx - s + 2 * off, cy + int(s * 1.4)), c2, max(2, s // 8))
        else:
            cv2.line(canvas, (cx - s, cy - int(s * 1.4) + 2 * off),
                     (cx + s, cy - int(s * 1.4) + 2 * off), c2, max(2, s // 8))

    # pose: rotate + shift, then crop the (h, w) window
    ang = vw_rng.uniform(-25, 25)
    m = cv2.getRotationMatrix2D((cx, cy), ang, 1.0)
    canvas = cv2.warpAffine(canvas, m, (big, big))
    dx, dy = vw_rng.integers(-s // 3, s // 3 + 1, 2)
    y0 = cy - h // 2 + dy
    x0 = cx - w // 2 + dx
    patch = canvas[y0:y0 + h, x0:x0 + w].copy()
    if vw_rng.random() < 0.3:       # partial occlusion bar
        oh = int(h * vw_rng.uniform(0.15, 0.4))
        oy = int(vw_rng.integers(0, h - oh))
        patch[oy:oy + oh] = vw_rng.integers(0, 255, 3)
    patch = np.clip(patch + vw_rng.normal(0, 8, patch.shape), 0, 255)
    return patch.astype(np.uint8)
