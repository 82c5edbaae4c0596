"""Training data pipeline: YOLO-format datasets with mosaic, mixup,
copy-paste, random affine, HSV and flip augmentation (port of
``rtmodt_tpu/training/data.py``).

Host-side NumPy/OpenCV producing fixed-shape ``Batch``es (uint8 RGB images
letterboxed to ``input_size``, GT padded to ``max_boxes``) with a background
prefetch thread.  Every draw comes from ``np.random.default_rng(seed)`` in
the reference's order, so the batches are the reference's byte for byte.
The images stay uint8 until the card divides them by 255
(``train_step.to_model_input``).  cv2 is imported inside the methods.

Dataset layout (YOLO convention, as written by ``tools/download_dataset.py``):
  root/images/{split}/*.jpg + root/labels/{split}/*.txt
  label rows: ``class cx cy w h`` normalized to [0, 1].
"""

from __future__ import annotations

import os
import queue
import threading
from dataclasses import dataclass

import numpy as np

import torch

from rtmodt_tpu_torch.training.train_step import Batch
from rtmodt_tpu_torch.utils.logging import logger


@dataclass
class AugConfig:
    """Reference training.yaml:28-41 augmentation surface."""

    mosaic: float = 1.0
    mixup: float = 0.15         # blend two mosaics (Beta(32,32) lambda)
    copy_paste: float = 0.1     # paste GT box crops from a donor image
    fliplr: float = 0.5
    flipud: float = 0.0
    hsv_h: float = 0.015
    hsv_s: float = 0.7
    hsv_v: float = 0.4
    degrees: float = 5.0        # random-affine rotation (deg)
    scale: float = 0.5          # random-affine scale +- fraction
    shear: float = 2.0          # random-affine shear (deg)
    translate: float = 0.1      # random-affine translation fraction


class YoloDataset:
    def __init__(self, root: str, split: str = "train", input_size: int = 640,
                 max_boxes: int = 64, augment: bool = True,
                 aug: AugConfig | None = None, seed: int = 0,
                 cache_images: bool | None = None):
        self.root = root
        self.input_size = input_size
        self.max_boxes = max_boxes
        self.augment = augment
        self.aug = aug or AugConfig()
        self.rng = np.random.default_rng(seed)

        img_dir = os.path.join(root, "images", split)
        lbl_dir = os.path.join(root, "labels", split)
        if not os.path.isdir(img_dir):
            raise FileNotFoundError(f"no image dir: {img_dir}")
        self.items: list[tuple[str, str]] = []
        for f in sorted(os.listdir(img_dir)):
            if f.lower().endswith((".jpg", ".jpeg", ".png")):
                stem = os.path.splitext(f)[0]
                self.items.append((os.path.join(img_dir, f),
                                   os.path.join(lbl_dir, stem + ".txt")))
        if not self.items:
            raise FileNotFoundError(f"no images in {img_dir}")
        # Decoded-image RAM cache: mosaic reads 4 (4.6 with mixup) random
        # images per sample, so JPEG decode dominates the producer on small
        # sets.  On when the decoded set fits the budget, estimated from one
        # decoded sample (JPEGs compress 7-40x, so file bytes mislead).
        if cache_images is None:
            import cv2

            sample = cv2.imread(self.items[0][0])
            est = (sample.nbytes if sample is not None else 3 * 720 * 1280
                   ) * len(self.items)
            cache_images = est < 16 * 1024 ** 3
        self._cache: list | None = [None] * len(self.items) if cache_images else None
        logger.info(f"dataset {split}: {len(self.items)} images "
                    f"(decode cache {'on' if cache_images else 'off'})")

    def __len__(self) -> int:
        return len(self.items)

    # ------------------------------------------------------------------
    def _load_raw(self, idx: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """-> (image BGR, boxes xyxy pixel, labels).

        Cached entries are returned by reference: every downstream transform
        (mosaic resize, letterbox, ``boxes * r``) allocates fresh arrays, so
        the decoded source is never written through.
        """
        import cv2

        if self._cache is not None:
            idx = int(idx)
            hit = self._cache[idx]
            if hit is not None:
                return hit
        img_path, lbl_path = self.items[idx]
        img = cv2.imread(img_path)
        if img is None:
            # one corrupt file must not kill the producer thread (which
            # would silently hang the training loop on q.get)
            logger.warning(f"unreadable image {img_path}; substituting blank")
            return (np.full((64, 64, 3), 114, np.uint8),
                    np.zeros((0, 4), np.float32), np.zeros((0,), np.int32))
        h, w = img.shape[:2]
        boxes, labels = [], []
        if os.path.exists(lbl_path):
            with open(lbl_path) as f:
                for line in f:
                    p = line.split()
                    if len(p) < 5:
                        continue
                    c, cx, cy, bw, bh = int(p[0]), *map(float, p[1:5])
                    boxes.append([(cx - bw / 2) * w, (cy - bh / 2) * h,
                                  (cx + bw / 2) * w, (cy + bh / 2) * h])
                    labels.append(c)
        out = (img, np.asarray(boxes, np.float32).reshape(-1, 4),
               np.asarray(labels, np.int32))
        if self._cache is not None:
            self._cache[idx] = out
        return out

    def _letterbox_sample(self, img, boxes):
        import cv2

        s = self.input_size
        h, w = img.shape[:2]
        r = min(s / h, s / w)
        nh, nw = round(h * r), round(w * r)
        img = cv2.resize(img, (nw, nh), interpolation=cv2.INTER_LINEAR)
        top = (s - nh) // 2
        left = (s - nw) // 2
        canvas = np.full((s, s, 3), 114, np.uint8)
        canvas[top:top + nh, left:left + nw] = img
        if len(boxes):
            boxes = boxes * r + np.array([left, top, left, top], np.float32)
        return canvas, boxes

    def _mosaic(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """4-image mosaic at 2x then random-crop back to input_size."""
        import cv2

        s = self.input_size
        canvas = np.full((2 * s, 2 * s, 3), 114, np.uint8)
        all_boxes, all_labels = [], []
        cx = int(self.rng.uniform(0.5, 1.5) * s)
        cy = int(self.rng.uniform(0.5, 1.5) * s)
        for qi, (x0, y0, x1, y1) in enumerate([
            (0, 0, cx, cy), (cx, 0, 2 * s, cy),
            (0, cy, cx, 2 * s), (cx, cy, 2 * s, 2 * s),
        ]):
            img, boxes, labels = self._load_raw(self.rng.integers(len(self.items)))
            qw, qh = x1 - x0, y1 - y0
            ih, iw = img.shape[:2]
            r = max(qw / iw, qh / ih)
            img = cv2.resize(img, (int(iw * r) + 1, int(ih * r) + 1))
            ox = self.rng.integers(0, max(img.shape[1] - qw, 0) + 1)
            oy = self.rng.integers(0, max(img.shape[0] - qh, 0) + 1)
            canvas[y0:y1, x0:x1] = img[oy:oy + qh, ox:ox + qw]
            if len(boxes):
                b = boxes * r
                # clip to the pasted window and drop slivers: a box outside
                # [ox, oy, ox+qw, oy+qh] would otherwise translate into a
                # NEIGHBORING quadrant and label another image's pixels
                b[:, 0::2] = b[:, 0::2].clip(ox, ox + qw)
                b[:, 1::2] = b[:, 1::2].clip(oy, oy + qh)
                keep = ((b[:, 2] - b[:, 0]) > 2) & ((b[:, 3] - b[:, 1]) > 2)
                b = b[keep]
                b -= np.array([ox, oy, ox, oy], np.float32)
                b += np.array([x0, y0, x0, y0], np.float32)
                all_boxes.append(b)
                all_labels.append(np.asarray(labels)[keep])
            del qi
        boxes = np.concatenate(all_boxes) if all_boxes else np.zeros((0, 4), np.float32)
        labels = np.concatenate(all_labels) if all_labels else np.zeros((0,), np.int32)
        # random crop window of size s
        jx = self.rng.integers(0, s + 1)
        jy = self.rng.integers(0, s + 1)
        crop = canvas[jy:jy + s, jx:jx + s]
        if len(boxes):
            boxes -= np.array([jx, jy, jx, jy], np.float32)
        return crop, boxes, labels

    def _random_affine(self, img, boxes, labels):
        """Rotation/scale/shear/translate around the image center
        (ultralytics-style post-mosaic affine), border filled 114."""
        import cv2

        a = self.aug
        s = img.shape[0]
        deg = self.rng.uniform(-a.degrees, a.degrees)
        scale = 1.0 + self.rng.uniform(-a.scale, a.scale)
        shx = np.tan(np.radians(self.rng.uniform(-a.shear, a.shear)))
        shy = np.tan(np.radians(self.rng.uniform(-a.shear, a.shear)))
        tx = self.rng.uniform(-a.translate, a.translate) * s
        ty = self.rng.uniform(-a.translate, a.translate) * s

        c, si = np.cos(np.radians(deg)) * scale, np.sin(np.radians(deg)) * scale
        rot = np.array([[c, -si], [si, c]], np.float32)
        sh = np.array([[1, shx], [shy, 1]], np.float32)
        lin = rot @ sh
        ctr = s / 2.0
        off = np.array([ctr + tx, ctr + ty], np.float32) - lin @ np.array([ctr, ctr], np.float32)
        m = np.concatenate([lin, off[:, None]], axis=1)     # (2, 3)
        img = cv2.warpAffine(img, m, (s, s), borderValue=(114, 114, 114))
        if len(boxes):
            corners = boxes[:, [0, 1, 2, 1, 2, 3, 0, 3]].reshape(-1, 2)  # (4N, 2)
            warped = corners @ lin.T + off
            warped = warped.reshape(-1, 4, 2)
            nb = np.concatenate([warped.min(axis=1), warped.max(axis=1)], axis=1)
            nb = np.clip(nb, 0, s).astype(np.float32)
            # candidate filter: survive if still a sane, mostly-visible box
            w0 = boxes[:, 2] - boxes[:, 0]
            h0 = boxes[:, 3] - boxes[:, 1]
            w1 = nb[:, 2] - nb[:, 0]
            h1 = nb[:, 3] - nb[:, 1]
            keep = ((w1 > 2) & (h1 > 2)
                    & (w1 * h1 / np.maximum(w0 * h0 * scale * scale, 1e-6) > 0.1)
                    & (np.maximum(w1 / np.maximum(h1, 1e-6),
                                  h1 / np.maximum(w1, 1e-6)) < 100))
            boxes, labels = nb[keep], labels[keep]
        return img, boxes, labels

    def _copy_paste(self, img, boxes, labels):
        """Paste up to 4 GT box crops from a random donor image at low-overlap
        positions (bbox-level approximation of segment copy-paste)."""
        donor_img, donor_boxes, donor_labels = self._load_raw(
            int(self.rng.integers(len(self.items))))
        if not len(donor_boxes):
            return img, boxes, labels
        s = img.shape[0]
        new_boxes = list(boxes)
        new_labels = list(labels)
        order = self.rng.permutation(len(donor_boxes))[:4]
        for i in order:
            x1, y1, x2, y2 = donor_boxes[i].astype(int)
            crop = donor_img[max(y1, 0):y2, max(x1, 0):x2]
            ch, cw = crop.shape[:2]
            if ch < 4 or cw < 4 or ch >= s or cw >= s:
                continue
            px = int(self.rng.integers(0, s - cw))
            py = int(self.rng.integers(0, s - ch))
            cand = np.array([px, py, px + cw, py + ch], np.float32)
            # skip placements covering existing objects (>30% of their area)
            occluded = False
            for b in new_boxes:
                ix = max(0.0, min(cand[2], b[2]) - max(cand[0], b[0]))
                iy = max(0.0, min(cand[3], b[3]) - max(cand[1], b[1]))
                area = max((b[2] - b[0]) * (b[3] - b[1]), 1e-6)
                if ix * iy / area > 0.3:
                    occluded = True
                    break
            if occluded:
                continue
            img[py:py + ch, px:px + cw] = crop
            new_boxes.append(cand)
            new_labels.append(donor_labels[i])
        return (img,
                np.asarray(new_boxes, np.float32).reshape(-1, 4),
                np.asarray(new_labels, np.int32))

    def _mosaic_sample(self):
        """One fully spatially-augmented sample: mosaic -> copy_paste -> affine."""
        img, boxes, labels = self._mosaic()
        if self.rng.random() < self.aug.copy_paste:
            img, boxes, labels = self._copy_paste(img, boxes, labels)
        return self._random_affine(img, boxes, labels)

    def _hsv(self, img: np.ndarray) -> np.ndarray:
        """Channel-gain HSV jitter via 256-entry LUTs.

        The gains are per-image scalars, so the per-pixel float map is a
        pure function of the 8-bit channel value — three ``cv2.LUT`` table
        lookups replace the full-image float32 round trip (~25 ms -> ~3 ms
        at 640 px on one core; identical output by construction).
        """
        import cv2

        a = self.aug
        gains = 1.0 + self.rng.uniform(-1, 1, 3) * [a.hsv_h, a.hsv_s, a.hsv_v]
        h, s, v = cv2.split(cv2.cvtColor(img, cv2.COLOR_BGR2HSV))
        x = np.arange(256, dtype=np.float32)
        lut_h = ((x * gains[0]) % 180).astype(np.uint8)
        lut_s = np.clip(x * gains[1], 0, 255).astype(np.uint8)
        lut_v = np.clip(x * gains[2], 0, 255).astype(np.uint8)
        hsv = cv2.merge((cv2.LUT(h, lut_h), cv2.LUT(s, lut_s), cv2.LUT(v, lut_v)))
        return cv2.cvtColor(hsv, cv2.COLOR_HSV2BGR)

    def sample(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        s = self.input_size
        if self.augment and self.rng.random() < self.aug.mosaic:
            img, boxes, labels = self._mosaic_sample()
            if self.rng.random() < self.aug.mixup:
                # blend a second augmented mosaic; union of both GT sets
                img2, boxes2, labels2 = self._mosaic_sample()
                lam = float(self.rng.beta(32.0, 32.0))
                img = (img.astype(np.float32) * lam
                       + img2.astype(np.float32) * (1 - lam)).astype(np.uint8)
                boxes = np.concatenate([boxes, boxes2])
                labels = np.concatenate([labels, labels2])
        else:
            img, boxes, labels = self._load_raw(self.rng.integers(len(self.items)))
            img, boxes = self._letterbox_sample(img, boxes)
        if self.augment:
            img = self._hsv(img)
            if self.rng.random() < self.aug.fliplr:
                img = img[:, ::-1]
                if len(boxes):
                    boxes[:, [0, 2]] = s - boxes[:, [2, 0]]
            if self.rng.random() < self.aug.flipud:
                img = img[::-1]
                if len(boxes):
                    boxes[:, [1, 3]] = s - boxes[:, [3, 1]]
        # clip + drop degenerate boxes
        if len(boxes):
            boxes = np.clip(boxes, 0, s)
            keep = ((boxes[:, 2] - boxes[:, 0]) > 2) & ((boxes[:, 3] - boxes[:, 1]) > 2)
            boxes, labels = boxes[keep], labels[keep]
        return img, boxes, labels

    def make_batch(self, batch_size: int) -> Batch:
        s, m = self.input_size, self.max_boxes
        images = np.zeros((batch_size, s, s, 3), np.uint8)
        gt_boxes = np.zeros((batch_size, m, 4), np.float32)
        gt_labels = np.zeros((batch_size, m), np.int32)
        gt_mask = np.zeros((batch_size, m), bool)
        for i in range(batch_size):
            img, boxes, labels = self.sample()
            images[i] = img[..., ::-1]  # BGR -> RGB (model convention)
            n = min(len(boxes), m)
            gt_boxes[i, :n] = boxes[:n]
            gt_labels[i, :n] = labels[:n]
            gt_mask[i, :n] = True
        return Batch(torch.from_numpy(images), torch.from_numpy(gt_boxes),
                     torch.from_numpy(gt_labels), torch.from_numpy(gt_mask))

    def batches(self, batch_size: int, prefetch: int = 2, pin: bool = False):
        """Generator with a background producer thread.  ``pin`` puts each
        batch in page-locked memory on that thread, so that its copy to the
        card does not wait for the work already queued there."""
        q: queue.Queue = queue.Queue(maxsize=prefetch)
        stop = threading.Event()

        def producer():
            while not stop.is_set():
                # build ONCE, then retry the put: rebuilding a full
                # mosaic+affine batch on every queue-full timeout burns a
                # batch of augmentation CPU per second whenever the host
                # outpaces the device
                batch = self.make_batch(batch_size)
                if pin:
                    batch = Batch(*(x.pin_memory() for x in batch))
                while not stop.is_set():
                    try:
                        q.put(batch, timeout=1.0)
                        break
                    except queue.Full:
                        continue

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                yield q.get()
        finally:
            stop.set()
