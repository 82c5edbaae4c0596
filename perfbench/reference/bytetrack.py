"""Plain reference of ByteTrack over static track slots, one stream, numpy float32.

The algorithm the program's tracker states (``tracking.bytetrack``: Kalman
motion, IoU distance, greedy assignment, slot births in slot order):

  0. constant-velocity Kalman predict of every active slot (a diagonal
     per-coordinate filter: position and velocity blocks, noise scaled by
     the box height);
  1. detections split into high (score >= ``track_thresh``) and low
     (``low_thresh`` <= score < ``track_thresh``);
  2. high detections against every active slot, then low detections against
     the slots left unmatched, each by sequential greedy assignment on IoU
     (repeatedly the globally best pair with IoU >= 1 - ``match_thresh``);
     matched slots take a Kalman update;
  3. unmatched high detections with score >= ``new_track_thresh`` start
     tracks: the k-th such detection takes the k-th free slot, ids counting
     up from 1;
  4. slots unmatched for more than ``track_buffer`` frames are freed.

Visible tracks are the active slots matched in this frame."""

from __future__ import annotations

import numpy as np

POS, VEL = 1.0 / 20.0, 1.0 / 160.0
NEG = np.float32(-1e9)


def _stds(h: np.ndarray, w: float, a_std: float) -> np.ndarray:
    wh = (w * h).astype(h.dtype)
    return np.stack([wh, wh, np.full_like(h, a_std), wh], axis=-1)


def xyxy_to_cxcyah(b: np.ndarray) -> np.ndarray:
    w = b[..., 2] - b[..., 0]
    h = b[..., 3] - b[..., 1]
    half = b.dtype.type(0.5)
    return np.stack([b[..., 0] + half * w, b[..., 1] + half * h,
                     w / np.maximum(h, b.dtype.type(1e-6)), h], axis=-1)


def cxcyah_to_xyxy(m: np.ndarray) -> np.ndarray:
    h = m[..., 3]
    w = m[..., 2] * h
    half = m.dtype.type(0.5)
    x1 = m[..., 0] - half * w
    y1 = m[..., 1] - half * h
    return np.stack([x1, y1, x1 + w, y1 + h], axis=-1)


def iou_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    a, b = a[:, None, :], b[None, :, :]
    lt = np.maximum(a[..., :2], b[..., :2])
    rb = np.minimum(a[..., 2:], b[..., 2:])
    wh = np.maximum(rb - lt, 0)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    return inter / (area_a + area_b - inter + a.dtype.type(1e-7))


def greedy(sim: np.ndarray, thr: float, rows: np.ndarray, cols: np.ndarray
           ) -> tuple[np.ndarray, np.ndarray]:
    """Sequential greedy over the eligible rows and columns: (row -> col or
    -1, col -> row or -1)."""
    r2c = np.full(sim.shape[0], -1, np.int64)
    c2r = np.full(sim.shape[1], -1, np.int64)
    ri, ci = np.where(rows)[0], np.where(cols)[0]
    if len(ri) == 0 or len(ci) == 0:
        return r2c, c2r
    sub = sim[np.ix_(ri, ci)].astype(np.float32)
    sub = np.where(np.isnan(sub), NEG, sub)
    thr = np.float32(thr)
    while True:
        flat = int(np.argmax(sub))
        r, c = divmod(flat, sub.shape[1])
        if not sub[r, c] >= thr:
            break
        r2c[ri[r]], c2r[ci[c]] = ci[c], ri[r]
        sub[r, :] = NEG
        sub[:, c] = NEG
    return r2c, c2r


def round_bf16(x: np.ndarray) -> np.ndarray:
    """float32 values rounded to bfloat16's 8-bit mantissa (nearest, ties to
    even), still as float32."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32)
    u = (u + np.uint32(0x7FFF) + ((u >> np.uint32(16)) & np.uint32(1))) & np.uint32(0xFFFF0000)
    return u.view(np.float32)


class ByteTrackRef:
    """``bf16_state``: the filter state, boxes and scores rounded to
    bfloat16 after every step (the tracker control's lower precision)."""

    def __init__(self, cfg: dict, slots: int, bf16_state: bool = False):
        self.cfg = cfg
        self.bf16_state = bf16_state
        self.dt = np.dtype(np.float32)
        n = slots
        self.active = np.zeros(n, bool)
        self.boxes = np.zeros((n, 4), self.dt)
        self.mean = np.zeros((n, 8), self.dt)
        self.cov = np.zeros((n, 4, 3), self.dt)
        self.tid = np.zeros(n, np.int64)
        self.cls = np.full(n, -1, np.int64)
        self.conf = np.zeros(n, self.dt)
        self.age = np.zeros(n, np.int64)
        self.tsu = np.zeros(n, np.int64)
        self.next_id = 1

    def _update(self, rows: np.ndarray, meas: np.ndarray) -> None:
        mean, cov = self.mean[rows], self.cov[rows]
        r_std = _stds(mean[:, 3], POS, 1e-1)
        pp, pv, vv = cov[..., 0], cov[..., 1], cov[..., 2]
        s = np.maximum(pp + r_std ** 2, self.dt.type(1e-9))
        k_p, k_v = pp / s, pv / s
        innov = meas - mean[:, :4]
        new_mean = np.concatenate([mean[:, :4] + k_p * innov, mean[:, 4:] + k_v * innov], -1)
        one = self.dt.type(1.0)
        self.cov[rows] = np.stack([(one - k_p) * pp, (one - k_p) * pv, vv - k_v * pv], -1)
        self.mean[rows] = new_mean
        self.boxes[rows] = cxcyah_to_xyxy(new_mean[:, :4])

    def step(self, boxes: np.ndarray, conf: np.ndarray, cls: np.ndarray, valid: np.ndarray
             ) -> dict[str, np.ndarray]:
        c = self.cfg
        dt = self.dt
        boxes = boxes.astype(dt)
        conf = conf.astype(dt)
        act = self.active
        # 0. predict
        h = self.mean[act, 3]
        q_pos, q_vel = _stds(h, POS, 1e-2), _stds(h, VEL, 1e-5)
        cov = self.cov[act]
        pp, pv, vv = cov[..., 0], cov[..., 1], cov[..., 2]
        two = dt.type(2.0)
        self.cov[act] = np.stack([pp + two * pv + vv + q_pos ** 2, pv + vv, vv + q_vel ** 2], -1)
        m = self.mean[act]
        self.mean[act] = np.concatenate([m[:, :4] + m[:, 4:], m[:, 4:]], -1)
        pred = self.boxes.copy()
        pred[act] = cxcyah_to_xyxy(self.mean[act, :4])
        # 1. split
        high = valid & (conf >= dt.type(c["track_thresh"]))
        low = valid & ~high & (conf >= dt.type(c["low_thresh"]))
        iou = iou_matrix(pred, boxes)
        accept = 1.0 - c["match_thresh"]
        matched = np.zeros(len(act), bool)
        det_matched1 = None
        # 2. two association stages
        for dets, rows in ((high, act.copy()), (low, None)):
            if rows is None:
                rows = act & ~matched
            r2c, c2r = greedy(iou, accept, rows, dets)
            hit = r2c >= 0
            if det_matched1 is None:
                det_matched1 = c2r >= 0
            if hit.any():
                di = r2c[hit]
                self._update(np.where(hit)[0], xyxy_to_cxcyah(boxes[di]))
                self.conf[hit] = conf[di]
                self.cls[hit] = cls[di]
                self.age[hit] += 1
                self.tsu[hit] = 0
            matched |= hit
        # 3. births
        is_new = high & ~det_matched1 & (conf >= dt.type(c["new_track_thresh"]))
        free = np.where(~self.active)[0]
        born = np.zeros(len(act), bool)
        for k, d in enumerate(np.where(is_new)[0]):
            if k >= len(free):
                break
            sl = free[k]
            meas = xyxy_to_cxcyah(boxes[d][None])[0]
            hh = meas[3:4]
            p_std = _stds(hh, 2 * POS, 1e-2)[0]
            v_std = _stds(hh, 10 * VEL, 1e-5)[0]
            self.active[sl] = True
            self.boxes[sl] = boxes[d]
            self.mean[sl] = np.concatenate([meas, np.zeros(4, dt)])
            self.cov[sl] = np.stack([p_std ** 2, np.zeros(4, dt), v_std ** 2], -1)
            self.tid[sl] = self.next_id + k
            self.cls[sl] = cls[d]
            self.conf[sl] = conf[d]
            self.age[sl] = 1
            self.tsu[sl] = 0
            born[sl] = True
        self.next_id += int(min(len(free), int(is_new.sum())))
        # 4. age and free
        unmatched = self.active & ~matched & ~born
        self.tsu[unmatched] += 1
        self.active &= self.tsu <= c["track_buffer"]
        if self.bf16_state:
            for name in ("boxes", "mean", "cov", "conf"):
                setattr(self, name, round_bf16(getattr(self, name)))
        return {"boxes": self.boxes.copy(), "track_id": self.tid.copy(),
                "class_id": self.cls.copy(), "visible": self.active & (self.tsu == 0)}
