"""Host (NumPy) ByteTrack with optimal LAPJV assignment (port of
``rtmodt_tpu/tracking/host_bytetrack.py``).

The device state machine's semantics (``bytetrack.py``) on the host, with
*optimal* Jonker-Volgenant assignment (the port's C++ solver,
``ops/lapjv.py``; a failed build raises, there is no scipy fallback).  Serves
``tracking.bytetrack.assignment: lapjv``.
"""

from __future__ import annotations

import numpy as np

from rtmodt_tpu_torch.config.loader import ByteTrackConfig
from rtmodt_tpu_torch.ops.kalman import STD_WEIGHT_POS
from rtmodt_tpu_torch.tracking.host_kalman import HostKalman

_CHI2_95_4DOF = 9.4877  # chi2.ppf(0.95, 4): canonical ByteTrack/DeepSORT gate


def _iou_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)), np.float32)
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    return inter / (area_a[:, None] + area_b[None, :] - inter + 1e-7)


def _solve_assignment(sim: np.ndarray, accept: float) -> tuple[list[tuple[int, int]], list[int], list[int]]:
    """Optimal min-cost assignment on cost = 1 - similarity with accept rule
    sim >= accept. Returns (matches, unmatched_rows, unmatched_cols)."""
    from rtmodt_tpu_torch.ops.lapjv import lapjv

    iou = sim
    thresh = accept
    r, c = iou.shape
    if r == 0 or c == 0:
        return [], list(range(r)), list(range(c))
    row_to_col = lapjv(1.0 - iou, cost_limit=1.0 - thresh + 1e-9)
    matches, un_r, un_c = [], [], set(range(c))
    for i, j in enumerate(row_to_col):
        if j >= 0 and iou[i, j] >= thresh:
            matches.append((i, j))
            un_c.discard(j)
        else:
            un_r.append(i)
    return matches, un_r, sorted(un_c)


class HostByteTrack:
    """Reference-faithful (intended-semantics) ByteTrack on the host."""

    def __init__(self, cfg: ByteTrackConfig):
        self.cfg = cfg
        self._next_id = 1
        self._tracks: list[dict] = []
        self._kf = None
        if cfg.motion_model == "kalman":
            self._kf = HostKalman()

    def update(self, xyxy: np.ndarray, confidence: np.ndarray,
               class_id: np.ndarray) -> list[dict]:
        cfg = self.cfg
        # 0. predict
        if self._kf is not None:
            for t in self._tracks:
                t["mean"], t["cov"] = self._kf.predict(t["mean"], t["cov"])
                t["pred_xyxy"] = self._kf.to_xyxy(t["mean"])
        else:
            for t in self._tracks:
                t["pred_xyxy"] = t["xyxy"]

        high_idx = np.where(confidence >= cfg.track_thresh)[0]
        low_idx = np.where((confidence < cfg.track_thresh) & (confidence >= cfg.low_thresh))[0]

        # same acceptance semantics as the device tracker (bytetrack.py):
        # match_metric "iou" accepts IoU >= match_thresh; the canonical
        # "iou_distance" accepts 1 - IoU <= match_thresh
        accept = (cfg.match_thresh if cfg.match_metric == "iou"
                  else 1.0 - cfg.match_thresh)

        def similarity(tracks: list[dict], det_idx: np.ndarray) -> np.ndarray:
            pred = np.array([t["pred_xyxy"] for t in tracks],
                            np.float32).reshape(-1, 4)
            det = xyxy[det_idx].reshape(-1, 4)
            sim = _iou_matrix(pred, det)
            if cfg.fuse_score:
                sim = sim * confidence[det_idx][None, :].astype(np.float32)
            if cfg.gate_distance and self._kf is not None and sim.size:
                # diagonal-innovation Mahalanobis gate, mirroring
                # ops/kalman.py::gating_distance + bytetrack.py chi2 bound
                meas = np.stack([HostKalman._to_meas(b) for b in det])
                for i, t in enumerate(tracks):
                    h = t["mean"][3]
                    r_std = np.array([STD_WEIGHT_POS * h, STD_WEIGHT_POS * h,
                                      1e-1, STD_WEIGHT_POS * h])
                    s = np.diag(t["cov"])[:4] + r_std**2
                    d = meas - t["mean"][:4]
                    dist = np.sum(d * d / s, axis=-1)
                    sim[i, dist > _CHI2_95_4DOF] = -1.0
            return sim

        def apply_match(t: dict, d: int) -> None:
            if self._kf is not None:
                t["mean"], t["cov"] = self._kf.update(t["mean"], t["cov"], xyxy[d])
                t["xyxy"] = self._kf.to_xyxy(t["mean"])
            else:
                t["xyxy"] = xyxy[d].copy()
            t["confidence"] = float(confidence[d])
            t["class_id"] = int(class_id[d])
            t["age"] += 1
            t["time_since_update"] = 0

        # 1. high-conf association vs all tracks
        sim1 = similarity(self._tracks, high_idx)
        m1, un_t1, un_d1 = _solve_assignment(sim1, accept)
        for ti, dj in m1:
            apply_match(self._tracks[ti], int(high_idx[dj]))

        # 2. low-conf association vs leftover tracks
        rem = [self._tracks[i] for i in un_t1]
        sim2 = similarity(rem, low_idx)
        m2, un_t2, _ = _solve_assignment(sim2, accept)
        for ti, dj in m2:
            apply_match(rem[ti], int(low_idx[dj]))
        unmatched_tracks = [rem[i] for i in un_t2]

        # 3. births from unmatched high dets above the new-track gate
        # (canonical ByteTrack: activation needs score >= new_track_thresh)
        for dj in un_d1:
            d = int(high_idx[dj])
            if confidence[d] < cfg.new_track_thresh:
                continue
            t = {
                "track_id": self._next_id,
                "xyxy": xyxy[d].copy(),
                "confidence": float(confidence[d]),
                "class_id": int(class_id[d]),
                "age": 1,
                "time_since_update": 0,
            }
            if self._kf is not None:
                t["mean"], t["cov"] = self._kf.initiate(xyxy[d])
            self._tracks.append(t)
            self._next_id += 1

        # 4. age only unmatched tracks (intended semantics; see bytetrack.py)
        for t in unmatched_tracks:
            t["time_since_update"] += 1
        self._tracks = [t for t in self._tracks if t["time_since_update"] <= self.cfg.track_buffer]

        return [t for t in self._tracks if t["time_since_update"] == 0]
