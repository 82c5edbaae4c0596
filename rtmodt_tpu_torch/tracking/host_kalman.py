"""Scalar NumPy Kalman filter for the host tracker (port of
``rtmodt_tpu/tracking/host_kalman.py``): the constants and state layout of
``ops/kalman.py``, with full 8x8 float64 covariances."""

from __future__ import annotations

import numpy as np

from rtmodt_tpu_torch.ops.kalman import STD_WEIGHT_POS, STD_WEIGHT_VEL


class HostKalman:
    def __init__(self) -> None:
        self.F = np.eye(8, dtype=np.float64)
        self.F[:4, 4:] = np.eye(4)

    @staticmethod
    def _to_meas(xyxy: np.ndarray) -> np.ndarray:
        w = xyxy[2] - xyxy[0]
        h = xyxy[3] - xyxy[1]
        return np.array([xyxy[0] + w / 2, xyxy[1] + h / 2, w / max(h, 1e-6), h])

    @staticmethod
    def to_xyxy(mean: np.ndarray) -> np.ndarray:
        cx, cy, a, h = mean[:4]
        w = a * h
        return np.array([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], np.float32)

    def initiate(self, xyxy: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        m = self._to_meas(xyxy)
        mean = np.concatenate([m, np.zeros(4)])
        h = m[3]
        std = np.array([
            2 * STD_WEIGHT_POS * h, 2 * STD_WEIGHT_POS * h, 1e-2, 2 * STD_WEIGHT_POS * h,
            10 * STD_WEIGHT_VEL * h, 10 * STD_WEIGHT_VEL * h, 1e-5, 10 * STD_WEIGHT_VEL * h,
        ])
        return mean, np.diag(std**2)

    def predict(self, mean: np.ndarray, cov: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        h = mean[3]
        std = np.array([
            STD_WEIGHT_POS * h, STD_WEIGHT_POS * h, 1e-2, STD_WEIGHT_POS * h,
            STD_WEIGHT_VEL * h, STD_WEIGHT_VEL * h, 1e-5, STD_WEIGHT_VEL * h,
        ])
        mean = self.F @ mean
        cov = self.F @ cov @ self.F.T + np.diag(std**2)
        return mean, cov

    def update(self, mean: np.ndarray, cov: np.ndarray,
               xyxy: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        z = self._to_meas(xyxy)
        h = mean[3]
        std = np.array([STD_WEIGHT_POS * h, STD_WEIGHT_POS * h, 1e-1, STD_WEIGHT_POS * h])
        s = cov[:4, :4] + np.diag(std**2)
        gain = np.linalg.solve(s.T, cov[:, :4].T).T        # (8, 4)
        mean = mean + gain @ (z - mean[:4])
        cov = cov - gain @ cov[:4, :]
        return mean, cov
