"""Batched constant-velocity Kalman filter with packed block-diagonal
covariance (port of ``rtmodt_tpu/ops/kalman.py``).

State (cx, cy, a, h, vcx, vcy, va, vh); measurement (cx, cy, a, h).  The four
coordinates never mix, so the 8x8 covariance is four 2x2 (position,
velocity) blocks stored as ``(N, 4, 3)`` = (P_pp, P_pv, P_vv) and every step
is closed form; noise scales with box height (1/20 position, 1/160 velocity).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

STD_WEIGHT_POS = 1.0 / 20.0
STD_WEIGHT_VEL = 1.0 / 160.0


class KalmanState(NamedTuple):
    mean: torch.Tensor  # (..., N, 8)
    cov: torch.Tensor   # (..., N, 4, 3) packed (pp, pv, vv) per coordinate

    @property
    def pp(self) -> torch.Tensor:
        return self.cov[..., 0]

    @property
    def pv(self) -> torch.Tensor:
        return self.cov[..., 1]

    @property
    def vv(self) -> torch.Tensor:
        return self.cov[..., 2]


def cov_shape(n: int) -> tuple[int, int, int]:
    """The packed covariance of ``n`` tracks; a stream axis leads it."""
    return (n, 4, 3)


def _stds(h: torch.Tensor, w: float, a_std: float) -> torch.Tensor:
    """Per-coordinate (cx, cy, a, h) std stack: w*h except the aspect."""
    return torch.stack([w * h, w * h, torch.full_like(h, a_std), w * h], dim=-1)


def initiate(measurement: torch.Tensor) -> KalmanState:
    """Create filter state from unassociated measurements (..., 4)."""
    mean = torch.cat([measurement, torch.zeros_like(measurement)], dim=-1)
    h = measurement[..., 3]
    p_std = _stds(h, 2 * STD_WEIGHT_POS, 1e-2)
    v_std = _stds(h, 10 * STD_WEIGHT_VEL, 1e-5)
    cov = torch.stack([p_std ** 2, torch.zeros_like(p_std), v_std ** 2], dim=-1)
    return KalmanState(mean, cov)


def predict(state: KalmanState) -> KalmanState:
    """mean' = F mean; per block pp' = pp + 2 pv + vv + q_pos, pv' = pv + vv,
    vv' = vv + q_vel."""
    h = state.mean[..., 3]
    q_pos = _stds(h, STD_WEIGHT_POS, 1e-2)
    q_vel = _stds(h, STD_WEIGHT_VEL, 1e-5)
    pp, pv, vv = state.pp, state.pv, state.vv
    cov = torch.stack([pp + 2 * pv + vv + q_pos ** 2, pv + vv, vv + q_vel ** 2], dim=-1)
    mean = torch.cat([state.mean[..., :4] + state.mean[..., 4:], state.mean[..., 4:]], dim=-1)
    return KalmanState(mean, cov)


def update(state: KalmanState, measurement: torch.Tensor) -> KalmanState:
    """Update with measurements (..., 4); diagonal innovation covariance, so
    the gain is two scalars per coordinate."""
    r_std = _stds(state.mean[..., 3], STD_WEIGHT_POS, 1e-1)
    # floor: a zero-height box would give s = 0 and a NaN gain
    s = (state.pp + r_std ** 2).clamp(min=1e-9)
    k_p = state.pp / s
    k_v = state.pv / s
    innov = measurement - state.mean[..., :4]
    mean = torch.cat([state.mean[..., :4] + k_p * innov,
                      state.mean[..., 4:] + k_v * innov], dim=-1)
    pp = (1.0 - k_p) * state.pp
    pv = (1.0 - k_p) * state.pv
    vv = state.vv - k_v * state.pv
    return KalmanState(mean, torch.stack([pp, pv, vv], dim=-1))


def gating_distance(state: KalmanState, measurements: torch.Tensor) -> torch.Tensor:
    """Squared Mahalanobis distance of measurements (..., 1, M, 4) from each
    of the (..., N) predicted states -> (..., N, M) (diagonal innovation
    covariance; the leading axes, e.g. streams, broadcast)."""
    r_std = _stds(state.mean[..., 3], STD_WEIGHT_POS, 1e-1)
    s = (state.pp + r_std ** 2).clamp(min=1e-9)
    d = measurements - state.mean[..., None, :4]
    return torch.sum(d * d / s[..., None, :], dim=-1)
