"""OC-SORT over static track slots (port of ``rtmodt_tpu/tracking/ocsort.py``).

Observation-Centric SORT (Cao et al., CVPR 2023) in the fixed-slot form of
``bytetrack.py``:

  * OCM (momentum): stage-1 similarity is IoU + ``vdc_weight * (pi/2 -
    |angle diff|) / pi`` between each detection's direction from the track's
    observation ``delta_t`` matches ago and the track's stored observation
    velocity; acceptance stays gated on raw IoU >= ``iou_threshold``;
  * optional BYTE stage: low detections vs the tracks still unmatched;
  * OCR (recovery): the remaining high detections vs unmatched tracks' LAST
    OBSERVATIONS (not their drifting Kalman prediction);
  * ORU, closed form: a track re-activated after k >= 2 lost frames
    re-anchors its filter on observations (position from the measurement,
    velocity (z_new - z_last_obs) / k, covariance re-initiated).

Visible tracks: matched this frame and (streak >= ``min_hits`` or the stream
is younger than ``min_hits`` frames).  State tensors are replaced, never
written in place.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from rtmodt_tpu_torch.config.loader import OCSortConfig
from rtmodt_tpu_torch.ops import kalman as kf
from rtmodt_tpu_torch.ops.assignment import greedy_assign
from rtmodt_tpu_torch.ops.iou import cxcyah_to_xyxy, pairwise_iou, xyxy_to_cxcyah
from rtmodt_tpu_torch.tracking.bytetrack import TrackOutputs, _scatter_rows, claim_free_slots

_NEG = -1e9


class OCSortState(NamedTuple):
    """``obs_ring[:, 0]`` is the newest stored observation, ``obs_ring[:, k]``
    the one k matches ago (a shift register of length delta_t + 1)."""

    active: torch.Tensor      # (S,) bool
    boxes: torch.Tensor       # (S, 4) f32 current xyxy estimate
    kf_mean: torch.Tensor     # (S, 8) f32
    kf_cov: torch.Tensor      # (S, 4, 3) f32 packed blocks
    track_id: torch.Tensor    # (S,) i32
    class_id: torch.Tensor    # (S,) i32
    confidence: torch.Tensor  # (S,) f32
    age: torch.Tensor         # (S,) i32 matched-frame count (hits)
    streak: torch.Tensor      # (S,) i32 consecutive-match streak
    tsu: torch.Tensor         # (S,) i32 frames since last match
    last_obs: torch.Tensor    # (S, 4) f32 last matched observation (xyxy)
    obs_ring: torch.Tensor    # (S, R, 4) f32 recent observations, newest first
    ring_count: torch.Tensor  # (S,) i32 valid entries in obs_ring
    velocity: torch.Tensor    # (S, 2) f32 unit (vx, vy) of centroid motion
    next_id: torch.Tensor     # () i32
    frame_count: torch.Tensor  # () i32 frames processed (min_hits grace)


def init_ocsort_state(max_tracks: int = 256, delta_t: int = 3,
                      device: str | torch.device = "cpu") -> OCSortState:
    s, r = max_tracks, delta_t + 1
    f32, i32 = torch.float32, torch.int32

    def z(*shape, dtype=f32):
        return torch.zeros(shape, dtype=dtype, device=device)

    return OCSortState(
        active=z(s, dtype=torch.bool), boxes=z(s, 4), kf_mean=z(s, 8),
        kf_cov=z(*kf.cov_shape(s)), track_id=z(s, dtype=i32),
        class_id=torch.full((s,), -1, dtype=i32, device=device),
        confidence=z(s), age=z(s, dtype=i32), streak=z(s, dtype=i32), tsu=z(s, dtype=i32),
        last_obs=z(s, 4), obs_ring=z(s, r, 4), ring_count=z(s, dtype=i32),
        velocity=z(s, 2), next_id=torch.ones((), dtype=i32, device=device),
        frame_count=z(dtype=i32))


def _centroid(boxes: torch.Tensor) -> torch.Tensor:
    return torch.stack([(boxes[..., 0] + boxes[..., 2]) * 0.5,
                        (boxes[..., 1] + boxes[..., 3]) * 0.5], dim=-1)


def _prev_obs(state: OCSortState, delta_t: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Observation delta_t matches ago (or the oldest stored) per slot:
    (obs (S, 4), has_obs (S,))."""
    idx = (state.ring_count - 1).clamp(0, delta_t).long()
    obs = torch.gather(state.obs_ring, 1, idx[:, None, None].expand(-1, 1, 4))[:, 0]
    return obs, state.ring_count > 0


def _angle_bonus(prev_obs, has_prev, velocity, vel_valid, det_boxes,
                 vdc_weight: float) -> torch.Tensor:
    """OCM similarity bonus (S, D); 0 for tracks without a stored velocity."""
    d = _centroid(det_boxes)[None, :, :] - _centroid(prev_obs)[:, None, :]
    norm = torch.sqrt(torch.sum(d * d, dim=-1))
    dir_sd = d / norm.clamp(min=1e-6)[..., None]
    cos = torch.sum(dir_sd * velocity[:, None, :], dim=-1).clamp(-1.0, 1.0)
    diff = (math.pi / 2.0 - torch.abs(torch.arccos(cos))) / math.pi
    ok = (has_prev & vel_valid)[:, None] & (norm > 1e-6)
    return torch.where(ok, diff * vdc_weight, torch.zeros_like(diff))


def _apply_matches(state: OCSortState, matched: torch.Tensor, det_of_row: torch.Tensor,
                   det_boxes, det_conf, det_cls, delta_t: int) -> OCSortState:
    """Kalman update (closed-form ORU on re-activation) + observation
    bookkeeping for the matched slots."""
    m_boxes = det_boxes[det_of_row]
    meas = xyxy_to_cxcyah(m_boxes)
    upd = kf.update(kf.KalmanState(state.kf_mean, state.kf_cov), meas)

    k_gap = state.tsu.clamp(min=1).float()
    last_meas = xyxy_to_cxcyah(state.last_obs)
    re_born = kf.initiate(meas)
    re_vel = (meas - last_meas) / k_gap[:, None]
    re_mean = torch.cat([meas, re_vel], dim=-1)
    reanchor = matched & (state.tsu >= 2) & (state.ring_count > 0)

    new_mean = torch.where(reanchor[:, None], re_mean, upd.mean)
    new_cov = torch.where(reanchor[:, None, None], re_born.cov, upd.cov)
    new_mean = torch.where(matched[:, None], new_mean, state.kf_mean)
    new_cov = torch.where(matched[:, None, None], new_cov, state.kf_cov)
    out_boxes = torch.where(matched[:, None], cxcyah_to_xyxy(new_mean[:, :4]), state.boxes)

    prev, has_prev = _prev_obs(state, delta_t)
    d = _centroid(m_boxes) - _centroid(prev)
    norm = torch.sqrt(torch.sum(d * d, dim=-1, keepdim=True))
    vel = d / norm.clamp(min=1e-6)
    vel_ok = matched & has_prev & (norm[:, 0] > 1e-6)
    new_velocity = torch.where(vel_ok[:, None], vel, state.velocity)

    pushed = torch.cat([m_boxes[:, None], state.obs_ring[:, :-1]], dim=1)
    obs_ring = torch.where(matched[:, None, None], pushed, state.obs_ring)
    ring_count = torch.where(matched, (state.ring_count + 1).clamp(max=state.obs_ring.shape[1]),
                             state.ring_count)
    return state._replace(
        boxes=out_boxes, kf_mean=new_mean, kf_cov=new_cov,
        confidence=torch.where(matched, det_conf[det_of_row], state.confidence),
        class_id=torch.where(matched, det_cls[det_of_row], state.class_id),
        age=torch.where(matched, state.age + 1, state.age),
        streak=torch.where(matched, state.streak + 1, state.streak),
        tsu=torch.where(matched, 0, state.tsu),
        last_obs=torch.where(matched[:, None], m_boxes, state.last_obs),
        obs_ring=obs_ring, ring_count=ring_count, velocity=new_velocity)


def ocsort_update(state: OCSortState, det_boxes: torch.Tensor, det_conf: torch.Tensor,
                  det_cls: torch.Tensor, det_valid: torch.Tensor, cfg: OCSortConfig
                  ) -> tuple[OCSortState, TrackOutputs]:
    """One OC-SORT step over (D,) detections in source coordinates."""
    det_boxes = det_boxes.float()
    det_conf = det_conf.float()
    det_cls = det_cls.int()
    state = state._replace(frame_count=state.frame_count + 1)

    high = det_valid & (det_conf >= cfg.det_thresh)
    low = det_valid & ~high & (det_conf >= cfg.low_thresh)

    # 0. Kalman predict for all active slots
    pred = kf.predict(kf.KalmanState(state.kf_mean, state.kf_cov))
    kf_mean = torch.where(state.active[:, None], pred.mean, state.kf_mean)
    kf_cov = torch.where(state.active[:, None, None], pred.cov, state.kf_cov)
    state = state._replace(kf_mean=kf_mean, kf_cov=kf_cov)
    pred_boxes = torch.where(state.active[:, None], cxcyah_to_xyxy(kf_mean[:, :4]), state.boxes)

    # 1. OCM association: high dets vs active tracks; the bonus can reorder
    #    pairs that pass the raw-IoU gate but never admits one that fails it
    iou = pairwise_iou(pred_boxes, det_boxes)
    prev, has_prev = _prev_obs(state, cfg.delta_t)
    vel_valid = state.ring_count > 1
    bonus = _angle_bonus(prev, has_prev, state.velocity, vel_valid, det_boxes, cfg.vdc_weight)
    neg = torch.full_like(iou, _NEG)
    sim1 = torch.where(iou >= cfg.iou_threshold, iou + bonus, neg)
    res1 = greedy_assign(sim1, float(_NEG / 2), row_valid=state.active, col_valid=high)
    matched1 = res1.row_to_col >= 0
    state = _apply_matches(state, matched1, res1.row_to_col.clamp(min=0).long(),
                           det_boxes, det_conf, det_cls, cfg.delta_t)

    # 2. BYTE stage (optional): low dets vs unmatched tracks
    if cfg.use_byte:
        sim2 = torch.where(iou >= cfg.iou_threshold, iou, neg)
        res2 = greedy_assign(sim2, float(_NEG / 2), row_valid=state.active & ~matched1,
                             col_valid=low)
        matched2 = res2.row_to_col >= 0
        state = _apply_matches(state, matched2, res2.row_to_col.clamp(min=0).long(),
                               det_boxes, det_conf, det_cls, cfg.delta_t)
    else:
        matched2 = torch.zeros_like(matched1)

    # 3. OCR: remaining high dets vs unmatched tracks' last observations
    rows3 = state.active & ~matched1 & ~matched2 & (state.ring_count > 0)
    cols3 = high & (res1.col_to_row < 0)
    iou_obs = pairwise_iou(state.last_obs, det_boxes)
    sim3 = torch.where(iou_obs >= cfg.iou_threshold, iou_obs, neg)
    res3 = greedy_assign(sim3, float(_NEG / 2), row_valid=rows3, col_valid=cols3)
    matched3 = res3.row_to_col >= 0
    state = _apply_matches(state, matched3, res3.row_to_col.clamp(min=0).long(),
                           det_boxes, det_conf, det_cls, cfg.delta_t)
    matched = matched1 | matched2 | matched3

    # 4. births: unmatched high dets claim free slots
    is_new = high & (res1.col_to_row < 0) & (res3.col_to_row < 0)
    target_slot, can_place, new_ids, newly_born = claim_free_slots(
        state.active, is_new, state.next_id)
    born = kf.initiate(xyxy_to_cxcyah(det_boxes))
    n_det, ring = det_boxes.shape[0], state.obs_ring.shape[1]
    born_ring = torch.cat([det_boxes[:, None, :],
                           det_boxes.new_zeros((n_det, ring - 1, 4))], dim=1)
    one = torch.ones((), dtype=torch.int32, device=det_boxes.device)
    state = state._replace(
        active=_scatter_rows(state.active, target_slot, torch.ones_like(is_new)),
        boxes=_scatter_rows(state.boxes, target_slot, det_boxes),
        kf_mean=_scatter_rows(state.kf_mean, target_slot, born.mean),
        kf_cov=_scatter_rows(state.kf_cov, target_slot, born.cov),
        track_id=_scatter_rows(state.track_id, target_slot, new_ids),
        class_id=_scatter_rows(state.class_id, target_slot, det_cls),
        confidence=_scatter_rows(state.confidence, target_slot, det_conf),
        age=_scatter_rows(state.age, target_slot, one),
        streak=_scatter_rows(state.streak, target_slot, one),
        tsu=_scatter_rows(state.tsu, target_slot, 0 * one),
        last_obs=_scatter_rows(state.last_obs, target_slot, det_boxes),
        obs_ring=_scatter_rows(state.obs_ring, target_slot, born_ring),
        ring_count=_scatter_rows(state.ring_count, target_slot, one),
        velocity=_scatter_rows(state.velocity, target_slot, det_boxes.new_zeros((n_det, 2))),
        next_id=state.next_id + torch.sum(can_place.int()).int(),
    )

    # 5. age unmatched, free the dead; the streak resets on a miss
    unmatched = state.active & ~matched & ~newly_born
    tsu = torch.where(unmatched, state.tsu + 1, state.tsu)
    streak = torch.where(unmatched, 0, state.streak)
    active = state.active & (tsu <= cfg.max_age)
    state = state._replace(tsu=tsu, streak=streak, active=active)

    visible = state.active & (state.tsu == 0) & (
        (state.streak >= cfg.min_hits) | (state.frame_count <= cfg.min_hits))
    return state, TrackOutputs(
        boxes=state.boxes, track_id=state.track_id, class_id=state.class_id,
        confidence=state.confidence, age=state.age, tsu=state.tsu, visible=visible)
