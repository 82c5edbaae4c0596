"""DeepSORT over static track slots (port of ``rtmodt_tpu/tracking/deepsort.py``).

ByteTrack's fixed slots plus an appearance gallery:

  * appearance association first: cosine similarity of each confirmed
    track's gallery feature and every detection embedding, accepted when
    ``1 - cos <= max_dist``, optionally gated by the Kalman chi-square
    bound;
  * IoU association second, for unconfirmed tracks and confirmed tracks
    matched last frame, accepted when ``1 - IoU <= max_iou_distance``;
  * tentative births, confirmed after ``n_init`` matches; a tentative track
    that misses a frame is deleted; confirmed tracks survive ``max_age``
    misses.

The gallery is an exponential moving average (``ema_alpha``), the StrongSORT
formulation; one greedy pass replaces the age cascade.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from rtmodt_tpu_torch.config.loader import DeepSortConfig
from rtmodt_tpu_torch.ops import kalman as kf
from rtmodt_tpu_torch.ops.assignment import greedy_assign
from rtmodt_tpu_torch.ops.iou import cxcyah_to_xyxy, pairwise_iou, xyxy_to_cxcyah
from rtmodt_tpu_torch.tracking.bytetrack import (_CHI2_95_4DOF, TrackOutputs,
                                                 _scatter_rows, claim_free_slots)


class DeepSortState(NamedTuple):
    """Slots + Kalman + EMA appearance gallery; ``age`` counts matches and a
    slot is confirmed once ``age >= n_init``."""

    active: torch.Tensor      # (S,) bool
    boxes: torch.Tensor       # (S, 4) f32 current xyxy estimate
    kf_mean: torch.Tensor     # (S, 8) f32
    kf_cov: torch.Tensor      # (S, 4, 3) f32 packed 2x2 blocks
    track_id: torch.Tensor    # (S,) i32
    class_id: torch.Tensor    # (S,) i32
    confidence: torch.Tensor  # (S,) f32
    age: torch.Tensor         # (S,) i32 matched-frame count (hits)
    tsu: torch.Tensor         # (S,) i32 frames since last match
    feat: torch.Tensor        # (S, E) f32 L2-normalised EMA appearance
    next_id: torch.Tensor     # () i32


def init_deepsort_state(max_tracks: int = 256, embed_dim: int = 128,
                        device: str | torch.device = "cpu") -> DeepSortState:
    s = max_tracks
    f32, i32 = torch.float32, torch.int32

    def z(*shape, dtype=f32):
        return torch.zeros(shape, dtype=dtype, device=device)

    return DeepSortState(
        active=z(s, dtype=torch.bool), boxes=z(s, 4), kf_mean=z(s, 8),
        kf_cov=z(*kf.cov_shape(s)), track_id=z(s, dtype=i32),
        class_id=torch.full((s,), -1, dtype=i32, device=device), confidence=z(s),
        age=z(s, dtype=i32), tsu=z(s, dtype=i32), feat=z(s, embed_dim),
        next_id=torch.ones((), dtype=i32, device=device))


def _apply_matches(state: DeepSortState, matched: torch.Tensor, det_of_row: torch.Tensor,
                   det_boxes, det_conf, det_cls, det_feat, ema_alpha: float) -> DeepSortState:
    """Kalman update and gallery EMA of every matched slot."""
    m_boxes = det_boxes[det_of_row]
    upd = kf.update(kf.KalmanState(state.kf_mean, state.kf_cov), xyxy_to_cxcyah(m_boxes))
    new_mean = torch.where(matched[:, None], upd.mean, state.kf_mean)
    new_cov = torch.where(matched[:, None, None], upd.cov, state.kf_cov)
    out_boxes = torch.where(matched[:, None], cxcyah_to_xyxy(new_mean[:, :4]), state.boxes)
    mixed = ema_alpha * state.feat + (1.0 - ema_alpha) * det_feat[det_of_row]
    mixed = mixed / (torch.linalg.vector_norm(mixed, dim=-1, keepdim=True) + 1e-8)
    return state._replace(
        boxes=out_boxes, kf_mean=new_mean, kf_cov=new_cov,
        confidence=torch.where(matched, det_conf[det_of_row], state.confidence),
        class_id=torch.where(matched, det_cls[det_of_row], state.class_id),
        age=torch.where(matched, state.age + 1, state.age),
        tsu=torch.where(matched, 0, state.tsu),
        feat=torch.where(matched[:, None], mixed, state.feat))


def predict_boxes(state):
    """Kalman predict of the active slots: (state', predicted xyxy (S, 4))."""
    pred = kf.predict(kf.KalmanState(state.kf_mean, state.kf_cov))
    kf_mean = torch.where(state.active[:, None], pred.mean, state.kf_mean)
    kf_cov = torch.where(state.active[:, None, None], pred.cov, state.kf_cov)
    state = state._replace(kf_mean=kf_mean, kf_cov=kf_cov)
    return state, torch.where(state.active[:, None], cxcyah_to_xyxy(kf_mean[:, :4]), state.boxes)


def birth(state: DeepSortState, is_new: torch.Tensor, det_boxes, det_conf, det_cls,
          det_feat):
    """Unmatched new detections claim free slots (slot order).  Returns
    (state', newly_born (S,))."""
    target_slot, can_place, new_ids, newly_born = claim_free_slots(
        state.active, is_new, state.next_id)
    born = kf.initiate(xyxy_to_cxcyah(det_boxes))
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
        tsu=_scatter_rows(state.tsu, target_slot, 0 * one),
        feat=_scatter_rows(state.feat, target_slot, det_feat),
        next_id=state.next_id + torch.sum(can_place.int()).int(),
    )
    return state, newly_born


def outputs_of(state, visible: torch.Tensor) -> TrackOutputs:
    return TrackOutputs(boxes=state.boxes, track_id=state.track_id, class_id=state.class_id,
                        confidence=state.confidence, age=state.age, tsu=state.tsu,
                        visible=visible)


def deepsort_update(state: DeepSortState, det_boxes: torch.Tensor, det_conf: torch.Tensor,
                    det_cls: torch.Tensor, det_valid: torch.Tensor, det_feat: torch.Tensor,
                    cfg: DeepSortConfig) -> tuple[DeepSortState, TrackOutputs]:
    """One DeepSORT step over (D,) detections with (D, E) unit embeddings."""
    det_boxes = det_boxes.float()
    det_conf = det_conf.float()
    det_cls = det_cls.int()
    det_feat = det_feat.float()
    eligible = det_valid & (det_conf >= cfg.min_confidence)
    confirmed = state.active & (state.age >= cfg.n_init)

    # 0. Kalman predict for all active slots
    state, pred_boxes = predict_boxes(state)

    # 1. appearance association: confirmed tracks x eligible dets
    cos_sim = state.feat @ det_feat.T
    if cfg.gate_distance:
        dist = kf.gating_distance(kf.KalmanState(state.kf_mean, state.kf_cov),
                                  xyxy_to_cxcyah(det_boxes)[None])
        cos_sim = torch.where(dist <= _CHI2_95_4DOF, cos_sim, torch.full_like(cos_sim, -2.0))
    res1 = greedy_assign(cos_sim, 1.0 - cfg.max_dist, row_valid=confirmed, col_valid=eligible)
    matched1 = res1.row_to_col >= 0
    state = _apply_matches(state, matched1, res1.row_to_col.clamp(min=0).long(),
                           det_boxes, det_conf, det_cls, det_feat, cfg.ema_alpha)

    # 2. IoU association: unconfirmed + confirmed tracks seen last frame
    rows2 = state.active & ~matched1 & (~confirmed | (state.tsu == 0))
    cols2 = eligible & (res1.col_to_row < 0)
    iou = pairwise_iou(pred_boxes, det_boxes)
    res2 = greedy_assign(iou, 1.0 - cfg.max_iou_distance, row_valid=rows2, col_valid=cols2)
    matched2 = res2.row_to_col >= 0
    state = _apply_matches(state, matched2, res2.row_to_col.clamp(min=0).long(),
                           det_boxes, det_conf, det_cls, det_feat, cfg.ema_alpha)
    matched = matched1 | matched2

    # 3. births: unmatched eligible dets
    is_new = eligible & (res1.col_to_row < 0) & (res2.col_to_row < 0)
    state, newly_born = birth(state, is_new, det_boxes, det_conf, det_cls, det_feat)

    # 4. deaths: tentative tracks die on their first miss
    unmatched = state.active & ~matched & ~newly_born
    tentative_miss = unmatched & (state.age < cfg.n_init)
    tsu = torch.where(unmatched, state.tsu + 1, state.tsu)
    active = state.active & ~tentative_miss & (tsu <= cfg.max_age)
    state = state._replace(tsu=tsu, active=active)

    visible = state.active & (state.age >= cfg.n_init) & (state.tsu == 0)
    return state, outputs_of(state, visible)
