"""BoT-SORT over static track slots (port of ``rtmodt_tpu/tracking/botsort.py``).

ByteTrack's confidence-split two-stage association with BoT-SORT's fused
stage-1 cost ``min(IoU distance, gated cosine distance)``: the halved cosine
distance counts only for pairs that pass the proximity gate
(``1 - IoU <= proximity_thresh``) and their own appearance cut
(``d_emb <= appearance_thresh``).  Camera-motion compensation is the shared
``tracking.gmc`` block (``ops/gmc.py``), applied to the state before this
update.  The state is ``DeepSortState``; births are visible at once and
stage-2 matches refresh the EMA gallery too, as in the reference.
"""

from __future__ import annotations

import torch

from rtmodt_tpu_torch.config.loader import BotSortConfig
from rtmodt_tpu_torch.ops.assignment import greedy_assign
from rtmodt_tpu_torch.ops.iou import pairwise_iou
from rtmodt_tpu_torch.tracking.bytetrack import TrackOutputs
from rtmodt_tpu_torch.tracking.deepsort import (DeepSortState, _apply_matches, birth,
                                                init_deepsort_state, outputs_of,
                                                predict_boxes)

BotSortState = DeepSortState


def init_botsort_state(max_tracks: int = 256, embed_dim: int = 128,
                       device: str | torch.device = "cpu") -> BotSortState:
    return init_deepsort_state(max_tracks, embed_dim, device)


def botsort_update(state: BotSortState, det_boxes: torch.Tensor, det_conf: torch.Tensor,
                   det_cls: torch.Tensor, det_valid: torch.Tensor, det_feat: torch.Tensor,
                   cfg: BotSortConfig) -> tuple[BotSortState, TrackOutputs]:
    """One BoT-SORT step over (D,) detections with (D, E) unit embeddings."""
    det_boxes = det_boxes.float()
    det_conf = det_conf.float()
    det_cls = det_cls.int()
    det_feat = det_feat.float()

    # 0. Kalman predict for all active slots
    state, pred_boxes = predict_boxes(state)

    # 1. split detections (BYTE)
    high = det_valid & (det_conf >= cfg.track_thresh)
    low = det_valid & ~high & (det_conf >= cfg.low_thresh)
    iou = pairwise_iou(pred_boxes, det_boxes)

    # 2. stage 1: high dets vs all active tracks, fused cost
    d_iou_raw = 1.0 - iou
    d_iou = 1.0 - iou * det_conf[None, :] if cfg.fuse_score else d_iou_raw
    cos_sim = state.feat @ det_feat.T
    d_emb = 0.5 * (1.0 - cos_sim)
    gate = (d_iou_raw <= cfg.proximity_thresh) & (d_emb <= cfg.appearance_thresh)
    d_emb = torch.where(gate, d_emb, torch.ones_like(d_emb))
    fused_sim = 1.0 - torch.minimum(d_iou, d_emb)
    res1 = greedy_assign(fused_sim, 1.0 - cfg.match_thresh, row_valid=state.active,
                         col_valid=high)
    matched1 = res1.row_to_col >= 0
    state = _apply_matches(state, matched1, res1.row_to_col.clamp(min=0).long(),
                           det_boxes, det_conf, det_cls, det_feat, cfg.ema_alpha)

    # 3. stage 2: low dets vs leftover tracks, IoU only
    res2 = greedy_assign(iou, 1.0 - cfg.low_match_thresh, row_valid=state.active & ~matched1,
                         col_valid=low)
    matched2 = res2.row_to_col >= 0
    state = _apply_matches(state, matched2, res2.row_to_col.clamp(min=0).long(),
                           det_boxes, det_conf, det_cls, det_feat, cfg.ema_alpha)
    matched = matched1 | matched2

    # 4. births: unmatched high dets above the new-track gate
    is_new = high & (res1.col_to_row < 0) & (det_conf >= cfg.new_track_thresh)
    state, newly_born = birth(state, is_new, det_boxes, det_conf, det_cls, det_feat)

    # 5. age unmatched tracks, free the dead
    unmatched = state.active & ~matched & ~newly_born
    tsu = torch.where(unmatched, state.tsu + 1, state.tsu)
    active = state.active & (tsu <= cfg.track_buffer)
    state = state._replace(tsu=tsu, active=active)
    return state, outputs_of(state, state.active & (state.tsu == 0))
