"""ByteTrack over static track slots (port of ``rtmodt_tpu/tracking/bytetrack.py``).

A function ``(TrackState, detections) -> (TrackState, TrackOutputs)`` over a
fixed number of slots (default 256), all state on the device:

  * Kalman predict for active slots, one (S, D) IoU matrix shared by both
    association stages (high-confidence dets vs all active tracks, then low
    dets vs the leftovers), greedy assignment;
  * births: unmatched high dets above ``new_track_thresh`` claim free slots
    in slot order, with ids counting up from 1;
  * deaths: slots unmatched for more than ``track_buffer`` frames are freed.

``bytetrack_update`` replaces state tensors and never writes them in place,
so a caller of it may keep an earlier state.  The chunk graph departs from
that (``tracking/chunk_graph.py``): on the card ``Pipeline.track_chunk``
replays a chunk's steps on the graph's static state tensors, updated in
place, and leaves ``MultiObjectTracker.state`` pointing at them; a caller
that holds a state across chunks keeps a copy (``chunk_graph.clone_state``:
both warm-ups do; snapshots copy to the host).

Streams: every state tensor may carry a leading stream axis (S, ...), with
detections (S, D, ...) beside it (``parallel/multistream.py::
init_multistream_state``); each stream is
then updated exactly as a single-stream update on its own inputs, and the
greedy rounds of all streams share one loop (``ops/assignment.py``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from rtmodt_tpu_torch.config.loader import ByteTrackConfig
from rtmodt_tpu_torch.ops import kalman as kf
from rtmodt_tpu_torch.ops.assignment import greedy_assign
from rtmodt_tpu_torch.ops.iou import cxcyah_to_xyxy, pairwise_iou, xyxy_to_cxcyah

_CHI2_95_4DOF = 9.4877  # chi2.ppf(0.95, 4): canonical ByteTrack/DeepSORT gate


class TrackState(NamedTuple):
    active: torch.Tensor      # (S,) bool
    boxes: torch.Tensor       # (S, 4) f32 current xyxy estimate
    kf_mean: torch.Tensor     # (S, 8) f32
    kf_cov: torch.Tensor      # (S, 4, 3) f32 packed 2x2 blocks
    track_id: torch.Tensor    # (S,) i32
    class_id: torch.Tensor    # (S,) i32
    confidence: torch.Tensor  # (S,) f32
    age: torch.Tensor         # (S,) i32 matched frames since birth
    tsu: torch.Tensor         # (S,) i32 time since last update
    next_id: torch.Tensor     # () i32


class TrackOutputs(NamedTuple):
    """Per-slot outputs of one step: all the host needs per frame."""

    boxes: torch.Tensor       # (S, 4) f32
    track_id: torch.Tensor    # (S,) i32
    class_id: torch.Tensor    # (S,) i32
    confidence: torch.Tensor  # (S,) f32
    age: torch.Tensor         # (S,) i32
    tsu: torch.Tensor         # (S,) i32
    visible: torch.Tensor     # (S,) bool


def init_track_state(max_tracks: int = 256,
                     device: str | torch.device = "cpu") -> TrackState:
    s = max_tracks
    f32, i32 = torch.float32, torch.int32
    return TrackState(
        active=torch.zeros((s,), dtype=torch.bool, device=device),
        boxes=torch.zeros((s, 4), dtype=f32, device=device),
        kf_mean=torch.zeros((s, 8), dtype=f32, device=device),
        kf_cov=torch.zeros(kf.cov_shape(s), dtype=f32, device=device),
        track_id=torch.zeros((s,), dtype=i32, device=device),
        class_id=torch.full((s,), -1, dtype=i32, device=device),
        confidence=torch.zeros((s,), dtype=f32, device=device),
        age=torch.zeros((s,), dtype=i32, device=device),
        tsu=torch.zeros((s,), dtype=i32, device=device),
        next_id=torch.ones((), dtype=i32, device=device),
    )


def claim_free_slots(active: torch.Tensor, is_new: torch.Tensor,
                     next_id: torch.Tensor):
    """The k-th new det (det order) claims the k-th free slot (slot order);
    births beyond the free-slot count target the sink index N and are
    dropped.  Returns (target_slot (D,), can_place (D,), new_ids (D,),
    newly_born (N,)), each with the stream axis of ``active`` (..., N)."""
    n = active.shape[-1]
    ar = torch.arange(n, device=active.device)
    free_order = torch.argsort(torch.where(~active, ar, n + ar), dim=-1)
    new_rank = torch.cumsum(is_new.int(), dim=-1) - 1
    num_free = torch.sum(~active, dim=-1, keepdim=True)
    can_place = is_new & (new_rank < num_free)
    target_slot = torch.where(can_place, free_order.gather(-1, new_rank.clamp(0, n - 1)), n)
    new_ids = next_id[..., None] + new_rank.int()
    newly_born = torch.zeros((*active.shape[:-1], n + 1), dtype=torch.bool,
                             device=active.device).scatter(-1, target_slot, True)
    return target_slot, can_place, new_ids, newly_born[..., :n]


def _scatter_rows(dst: torch.Tensor, slot: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """``dst.at[slot].set(src, mode="drop")`` per stream: ``dst`` (..., N,
    *row), ``slot`` (..., D); rows aimed at index N (one past the end) are
    dropped; the targeted in-range slots of a stream are distinct."""
    lead = slot.shape[:-1]
    a = len(lead)
    n, row = dst.shape[a], dst.shape[a + 1:]
    ext = torch.cat([dst, dst.narrow(a, 0, 1)], dim=a)        # (..., N + 1, *row)
    flat = slot
    if a:   # offset each stream's slots into the flattened (S * (N + 1)) rows
        flat = slot + (n + 1) * torch.arange(lead.numel(), device=slot.device).view(*lead, 1)
    src = src.to(dst.dtype).expand(*slot.shape, *row).reshape(-1, *row)
    ext = ext.reshape(-1, *row).index_copy(0, flat.reshape(-1), src)
    return ext.view(*lead, n + 1, *row).narrow(a, 0, n)


def _associate_and_update(state: TrackState, pred_boxes: torch.Tensor,
                          det_boxes: torch.Tensor, det_conf: torch.Tensor,
                          det_cls: torch.Tensor, det_eligible: torch.Tensor,
                          row_eligible: torch.Tensor, match_thresh: float,
                          use_kalman: bool, fuse_score: bool = False,
                          gate_distance: bool = False,
                          iou: torch.Tensor | None = None):
    """One association stage. Returns (state', matched_rows, matched_dets)."""
    if iou is None:
        iou = pairwise_iou(pred_boxes, det_boxes)
    sim = iou * det_conf[..., None, :] if fuse_score else iou
    if gate_distance and use_kalman:
        dist = kf.gating_distance(kf.KalmanState(state.kf_mean, state.kf_cov),
                                  xyxy_to_cxcyah(det_boxes)[..., None, :, :])
        sim = torch.where(dist <= _CHI2_95_4DOF, sim, -1.0)
    res = greedy_assign(sim, match_thresh, row_valid=row_eligible, col_valid=det_eligible)
    matched_rows = res.row_to_col >= 0
    det_of_row = res.row_to_col.clamp(min=0).long()

    m_boxes = torch.take_along_dim(det_boxes, det_of_row[..., None], dim=-2)
    m_conf = torch.take_along_dim(det_conf, det_of_row, dim=-1)
    m_cls = torch.take_along_dim(det_cls, det_of_row, dim=-1)

    if use_kalman:
        upd = kf.update(kf.KalmanState(state.kf_mean, state.kf_cov),
                        xyxy_to_cxcyah(m_boxes))
        new_mean = torch.where(matched_rows[..., None], upd.mean, state.kf_mean)
        new_cov = torch.where(matched_rows[..., None, None], upd.cov, state.kf_cov)
        out_boxes = torch.where(matched_rows[..., None], cxcyah_to_xyxy(new_mean[..., :4]),
                                state.boxes)
    else:
        new_mean, new_cov = state.kf_mean, state.kf_cov
        out_boxes = torch.where(matched_rows[..., None], m_boxes, state.boxes)

    state = state._replace(
        boxes=out_boxes,
        kf_mean=new_mean,
        kf_cov=new_cov,
        confidence=torch.where(matched_rows, m_conf, state.confidence),
        class_id=torch.where(matched_rows, m_cls, state.class_id),
        age=torch.where(matched_rows, state.age + 1, state.age),
        tsu=torch.where(matched_rows, 0, state.tsu),
    )
    return state, matched_rows, res.col_to_row >= 0


def bytetrack_update(state: TrackState, det_boxes: torch.Tensor,
                     det_conf: torch.Tensor, det_cls: torch.Tensor,
                     det_valid: torch.Tensor, cfg: ByteTrackConfig
                     ) -> tuple[TrackState, TrackOutputs]:
    """One tracking step over (D,) detections in source coordinates (or S
    streams' (S, D) detections against an S-leading state).  Visible tracks
    are active slots matched this frame (tsu == 0)."""
    use_kalman = cfg.motion_model == "kalman"
    det_boxes = det_boxes.float()
    det_conf = det_conf.float()
    det_cls = det_cls.int()
    accept = (cfg.match_thresh if cfg.match_metric == "iou"
              else 1.0 - cfg.match_thresh)

    # 0. Kalman predict for all active slots
    if use_kalman:
        pred = kf.predict(kf.KalmanState(state.kf_mean, state.kf_cov))
        kf_mean = torch.where(state.active[..., None], pred.mean, state.kf_mean)
        kf_cov = torch.where(state.active[..., None, None], pred.cov, state.kf_cov)
        state = state._replace(kf_mean=kf_mean, kf_cov=kf_cov)
        pred_boxes = torch.where(state.active[..., None], cxcyah_to_xyxy(kf_mean[..., :4]),
                                 state.boxes)
    else:
        pred_boxes = state.boxes

    # 1. split detections by confidence
    high = det_valid & (det_conf >= cfg.track_thresh)
    low = det_valid & ~high & (det_conf >= cfg.low_thresh)
    iou = pairwise_iou(pred_boxes, det_boxes)

    # 2. high dets vs all active tracks
    state, matched1, det_matched1 = _associate_and_update(
        state, pred_boxes, det_boxes, det_conf, det_cls,
        det_eligible=high, row_eligible=state.active, match_thresh=accept,
        use_kalman=use_kalman, fuse_score=cfg.fuse_score,
        gate_distance=cfg.gate_distance, iou=iou)
    # 3. low dets vs tracks unmatched so far (no score fusion here)
    state, matched2, _ = _associate_and_update(
        state, pred_boxes, det_boxes, det_conf, det_cls,
        det_eligible=low, row_eligible=state.active & ~matched1, match_thresh=accept,
        use_kalman=use_kalman, gate_distance=cfg.gate_distance, iou=iou)
    matched = matched1 | matched2

    # 4. births
    is_new = high & ~det_matched1 & (det_conf >= cfg.new_track_thresh)
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
        next_id=state.next_id + torch.sum(can_place.int(), dim=-1).int(),
    )

    # 5. age unmatched tracks, free the dead
    unmatched = state.active & ~matched & ~newly_born
    tsu = torch.where(unmatched, state.tsu + 1, state.tsu)
    active = state.active & (tsu <= cfg.track_buffer)
    state = state._replace(tsu=tsu, active=active)

    visible = state.active & (state.tsu == 0)
    return state, TrackOutputs(
        boxes=state.boxes, track_id=state.track_id, class_id=state.class_id,
        confidence=state.confidence, age=state.age, tsu=state.tsu, visible=visible)
