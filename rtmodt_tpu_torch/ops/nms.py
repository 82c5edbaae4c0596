"""Class-aware NMS with static shapes, batched over the frames of a chunk.

Port of ``rtmodt_tpu/ops/nms.py``'s decode-after-top-k path
(``batched_nms_from_logits`` = ``_candidates_from_logits`` +
``_suppress_and_pack``):

  1. per-anchor best class in LOGIT space (sigmoid is monotonic), the class
     keep-mask as -1e9, the confidence gate ``logit >= log(t / (1 - t))``;
  2. top-k down to ``num_candidates`` (default 300), then the DFL softmax
     and box decode for those candidates only;
  3. class-offset boxes (``class * 7680``) and exact greedy suppression by
     the CUDA kernel (``ops/nms_kernel.py``) for every ``nms_impl`` value;
  4. top-``max_det`` of the kept scores, padded with class -1.

Top-k is a stable descending sort, so equal values keep index order as
``lax.top_k`` does; ``topk_impl: approx`` is exact here, as it is on the
reference's CPU backend.

``nms_debug_from_logits`` is the reference's diagnostic (rounds, pool used,
kept) over one frame: it runs the reference's fixpoint formulation of greedy
suppression (``greedy_suppress_fixpoint``) in plain torch to count its
rounds.  It is off the main path, where K1 suppresses.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch

from rtmodt_tpu_torch.models.yolov8 import REG_MAX, make_anchors
from rtmodt_tpu_torch.ops.iou import pairwise_iou
from rtmodt_tpu_torch.ops.nms_kernel import greedy_suppress

CLASS_OFFSET = 7680.0  # > any letterboxed coordinate; class-aware suppression
NEG = -1e9


class NMSResult(NamedTuple):
    boxes: torch.Tensor    # (B, max_det, 4) xyxy, model-input coords
    scores: torch.Tensor   # (B, max_det)
    classes: torch.Tensor  # (B, max_det) int32, -1 where invalid
    valid: torch.Tensor    # (B, max_det) bool
    count: torch.Tensor    # (B,) int32


@functools.lru_cache(maxsize=8)
def _anchors(input_size: int, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    return make_anchors(input_size, device=device)


def _stable_topk(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last axis, descending, ties in index order."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, N, ...) gathered at idx (B, k) along axis 1 -> (B, k, ...)."""
    return x[torch.arange(x.shape[0], device=x.device)[:, None], idx]


def candidates_from_logits(box_dist: torch.Tensor, cls_logits: torch.Tensor,
                           input_size: int, conf_thresh: float, num_candidates: int,
                           class_mask: torch.Tensor | None = None):
    """Decode-after-top-k candidate pool.  ``box_dist`` (B, A, 4*REG_MAX),
    ``cls_logits`` (B, A, C) -> (boxes (B, k, 4), scores (B, k), classes
    (B, k) int32, k)."""
    f32 = torch.float32
    dev = cls_logits.device
    logits = cls_logits.to(f32)
    if class_mask is not None:
        logits = torch.where(class_mask, logits, NEG)
    best_logit, best_class = logits.max(dim=-1)
    t = min(max(float(conf_thresh), 1e-9), 1.0 - 1e-9)
    logit_thresh = torch.tensor(math.log(t / (1.0 - t)), dtype=f32, device=dev)
    gated = torch.where(best_logit >= logit_thresh, best_logit, NEG)

    k = min(num_candidates, cls_logits.shape[1])
    top_logits, top_idx = _stable_topk(gated, k)
    cand_scores = torch.where(top_logits > -1e8, torch.sigmoid(top_logits), 0.0)
    cand_classes = torch.gather(best_class, 1, top_idx).to(torch.int32)

    anchors, strides = _anchors(input_size, dev)
    cd = _gather_rows(box_dist, top_idx).to(f32).reshape(*top_idx.shape, 4, REG_MAX)
    bins = torch.arange(REG_MAX, dtype=f32, device=dev)
    ltrb = torch.sum(torch.softmax(cd, dim=-1) * bins, dim=-1) * strides[top_idx]
    a = anchors[top_idx]
    cand_boxes = torch.cat([a - ltrb[..., :2], a + ltrb[..., 2:]], dim=-1)
    return cand_boxes, cand_scores, cand_classes, k


def suppress_and_pack(cand_boxes: torch.Tensor, cand_scores: torch.Tensor,
                      cand_classes: torch.Tensor, iou_thresh: float, max_det: int,
                      agnostic: bool = False) -> NMSResult:
    """Class-offset greedy suppression + static ``max_det`` packing."""
    b, k = cand_scores.shape
    if agnostic:
        offset_boxes = cand_boxes
    else:
        offset_boxes = cand_boxes + (cand_classes.float() * CLASS_OFFSET)[..., None]
    keep = greedy_suppress(offset_boxes.contiguous(), cand_scores.contiguous(), iou_thresh)
    keep = keep & (cand_scores > 0.0)

    kept_scores = torch.where(keep, cand_scores, -1.0)
    m = min(max_det, k)
    final_scores, sel = _stable_topk(kept_scores, m)
    valid = final_scores > 0.0
    out_boxes = torch.where(valid[..., None], _gather_rows(cand_boxes, sel), 0.0)
    out_scores = torch.where(valid, final_scores, 0.0)
    out_classes = torch.where(valid, torch.gather(cand_classes, 1, sel), -1).to(torch.int32)
    if m < max_det:
        pad = max_det - m
        out_boxes = torch.cat([out_boxes, out_boxes.new_zeros((b, pad, 4))], dim=1)
        out_scores = torch.cat([out_scores, out_scores.new_zeros((b, pad))], dim=1)
        out_classes = torch.cat([out_classes, out_classes.new_full((b, pad), -1)], dim=1)
        valid = torch.cat([valid, valid.new_zeros((b, pad))], dim=1)
    return NMSResult(out_boxes, out_scores, out_classes, valid,
                     valid.sum(dim=1).to(torch.int32))


def batched_nms_from_logits(box_dist: torch.Tensor, cls_logits: torch.Tensor,
                            input_size: int, conf_thresh: float, iou_thresh: float,
                            max_det: int = 100, num_candidates: int = 300,
                            class_mask: torch.Tensor | None = None,
                            agnostic: bool = False) -> NMSResult:
    """Class-aware NMS straight from the raw head outputs of B frames."""
    cand_boxes, cand_scores, cand_classes, _ = candidates_from_logits(
        box_dist, cls_logits, input_size, conf_thresh, num_candidates, class_mask)
    return suppress_and_pack(cand_boxes, cand_scores, cand_classes, iou_thresh,
                             max_det, agnostic)


def greedy_suppress_fixpoint(iou: torch.Tensor, scores: torch.Tensor, iou_thresh: float
                             ) -> tuple[torch.Tensor, int]:
    """Exact greedy suppression of score-sorted candidates as the reference's
    fixpoint iteration (``rtmodt_tpu/ops/nms.py::_greedy_suppress``): with
    ``conflict[i, j] = i < j and iou > t and score_i > 0``, iterate ``keep[j]
    = not any_i(conflict[i, j] and keep[i])`` from all-kept until it stops
    changing (at most K rounds).  Returns (keep (K,) bool, rounds): the
    rounds the reference counts, 1 for the first step plus one per step that
    changed ``keep``."""
    k = iou.shape[0]
    upper = torch.ones((k, k), dtype=torch.bool, device=iou.device).triu(1)
    conflict = upper & (iou > iou_thresh) & (scores[:, None] > 0.0)

    def step(keep: torch.Tensor) -> torch.Tensor:
        return ~(conflict & keep[:, None]).any(dim=0)

    prev = torch.ones(k, dtype=torch.bool, device=iou.device)
    keep, rounds = step(prev), 1
    while rounds < k and bool((keep != prev).any()):
        keep, prev = step(keep), keep
        rounds += 1
    return keep, rounds


def nms_debug_from_logits(box_dist: torch.Tensor, cls_logits: torch.Tensor,
                          input_size: int, conf_thresh: float, iou_thresh: float,
                          num_candidates: int = 300,
                          class_mask: torch.Tensor | None = None,
                          agnostic: bool = False) -> tuple[int, int, int]:
    """Diagnostics of one frame's NMS (``box_dist`` (A, 4*REG_MAX),
    ``cls_logits`` (A, C)): (fixpoint rounds until convergence, candidates
    past the confidence gate, survivors of suppression), as the reference's
    ``nms_debug_from_logits`` returns them."""
    cand_boxes, cand_scores, cand_classes, _ = candidates_from_logits(
        box_dist[None], cls_logits[None], input_size, conf_thresh, num_candidates,
        class_mask)
    cand_boxes, cand_scores, cand_classes = cand_boxes[0], cand_scores[0], cand_classes[0]
    if agnostic:
        offset_boxes = cand_boxes
    else:
        offset_boxes = cand_boxes + (cand_classes.float() * CLASS_OFFSET)[:, None]
    keep, rounds = greedy_suppress_fixpoint(pairwise_iou(offset_boxes, offset_boxes),
                                            cand_scores, iou_thresh)
    keep = keep & (cand_scores > 0.0)
    return rounds, int((cand_scores > 0.0).sum()), int(keep.sum())
