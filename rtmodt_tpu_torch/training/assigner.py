"""Task-Aligned Assigner (TAL) for anchor-free YOLOv8 training, batched over
padded GT slots (port of ``rtmodt_tpu/training/assigner.py``).

  1. candidate anchors = those whose center lies inside the GT box;
  2. alignment metric t = score^alpha * IoU^beta per (gt, anchor);
  3. keep the top-k anchors per GT by t (ties: the lower anchor index, as
     ``lax.top_k``; a stable sort here, since ``torch.topk`` promises no
     order);
  4. an anchor claimed by several GTs goes to the GT of highest IoU (the
     first on ties, as ``jnp.argmax``);
  5. cls targets = alignment metric normalized per GT to its max IoU.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from rtmodt_tpu_torch.ops.iou import box_iou
from rtmodt_tpu_torch.ops.nms import _stable_topk


class AssignResult(NamedTuple):
    target_boxes: torch.Tensor    # (B, A, 4) xyxy
    target_scores: torch.Tensor   # (B, A, C) soft cls targets
    fg_mask: torch.Tensor         # (B, A) bool - anchor is assigned
    target_gt_idx: torch.Tensor   # (B, A) int32 - index of assigned GT slot


@torch.no_grad()
def assign(pred_scores: torch.Tensor, pred_boxes: torch.Tensor, anchors: torch.Tensor,
           gt_boxes: torch.Tensor, gt_labels: torch.Tensor, gt_mask: torch.Tensor,
           topk: int = 10, alpha: float = 0.5, beta: float = 6.0,
           eps: float = 1e-9) -> AssignResult:
    """``pred_scores`` (B, A, C) post-sigmoid, ``pred_boxes`` (B, A, 4) xyxy
    in input pixels, ``anchors`` (A, 2) centers, ``gt_boxes`` (B, M, 4),
    ``gt_labels`` (B, M) int, ``gt_mask`` (B, M) bool."""
    b, a, c = pred_scores.shape
    m = gt_boxes.shape[1]
    dev = pred_scores.device

    # -- candidates: anchor center inside GT
    ax = anchors[None, None, :, 0]
    ay = anchors[None, None, :, 1]
    in_gt = ((ax >= gt_boxes[..., 0:1]) & (ax < gt_boxes[..., 2:3])
             & (ay >= gt_boxes[..., 1:2]) & (ay < gt_boxes[..., 3:4]))     # (B, M, A)
    in_gt = in_gt & gt_mask[..., None]

    # -- alignment metric
    iou = box_iou(gt_boxes[:, :, None, :], pred_boxes[:, None, :, :]).clamp(min=0.0)
    cls_idx = gt_labels.long().clamp(0, c - 1)
    score = torch.gather(pred_scores.transpose(1, 2), 1,
                         cls_idx[..., None].expand(b, m, a))               # (B, M, A)
    metric = (score ** alpha) * (iou ** beta)
    metric = torch.where(in_gt, metric, 0.0)

    # -- top-k per GT (explicit indices: ties beyond k are not kept)
    k = min(topk, a)
    topk_vals, topk_idx = _stable_topk(metric, k)                          # (B, M, k)
    is_topk = torch.zeros((b, m, a), dtype=torch.bool, device=dev)
    is_topk.scatter_(2, topk_idx, topk_vals > 0.0)

    # -- resolve multi-GT anchors by highest IoU
    cand_iou = torch.where(is_topk, iou, -1.0)
    best_gt = torch.argmax(cand_iou, dim=1)                                # (B, A)
    fg = is_topk.any(dim=1)                                                # (B, A)
    keep = is_topk & (torch.arange(m, device=dev)[None, :, None] == best_gt[:, None, :])

    # -- targets
    tgt_boxes = torch.gather(gt_boxes, 1, best_gt[..., None].expand(b, a, 4))
    tgt_boxes = torch.where(fg[..., None], tgt_boxes, 0.0)
    tgt_labels = torch.gather(cls_idx, 1, best_gt)                          # (B, A)

    # per-GT normalization: t_hat = t / max_t(gt) * max_iou(gt)
    metric_kept = torch.where(keep, metric, 0.0)
    iou_kept = torch.where(keep, iou, 0.0)
    max_metric = metric_kept.amax(dim=-1, keepdim=True)                    # (B, M, 1)
    max_iou = iou_kept.amax(dim=-1, keepdim=True)
    norm = metric_kept * max_iou / torch.clamp(max_metric, min=eps)        # (B, M, A)
    anchor_score = norm.amax(dim=1)                                        # (B, A)

    target_scores = F.one_hot(tgt_labels, c).to(pred_scores.dtype) * anchor_score[..., None]
    target_scores = torch.where(fg[..., None], target_scores, 0.0)
    return AssignResult(tgt_boxes.float(), target_scores.float(), fg,
                        best_gt.to(torch.int32))
