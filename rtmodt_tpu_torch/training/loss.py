"""YOLOv8 detection loss: CIoU box + BCE cls + Distribution Focal Loss (port
of ``rtmodt_tpu/training/loss.py``), over the static (B, A) anchor grid with
the gains 7.5 / 0.5 / 1.5.  The assigner sees detached predictions; BCE is
optax's log-sigmoid form.

In a rank of a data-parallel step (``distributed``) each rank's loss is its
part of the global loss: its own sums over the global ``score_sum``, which
is all-reduced (without a gradient) before the clamp, as the reference
normalises over the whole sharded batch.  The parts summed over the ranks
are the global loss."""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as tdist
import torch.nn.functional as F

from rtmodt_tpu_torch.models.yolov8 import REG_MAX, decode_predictions
from rtmodt_tpu_torch.ops.iou import ciou
from rtmodt_tpu_torch.ops.nms import _anchors
from rtmodt_tpu_torch.training.assigner import assign


class LossBreakdown(NamedTuple):
    total: torch.Tensor
    box: torch.Tensor
    cls: torch.Tensor
    dfl: torch.Tensor
    num_fg: torch.Tensor


def _dfl_loss(box_dist: torch.Tensor, target_ltrb: torch.Tensor) -> torch.Tensor:
    """Distribution focal loss per anchor, summed over the 4 sides.
    ``box_dist`` (..., 4, REG_MAX) logits; ``target_ltrb`` (..., 4) distances
    in stride units, clipped to [0, REG_MAX - 1 - 1e-3] and split between
    the two integer bins around them."""
    t = target_ltrb.clamp(0.0, REG_MAX - 1 - 1e-3)
    tl = torch.floor(t)
    wr = t - tl
    wl = 1.0 - wr
    logp = torch.log_softmax(box_dist, dim=-1)
    il = tl.long()
    lp_l = torch.gather(logp, -1, il[..., None])[..., 0]
    lp_r = torch.gather(logp, -1, (il + 1)[..., None])[..., 0]
    return -(wl * lp_l + wr * lp_r).sum(dim=-1)


def sigmoid_bce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """optax's ``sigmoid_binary_cross_entropy``, element-wise."""
    return -labels * F.logsigmoid(logits) - (1.0 - labels) * F.logsigmoid(-logits)


def yolo_loss(box_dist: torch.Tensor, cls_logits: torch.Tensor, gt_boxes: torch.Tensor,
              gt_labels: torch.Tensor, gt_mask: torch.Tensor, input_size: int,
              box_gain: float = 7.5, cls_gain: float = 0.5, dfl_gain: float = 1.5,
              distributed: bool = False) -> LossBreakdown:
    """``box_dist`` (B, A, 4*REG_MAX) and ``cls_logits`` (B, A, C) raw head
    outputs; GT (B, M, ...) padded, xyxy in input pixels.  ``distributed``:
    normalise by the ``score_sum`` of every rank's batch slice."""
    b, a, _ = cls_logits.shape
    anchors, strides = _anchors(input_size, cls_logits.device)            # (A, 2), (A, 1)
    pred_boxes, pred_scores = decode_predictions(box_dist, cls_logits, input_size)

    res = assign(pred_scores.detach(), pred_boxes.detach(), anchors,
                 gt_boxes, gt_labels, gt_mask)
    score_sum = res.target_scores.sum().detach()
    if distributed:
        tdist.all_reduce(score_sum, op=tdist.ReduceOp.SUM)
    score_sum = torch.clamp(score_sum, min=1.0)

    # cls: BCE against soft targets over all anchors
    cls_l = sigmoid_bce(cls_logits.float(), res.target_scores).sum() / score_sum

    # box: CIoU on assigned anchors, weighted by target score
    w = res.target_scores.sum(-1) * res.fg_mask
    iou_term = 1.0 - ciou(pred_boxes, res.target_boxes)
    box_l = (iou_term * w).sum() / score_sum

    # dfl
    tx1y1 = (anchors[None] - res.target_boxes[..., :2]) / strides[None]
    tx2y2 = (res.target_boxes[..., 2:] - anchors[None]) / strides[None]
    target_ltrb = torch.cat([tx1y1, tx2y2], dim=-1)
    dist = box_dist.float().reshape(b, a, 4, REG_MAX)
    dfl_l = (_dfl_loss(dist, target_ltrb) * w).sum() / score_sum

    total = box_gain * box_l + cls_gain * cls_l + dfl_gain * dfl_l
    return LossBreakdown(total, box_l, cls_l, dfl_l, res.fg_mask.sum().to(torch.int32))
