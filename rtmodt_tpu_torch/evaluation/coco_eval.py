"""Self-contained COCO-style detection evaluation (mAP).

The port's copy of ``rtmodt_tpu/evaluation/coco_eval.py`` (numpy only).
pycocotools (the upstream evaluator) is a C extension that is not a
dependency here, so the repository ships its own implementation of the
COCOeval bbox protocol:

  * greedy per-image, per-category matching of detections (sorted by score)
    to ground truth at an IoU threshold, crowd regions ignored;
  * 101-point interpolated precision averaged over recall, per category;
  * AP averaged over categories (and optionally over IoU thresholds
    0.5:0.95 for the COCO headline metric).
"""

from __future__ import annotations

import json
from collections import defaultdict
from typing import Any

import numpy as np

RECALL_THRS = np.linspace(0.0, 1.0, 101)
IOU_THRS_COCO = np.round(np.arange(0.5, 1.0, 0.05), 2)


def _iou_xywh(det: np.ndarray, gt: np.ndarray, iscrowd: np.ndarray) -> np.ndarray:
    """IoU between det (D, 4) and gt (G, 4) boxes in xywh; for crowd GT the
    denominator is the det area only (COCO protocol)."""
    if len(det) == 0 or len(gt) == 0:
        return np.zeros((len(det), len(gt)), np.float64)
    dx1, dy1 = det[:, 0], det[:, 1]
    dx2, dy2 = det[:, 0] + det[:, 2], det[:, 1] + det[:, 3]
    gx1, gy1 = gt[:, 0], gt[:, 1]
    gx2, gy2 = gt[:, 0] + gt[:, 2], gt[:, 1] + gt[:, 3]
    ix = np.clip(np.minimum(dx2[:, None], gx2[None]) - np.maximum(dx1[:, None], gx1[None]), 0, None)
    iy = np.clip(np.minimum(dy2[:, None], gy2[None]) - np.maximum(dy1[:, None], gy1[None]), 0, None)
    inter = ix * iy
    d_area = (det[:, 2] * det[:, 3])[:, None]
    g_area = (gt[:, 2] * gt[:, 3])[None, :]
    union = np.where(iscrowd[None, :], d_area, d_area + g_area - inter)
    return inter / np.maximum(union, 1e-9)


class COCODetEval:
    """Evaluate COCO-format predictions against COCO-format ground truth."""

    def __init__(self, gt: dict[str, Any], predictions: list[dict[str, Any]],
                 max_dets: int = 100):
        self.max_dets = max_dets
        self.cat_ids = sorted({c["id"] for c in gt.get("categories", [])} or
                              {a["category_id"] for a in gt["annotations"]})
        self.img_ids = sorted({i["id"] for i in gt.get("images", [])} or
                              {a["image_id"] for a in gt["annotations"]})
        self._gt = defaultdict(list)
        for a in gt["annotations"]:
            self._gt[(a["image_id"], a["category_id"])].append(a)
        self._dt = defaultdict(list)
        for p in predictions:
            self._dt[(p["image_id"], p["category_id"])].append(p)

    @classmethod
    def from_files(cls, gt_json: str, pred_json: str, **kw) -> "COCODetEval":
        with open(gt_json) as f:
            gt = json.load(f)
        with open(pred_json) as f:
            preds = json.load(f)
        if isinstance(preds, dict):
            preds = preds.get("annotations", [])
        return cls(gt, preds, **kw)

    def _match_one(self, img_id: int, cat_id: int, iou_thrs: np.ndarray):
        """Match dets to gts for one (image, category) at every IoU threshold.

        Returns (scores (D,), matched (T, D) bool, n_gt) with dets sorted by
        descending score; ignored dets (crowd-matched) are marked -1.
        """
        gts = self._gt.get((img_id, cat_id), [])
        dts = sorted(self._dt.get((img_id, cat_id), []),
                     key=lambda d: -d["score"])[: self.max_dets]
        n_ignore = sum(1 for g in gts if g.get("iscrowd", 0))
        n_gt = len(gts) - n_ignore
        if not dts:
            return np.zeros(0), np.zeros((len(iou_thrs), 0), np.int8), n_gt
        # order gts: real first, crowd last (COCO sorts ignored last)
        gts = sorted(gts, key=lambda g: g.get("iscrowd", 0))
        gt_boxes = np.array([g["bbox"] for g in gts], np.float64).reshape(-1, 4)
        crowd = np.array([bool(g.get("iscrowd", 0)) for g in gts])
        det_boxes = np.array([d["bbox"] for d in dts], np.float64).reshape(-1, 4)
        scores = np.array([d["score"] for d in dts], np.float64)
        iou = _iou_xywh(det_boxes, gt_boxes, crowd)

        t_count = len(iou_thrs)
        flags = np.zeros((t_count, len(dts)), np.int8)  # 1=TP, 0=FP, -1=ignore
        for ti, thr in enumerate(iou_thrs):
            gt_used = np.zeros(len(gts), bool)
            for di in range(len(dts)):
                best, best_iou = -1, thr
                for gi in range(len(gts)):
                    if gt_used[gi] and not crowd[gi]:
                        continue
                    # prefer real gt over crowd even at lower iou (COCO rule:
                    # once matched to real gt, stop considering crowd)
                    if best > -1 and not crowd[best] and crowd[gi]:
                        break
                    if iou[di, gi] >= best_iou:
                        best, best_iou = gi, iou[di, gi]
                if best == -1:
                    continue
                if crowd[best]:
                    flags[ti, di] = -1
                else:
                    gt_used[best] = True
                    flags[ti, di] = 1
        return scores, flags, n_gt

    def accumulate(self, iou_thrs: np.ndarray) -> dict[str, Any]:
        """AP/AR per category, averaged - the COCOeval 'accumulate' stage."""
        t_count = len(iou_thrs)
        ap_per_cat: list[np.ndarray] = []
        ar_per_cat: list[np.ndarray] = []
        prec_curves = np.zeros((t_count, len(RECALL_THRS), len(self.cat_ids)))
        prec_curves.fill(-1)

        for ci, cat in enumerate(self.cat_ids):
            all_scores, all_flags, total_gt = [], [], 0
            for img in self.img_ids:
                s, f, n = self._match_one(img, cat, iou_thrs)
                all_scores.append(s)
                all_flags.append(f)
                total_gt += n
            scores = np.concatenate(all_scores)
            flags = np.concatenate(all_flags, axis=1) if all_flags else np.zeros((t_count, 0), np.int8)
            if total_gt == 0:
                ap_per_cat.append(np.full(t_count, np.nan))
                ar_per_cat.append(np.full(t_count, np.nan))
                continue
            order = np.argsort(-scores, kind="mergesort")
            flags = flags[:, order]
            ap_t = np.zeros(t_count)
            ar_t = np.zeros(t_count)
            for ti in range(t_count):
                f = flags[ti]
                keep = f >= 0  # drop ignored
                tp = np.cumsum(f[keep] == 1)
                fp = np.cumsum(f[keep] == 0)
                recall = tp / total_gt
                precision = tp / np.maximum(tp + fp, 1e-9)
                # monotone precision envelope
                for i in range(len(precision) - 1, 0, -1):
                    precision[i - 1] = max(precision[i - 1], precision[i])
                # 101-point interpolation
                idx = np.searchsorted(recall, RECALL_THRS, side="left")
                p_interp = np.where(idx < len(precision), precision[np.minimum(idx, max(len(precision) - 1, 0))], 0.0) \
                    if len(precision) else np.zeros(len(RECALL_THRS))
                prec_curves[ti, :, ci] = p_interp
                ap_t[ti] = p_interp.mean()
                ar_t[ti] = recall[-1] if len(recall) else 0.0
            ap_per_cat.append(ap_t)
            ar_per_cat.append(ar_t)

        ap = np.array(ap_per_cat)  # (C, T)
        ar = np.array(ar_per_cat)
        return {
            "ap_per_cat": ap,
            "ar_per_cat": ar,
            "mAP": float(np.nanmean(ap)) if np.isfinite(ap).any() else 0.0,
            "mAR": float(np.nanmean(ar)) if np.isfinite(ar).any() else 0.0,
            "precision_curves": prec_curves,
        }

    def evaluate(self, iou_thresh: float | None = 0.5) -> dict[str, float]:
        """Headline numbers. ``iou_thresh=None`` -> COCO mAP@[0.5:0.95]."""
        thrs = np.array([iou_thresh]) if iou_thresh is not None else IOU_THRS_COCO
        acc = self.accumulate(thrs)
        valid = acc["precision_curves"][acc["precision_curves"] > -1]
        ap0 = (float(np.nanmean(acc["ap_per_cat"][:, 0]))
               if len(acc["ap_per_cat"]) else 0.0)
        out = {
            "mAP": acc["mAP"],
            # column 0 is AP at thrs[0]; only label it mAP_50 when that is
            # actually the 0.5 threshold (a custom iou_thresh=0.75 run used
            # to return its AP@0.75 under the mAP_50 key)
            f"mAP_{int(round(thrs[0] * 100))}": ap0,
            "precision": float(valid.mean()) if valid.size else 0.0,
            "recall": acc["mAR"],
        }
        return out
