"""Offline evaluation: ``evaluate_detection``, ``evaluate_tracking``,
``build_confusion_matrix`` and ``measure_tracking_drift``.

The port's copy of ``rtmodt_tpu/evaluation/metrics.py``, with the same
four public functions and return schemas:
  * ``evaluate_detection(gt_json, pred_json, iou_thresh)`` ->
    {mAP, mAP_50, precision, recall}
  * ``evaluate_tracking(gt_mot, pred_mot)`` ->
    {idf1, mota, motp, num_switches, mostly_tracked, mostly_lost, ...}
  * ``build_confusion_matrix(gt, pred, n)``
  * ``measure_tracking_drift(gt_c, pred_c)``

Implemented on the port's own numpy evaluators (``coco_eval.py``,
``mot_eval.py``).
"""

from __future__ import annotations

import numpy as np

from rtmodt_tpu_torch.utils.logging import logger


def evaluate_detection(gt_coco_json: str, pred_coco_json: str,
                       iou_thresh: float = 0.5) -> dict[str, float]:
    from rtmodt_tpu_torch.evaluation.coco_eval import COCODetEval

    ev = COCODetEval.from_files(gt_coco_json, pred_coco_json)
    result = ev.evaluate(iou_thresh)
    logger.info(f"Detection eval | mAP@{iou_thresh:.2f} = {result['mAP']:.4f}")
    return result


def evaluate_tracking(gt_mot_file: str, pred_mot_file: str) -> dict[str, float]:
    from rtmodt_tpu_torch.evaluation.mot_eval import evaluate_mot, load_mot_txt

    result = evaluate_mot(load_mot_txt(gt_mot_file), load_mot_txt(pred_mot_file))
    logger.info(f"Tracking eval | IDF1={result['idf1']:.4f} "
                f"MOTA={result['mota']:.4f} HOTA={result['hota']:.4f} "
                f"Switches={result['num_switches']}")
    return result


def build_confusion_matrix(gt_labels: np.ndarray, pred_labels: np.ndarray,
                           num_classes: int) -> np.ndarray:
    """(num_classes x num_classes) confusion matrix; rows = GT, cols = pred."""
    gt = np.asarray(gt_labels, np.int64)
    pr = np.asarray(pred_labels, np.int64)
    ok = (gt >= 0) & (gt < num_classes) & (pr >= 0) & (pr < num_classes)
    cm = np.zeros((num_classes, num_classes), np.int64)
    np.add.at(cm, (gt[ok], pr[ok]), 1)
    return cm


def measure_tracking_drift(
    gt_centroids: dict[int, list[tuple[int, int]]],
    pred_centroids: dict[int, list[tuple[int, int]]],
) -> dict[str, object]:
    """Mean centroid L2 distance per matched track ID across frames."""
    drifts: list[float] = []
    per_track: dict[int, float] = {}
    for tid in set(gt_centroids) & set(pred_centroids):
        g = np.asarray(gt_centroids[tid], np.float32)
        p = np.asarray(pred_centroids[tid], np.float32)
        n = min(len(g), len(p))
        d = np.linalg.norm(g[:n] - p[:n], axis=1)
        per_track[tid] = float(d.mean()) if n else 0.0
        drifts.extend(d.tolist())
    mean_drift = float(np.mean(drifts)) if drifts else 0.0
    logger.info(f"Tracking drift | mean={mean_drift:.2f}px across "
                f"{len(per_track)} tracks")
    return {"mean_drift_px": mean_drift, "per_track": per_track}
