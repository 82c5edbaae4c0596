"""Self-contained MOTChallenge tracking evaluation (CLEAR MOT + identity).

The port's copy of ``rtmodt_tpu/evaluation/mot_eval.py`` (numpy + scipy),
unchanged in behaviour.  It implements the standard protocol directly:

  * per-frame GT<->hypothesis matching: carry over previous-frame pairings
    when still valid (CLEAR continuity rule), then optimal min-cost matching
    (scipy Hungarian) on 1 - IoU with a 0.5 gate;
  * MOTA = 1 - (FN + FP + IDSW) / num_gt;  MOTP = mean 1 - IoU of matches
    (motmetrics' distance convention);
  * IDF1 via global bipartite matching between GT and predicted trajectories
    on per-pair overlap counts (Ristani et al. 2016);
  * mostly_tracked / mostly_lost at the usual 80% / 20% coverage cuts;
  * HOTA (Luiten et al. 2021, the TrackEval reference protocol): detection
    and association accuracy balanced geometrically, averaged over 19
    localization thresholds - the modern headline tracking metric the
    reference's motmetrics stack predates (``evaluate_hota``).

MOT15-2D file rows: frame, id, bb_left, bb_top, bb_width, bb_height,
conf, x, y, z.
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np
from scipy.optimize import linear_sum_assignment

IOU_GATE = 0.5


def load_mot_txt(path: str) -> dict[int, dict[int, np.ndarray]]:
    """-> {frame: {track_id: xywh box}} (conf<=0 GT rows are kept: the MOT15
    format has no ignore flag; callers may pre-filter)."""
    frames: dict[int, dict[int, np.ndarray]] = defaultdict(dict)
    with open(path) as f:
        for line in f:
            parts = line.replace(";", ",").split(",")
            if len(parts) < 6:
                continue
            fr, tid = int(float(parts[0])), int(float(parts[1]))
            box = np.array([float(parts[2]), float(parts[3]),
                            float(parts[4]), float(parts[5])], np.float64)
            frames[fr][tid] = box
    return frames


def _iou_xywh(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    ax2, ay2 = a[:, 0] + a[:, 2], a[:, 1] + a[:, 3]
    bx2, by2 = b[:, 0] + b[:, 2], b[:, 1] + b[:, 3]
    ix = np.clip(np.minimum(ax2[:, None], bx2[None]) - np.maximum(a[:, None, 0], b[None, :, 0]), 0, None)
    iy = np.clip(np.minimum(ay2[:, None], by2[None]) - np.maximum(a[:, None, 1], b[None, :, 1]), 0, None)
    inter = ix * iy
    union = (a[:, 2] * a[:, 3])[:, None] + (b[:, 2] * b[:, 3])[None] - inter
    return inter / np.maximum(union, 1e-9)


def evaluate_mot(gt_frames: dict[int, dict[int, np.ndarray]],
                 pred_frames: dict[int, dict[int, np.ndarray]]) -> dict[str, float]:
    num_gt = 0
    fp = fn = idsw = 0
    match_dists: list[float] = []
    last_match: dict[int, int] = {}              # gt_id -> pred_id (most recent)
    # (gt_id, pred_id) -> frames where the PAIR's boxes overlap >= gate,
    # INDEPENDENT of the CLEAR per-frame assignment: Ristani ID measures
    # count every spatially-compatible frame, so a pair the CLEAR
    # continuity rule never picked can still win the global matching
    co_gate = defaultdict(int)
    gt_frames_count = defaultdict(int)           # gt_id -> #frames present
    gt_matched_count = defaultdict(int)          # gt_id -> #frames matched
    pred_frames_count = defaultdict(int)

    for fr in sorted(set(gt_frames) | set(pred_frames)):
        gts = gt_frames.get(fr, {})
        preds = pred_frames.get(fr, {})
        gt_ids = list(gts)
        pred_ids = list(preds)
        num_gt += len(gt_ids)
        for g in gt_ids:
            gt_frames_count[g] += 1
        for p in pred_ids:
            pred_frames_count[p] += 1

        if not gt_ids or not pred_ids:
            fn += len(gt_ids)
            fp += len(pred_ids)
            continue

        gt_boxes = np.stack([gts[g] for g in gt_ids])
        pred_boxes = np.stack([preds[p] for p in pred_ids])
        iou = _iou_xywh(gt_boxes, pred_boxes)
        for gi, pi in np.argwhere(iou >= IOU_GATE):
            co_gate[(gt_ids[gi], pred_ids[pi])] += 1

        matches: dict[int, int] = {}
        # CLEAR continuity: keep last frame's pairing if still above the gate
        used_p = set()
        for gi, g in enumerate(gt_ids):
            p = last_match.get(g)
            if p in preds and p not in used_p:
                pi = pred_ids.index(p)
                if iou[gi, pi] >= IOU_GATE:
                    matches[gi] = pi
                    used_p.add(p)
        # Hungarian on the rest
        free_g = [gi for gi in range(len(gt_ids)) if gi not in matches]
        free_p = [pi for pi in range(len(pred_ids)) if pred_ids[pi] not in used_p]
        if free_g and free_p:
            sub = 1.0 - iou[np.ix_(free_g, free_p)]
            sub[sub > 1.0 - IOU_GATE] = 1e6
            rows, cols = linear_sum_assignment(sub)
            for r, c in zip(rows, cols):
                if sub[r, c] < 1e6:
                    matches[free_g[r]] = free_p[c]

        for gi, pi in matches.items():
            g, p = gt_ids[gi], pred_ids[pi]
            if g in last_match and last_match[g] != p:
                idsw += 1
            last_match[g] = p
            gt_matched_count[g] += 1
            match_dists.append(1.0 - iou[gi, pi])
        fn += len(gt_ids) - len(matches)
        fp += len(pred_ids) - len(matches)

    # --- identity metrics (IDF1) via global trajectory matching ----------
    gt_ids_all = sorted(gt_frames_count)
    pr_ids_all = sorted(pred_frames_count)
    if gt_ids_all and pr_ids_all:
        cost = np.zeros((len(gt_ids_all), len(pr_ids_all)))
        for (g, p), n in co_gate.items():
            cost[gt_ids_all.index(g), pr_ids_all.index(p)] = -n
        rows, cols = linear_sum_assignment(cost)
        idtp = int(sum(-cost[r, c] for r, c in zip(rows, cols)))
    else:
        idtp = 0
    total_pred = sum(pred_frames_count.values())
    idfp = total_pred - idtp
    idfn = num_gt - idtp
    idf1 = 2 * idtp / max(2 * idtp + idfp + idfn, 1)

    mt = sum(1 for g in gt_ids_all
             if gt_matched_count[g] / gt_frames_count[g] >= 0.8)
    ml = sum(1 for g in gt_ids_all
             if gt_matched_count[g] / gt_frames_count[g] <= 0.2)

    out = {
        "idf1": float(idf1),
        "mota": float(1.0 - (fn + fp + idsw) / max(num_gt, 1)),
        "motp": float(np.mean(match_dists)) if match_dists else 0.0,
        "num_switches": int(idsw),
        "mostly_tracked": int(mt),
        "mostly_lost": int(ml),
    }
    out.update(evaluate_hota(gt_frames, pred_frames))
    return out


def evaluate_hota(gt_frames: dict[int, dict[int, np.ndarray]],
                  pred_frames: dict[int, dict[int, np.ndarray]],
                  ) -> dict[str, float]:
    """HOTA = mean over alpha of sqrt(DetA(a) * AssA(a)).

    Follows the official TrackEval two-pass algorithm exactly:

      pass 1: accumulate per-(gt_id, pred_id) "potential match" mass using
        the Jaccard-normalized per-frame similarity, plus per-ID frame
        counts, giving a global alignment score per trajectory pair;
      pass 2: per frame, Hungarian-maximize ``global_alignment * iou`` and
        accept pairs with iou >= alpha, accumulating TP/FN/FP and the
        accepted pair-match counts per alpha;
      AssA(a) = TP-weighted mean of the matched pairs' association
        Jaccard ``A(g,p) = TPA / (gt_count + pred_count - TPA)``;
      DetA(a) = TP / (TP + FN + FP);  LocA(a) = mean TP similarity.

    Returns {hota, det_a, ass_a, loc_a} averaged over the 19 thresholds
    alpha = 0.05..0.95.
    """
    alphas = np.arange(0.05, 0.99, 0.05)
    na = len(alphas)
    gt_ids_all = sorted({g for d in gt_frames.values() for g in d})
    pr_ids_all = sorted({p for d in pred_frames.values() for p in d})
    g_index = {g: i for i, g in enumerate(gt_ids_all)}
    p_index = {p: i for i, p in enumerate(pr_ids_all)}
    ng, np_ = len(gt_ids_all), len(pr_ids_all)
    if ng == 0 or np_ == 0:
        # degenerate sequences: HOTA is 0 unless both are empty
        empty = not gt_ids_all and not pr_ids_all
        val = 1.0 if empty else 0.0
        return {"hota": val, "det_a": val, "ass_a": val, "loc_a": val}

    frames = sorted(set(gt_frames) | set(pred_frames))
    per_frame = []                       # (g_idx row, p_idx col, iou matrix)
    potential = np.zeros((ng, np_))
    gt_count = np.zeros(ng)
    pr_count = np.zeros(np_)
    for fr in frames:
        gts = gt_frames.get(fr, {})
        preds = pred_frames.get(fr, {})
        gi = np.array([g_index[g] for g in gts], int)
        pi = np.array([p_index[p] for p in preds], int)
        gt_count[gi] += 1
        pr_count[pi] += 1
        if len(gi) and len(pi):
            iou = _iou_xywh(np.stack(list(gts.values())),
                            np.stack(list(preds.values())))
        else:
            iou = np.zeros((len(gi), len(pi)))
        per_frame.append((gi, pi, iou))
        if iou.size:
            denom = iou.sum(0)[None, :] + iou.sum(1)[:, None] - iou
            sim = np.where(denom > np.finfo(float).eps, iou / np.maximum(denom, 1e-12), 0.0)
            potential[np.ix_(gi, pi)] += sim

    global_align = potential / np.maximum(
        gt_count[:, None] + pr_count[None, :] - potential, 1e-12)

    tp = np.zeros(na)
    fn = np.zeros(na)
    fp = np.zeros(na)
    loc_sum = np.zeros(na)
    match_counts = [np.zeros((ng, np_)) for _ in range(na)]
    for gi, pi, iou in per_frame:
        if iou.size:
            score = global_align[np.ix_(gi, pi)] * iou
            rows, cols = linear_sum_assignment(-score)
        else:
            rows = cols = np.array([], int)
        for ai, alpha in enumerate(alphas):
            ok = iou[rows, cols] >= alpha - np.finfo(float).eps if len(rows) \
                else np.array([], bool)
            n_match = int(ok.sum())
            tp[ai] += n_match
            fn[ai] += len(gi) - n_match
            fp[ai] += len(pi) - n_match
            if n_match:
                loc_sum[ai] += float(iou[rows[ok], cols[ok]].sum())
                match_counts[ai][gi[rows[ok]], pi[cols[ok]]] += 1

    det_a = tp / np.maximum(tp + fn + fp, 1)
    ass_a = np.zeros(na)
    for ai in range(na):
        mc = match_counts[ai]
        pair_ass = mc / np.maximum(
            gt_count[:, None] + pr_count[None, :] - mc, 1e-12)
        ass_a[ai] = float((mc * pair_ass).sum() / max(tp[ai], 1))
    loc_a = np.where(tp > 0, loc_sum / np.maximum(tp, 1), 1.0)
    hota = np.sqrt(det_a * ass_a)
    return {
        "hota": float(hota.mean()),
        "det_a": float(det_a.mean()),
        "ass_a": float(ass_a.mean()),
        "loc_a": float(loc_a.mean()),
    }
