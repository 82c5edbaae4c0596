"""The comparison that decides ``correct``: what the timed path produced
against the plain reference under ``perfbench/reference/``.

Layers and numbers (each with its own limit, ``perfbench/limits/<cell>.json``):

  * ``planes_bytes_off``: bytes of the packed planes of the sampled chunks
    (every sampled stream) that differ from the reference's pack of the
    same camera frames;
  * ``det_box_gap_mean_px``: the mean, over the program's detections (after
    K1) in every frame of the sampled streams in the window, of the widest
    coordinate gap in camera pixels to the reference detection each matches
    one to one (same class, IoU >= 0.5, greedy by IoU); the reference runs
    the float32 detector of the configuration's architecture module
    (``perfbench/archs/<arch>.py``) on its own planes.  The mean, not the
    widest gap: a detection whose box distribution has two modes moves by
    tens of pixels under any rounding, so the widest gap of sound runs
    reaches a third of the control's;
  * ``det_score_gap_mean``: the mean score gap of those matched pairs (the
    widest score gap of sound runs swings up to a third of the control's);
  * ``det_unmatched_pct``: the share of detections, the program's and the
    reference's together, that have no such partner (an extra or a missing
    detection counts, whatever it overlaps);
  * ``det_overlap_pairs``: pairs of the program's detections in one frame
    that greedy suppression at the configuration's ``iou_threshold`` would
    not both keep (exact; boxes on the frame's edge left out); only where
    the architecture module's ``SUPPRESSED`` says greedy suppression is the
    detector's guarantee, and left out of the comparison elsewhere;
  * ``track_mismatch``: slots of the sampled streams' frames whose
    visibility, or (visible) track id or class, differs from the reference
    tracker's; ``track_box_gap_px``: the widest gap of the box of a track
    visible on both sides under the same id and class.
    The reference tracker follows the program step by step: it is fed the
    program's detections (themselves held to the reference above), so
    that one rounding flip in the detector cannot set off a different but
    sound chain of ids;
  * ``event_mismatch``: zone events of the sampled streams that the program
    and the reference (run on the reference tracker's tracks) do not both
    raise, compared by frame, zone, type, track id, class and dwell.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from perfbench.reference import pack as ref_pack
from perfbench.reference.bytetrack import ByteTrackRef
from perfbench.reference.yolo import pair_iou
from perfbench.reference.zones import ZonesRef
from perfbench.scenes import pool_index

MATCH_IOU = 0.5
OVERLAP_MARGIN = 0.01
ORDER = ("planes_bytes_off", "det_box_gap_mean_px", "det_score_gap_mean", "det_unmatched_pct",
         "det_overlap_pairs", "track_mismatch", "track_box_gap_px", "event_mismatch")


def order(arch) -> tuple[str, ...]:
    """The numbers compared for an architecture module: ``det_overlap_pairs``
    only where greedy suppression is its detector's guarantee."""
    return ORDER if arch.SUPPRESSED else tuple(k for k in ORDER if k != "det_overlap_pairs")


def reference_detections(pool: np.ndarray, streams: list[int], geo: ref_pack.Geometry,
                         cfg: dict, arch, weights: str, device: torch.device, batch: int = 16):
    """Reference planes and detections of every pool frame of ``streams``:
    (planes (y, u, v) each (F, ns, ...) uint8 numpy, dets dict of (F, ns,
    max_det, ...) numpy in camera pixels)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    det = cfg["pipeline"]["detection"]
    model = arch.load_reference(cfg, weights, device)
    f, ns = pool.shape[0], len(streams)
    planes = None
    outs: dict[str, list] = {k: [] for k in ("boxes", "scores", "classes", "valid")}
    flat = [(p, s) for p in range(f) for s in streams]
    ys, us, vs = [], [], []
    for i in range(0, len(flat), batch):
        part = flat[i:i + batch]
        frames = torch.from_numpy(np.stack([pool[p, s] for p, s in part])).to(device)
        y, u, v = ref_pack.pack_2x(frames)
        ys.append(y.cpu())
        us.append(u.cpu())
        vs.append(v.cpu())
        d = arch.detect(model, ref_pack.model_input(y, u, v, geo), det)
        d["boxes"] = ref_pack.to_source(d["boxes"], geo)
        for k in outs:
            outs[k].append(d[k].cpu())
    planes = tuple(torch.cat(x).numpy().reshape(f, ns, *x[0].shape[1:]) for x in (ys, us, vs))
    dets = {k: torch.cat(v).numpy().reshape(f, ns, *v[0].shape[1:]) for k, v in outs.items()}
    del model
    return planes, dets


def match_one_to_one(iou: torch.Tensor) -> torch.Tensor:
    """Greedy one-to-one matching of (N, P, R) IoU (-1 where a pair may not
    match): the pair of highest IoU in a frame is matched first, then the
    highest of the rows and columns left, while it is at least ``MATCH_IOU``.
    Returns (N, P) the reference row each program row took, -1 for none."""
    iou = iou.clone()
    n, p, r = iou.shape
    partner = torch.full((n, p), -1, dtype=torch.long, device=iou.device)
    for _ in range(min(p, r)):
        best, arg = iou.reshape(n, -1).max(dim=1)
        f = torch.nonzero(best >= MATCH_IOU).squeeze(1)
        if f.numel() == 0:
            break
        i, j = arg[f] // r, arg[f] % r
        partner[f, i] = j
        iou[f, i, :] = -1.0
        iou[f, :, j] = -1.0
    return partner


def compare_detections(prog: dict, ref: dict, device: torch.device
                       ) -> tuple[float, float, float]:
    """Program and reference detections, each (N, D[, 4]) numpy for the same
    N frames, valid rows first -> (mean box gap px, mean score gap,
    unmatched share %).  Each detection matches at most one of the other
    side's (same class, IoU >= ``MATCH_IOU``, ``match_one_to_one``); every
    detection of either side left without one counts as unmatched."""
    gap_sum = sgap_sum = 0.0
    matched = unmatched = total = moved = 0
    gaps, sgaps, ious = [], [], []
    n = prog["boxes"].shape[0]

    def put(x, sl, d, dtype=None):
        t = torch.from_numpy(np.ascontiguousarray(x[sl][:, :d])).to(device)
        return t if dtype is None else t.to(dtype)

    for i0 in range(0, n, 4096):
        sl = slice(i0, i0 + 4096)
        d = max(1, int(prog["valid"][sl].sum(1).max(initial=0)),
                int(ref["valid"][sl].sum(1).max(initial=0)))
        pb, rb = put(prog["boxes"], sl, d, torch.float64), put(ref["boxes"], sl, d, torch.float64)
        pv, rv = put(prog["valid"], sl, d), put(ref["valid"], sl, d)
        pc, rc = put(prog["classes"], sl, d, torch.long), put(ref["classes"], sl, d, torch.long)
        ps, rs = put(prog["scores"], sl, d, torch.float64), put(ref["scores"], sl, d, torch.float64)
        iou = pair_iou(pb, rb)
        ok = pv[:, :, None] & rv[:, None, :] & (pc[:, :, None] == rc[:, None, :])
        iou = torch.where(ok, iou, -1.0)
        bj = match_one_to_one(iou)
        hit = bj >= 0
        bj = bj.clamp(min=0)
        best = torch.gather(iou, 2, bj[..., None])[..., 0]
        first = iou.max(dim=2)
        moved += int((hit & (first.indices != bj)).sum())
        moved += int((pv & ~hit & (first.values >= MATCH_IOU)).sum())
        unmatched += int(pv.sum()) + int(rv.sum()) - 2 * int(hit.sum())
        total += int(pv.sum()) + int(rv.sum())
        if bool(hit.any()):
            mb = torch.gather(rb, 1, bj[..., None].expand(-1, -1, 4))
            ms = torch.gather(rs, 1, bj)
            gaps.append((pb - mb).abs().amax(-1)[hit].cpu())
            sgaps.append((ps - ms).abs()[hit].cpu())
            ious.append(best[hit].cpu())
            gap_sum += float(gaps[-1].sum())
            matched += int(hit.sum())
            sgap_sum += float(sgaps[-1].sum())
    print(f"perfbench: detections one-to-one: {matched} matched, {unmatched} of {total} "
          f"unmatched; {moved} program detections took another partner than their best "
          f"or none", file=sys.stderr)
    if gaps:
        qs = torch.tensor([0.5, 0.9, 0.99, 0.999, 1.0], dtype=torch.float64)
        for name, x in (("box gap px", gaps), ("score gap", sgaps), ("match IoU", ious)):
            x = torch.cat(x).double()
            q = torch.quantile(x[:1_000_000], qs) if x.numel() else qs * 0
            print(f"perfbench: detections {name} over {x.numel()} matched: quantiles 0.5/0.9/"
                  f"0.99/0.999/max " + " ".join(f"{v:.6g}" for v in q.tolist())
                  + f"; mean {float(x.mean()):.6g}", file=sys.stderr)
    return (gap_sum / matched if matched else 0.0, sgap_sum / matched if matched else 0.0,
            100.0 * unmatched / total if total else 0.0)


def overlap_pairs(prog: dict, iou_threshold: float, agnostic: bool, w: int, h: int,
                  device: torch.device) -> int:
    """Pairs of the program's detections in one frame (same class unless
    ``agnostic``) that overlap by more than ``iou_threshold`` +
    ``OVERLAP_MARGIN``: greedy suppression keeps none.  Only boxes clear of
    the frame's edges count, since clipping to the frame after suppression
    can raise an overlap; IoU is unchanged by the map to camera pixels."""
    n, pairs = prog["boxes"].shape[0], 0
    for i0 in range(0, n, 4096):
        sl = slice(i0, i0 + 4096)
        d = max(1, int(prog["valid"][sl].sum(1).max(initial=0)))
        b = torch.from_numpy(np.ascontiguousarray(prog["boxes"][sl][:, :d])).to(device).double()
        v = torch.from_numpy(np.ascontiguousarray(prog["valid"][sl][:, :d])).to(device)
        c = torch.from_numpy(np.ascontiguousarray(prog["classes"][sl][:, :d])).to(device)
        v = v & (b[..., 0] > 0) & (b[..., 1] > 0) & (b[..., 2] < w) & (b[..., 3] < h)
        ok = v[:, :, None] & v[:, None, :]
        if not agnostic:
            ok &= c[:, :, None] == c[:, None, :]
        ok &= torch.ones(d, d, dtype=torch.bool, device=device).triu(1)
        pairs += int((ok & (pair_iou(b, b) > iou_threshold + OVERLAP_MARGIN)).sum())
    return pairs


def reference_tracks(dets: dict, cfg: dict, slots: int, n_streams: int, t_chunk: int,
                     cam_fps: float, bf16_state: bool = False):
    """The reference tracker fed ``dets`` (C, T, ns, D[, 4]) and the
    reference zones on its tracks: yields, per (stream j, chunk c, frame t),
    the tracker's outputs and that frame's events."""
    trk, ev_cfg = cfg["pipeline"]["tracking"], cfg["pipeline"]["events"]
    n_chunks = dets["boxes"].shape[0]
    for j in range(n_streams):
        bt = ByteTrackRef(trk["bytetrack"], slots, bf16_state)
        zr = ZonesRef(ev_cfg["zones"], trk["trail_length"])
        for c in range(n_chunks):
            for t in range(t_chunk):
                i = c * t_chunk + t
                o = bt.step(dets["boxes"][c, t, j], dets["scores"][c, t, j],
                            dets["classes"][c, t, j], dets["valid"][c, t, j])
                evs = zr.frame(o["track_id"], o["class_id"], o["boxes"], o["visible"],
                               i + 1, i / cam_fps)
                yield j, c, t, o, evs


def run_check(rec: dict, pool: np.ndarray, cfg: dict, device: torch.device, arch,
              weights: str) -> dict[str, float]:
    """The numbers of ``order(arch)`` for one run's record, the reference
    detector of ``arch`` (the configuration's architecture module) reading
    ``weights``, the file the program read: ``streams`` (sampled
    stream indices), ``chunk`` T, ``fps`` of the cameras, ``planes`` {chunk:
    (y, u, v) (T, ns, ...)}, ``dets`` (C, T, ns, D[, 4]) arrays of the
    program, ``tracks`` (C, T, ns, N[, 4]) arrays of the program, ``events``
    list of (stream index in ``streams``, frame id, zone, type, track id,
    class, dwell)."""
    streams, t_chunk, cam_fps = rec["streams"], rec["chunk"], rec["camera_fps"]
    det, trk = cfg["pipeline"]["detection"], cfg["pipeline"]["tracking"]
    h, w = pool.shape[2:4]
    geo = ref_pack.geometry(h, w, det["input_size"])
    f = pool.shape[0]
    ref_planes, ref_dets = reference_detections(pool, streams, geo, cfg, arch, weights, device)
    out: dict[str, float] = {}

    # planes
    off = 0
    for c, planes in rec["planes"].items():
        for t in range(t_chunk):
            p = pool_index(c * t_chunk + t, f)
            for a, b in zip(planes, ref_planes):
                off += int(np.count_nonzero(a[t] != b[p]))
    out["planes_bytes_off"] = float(off)

    # detections over every frame of the window
    n_chunks = rec["dets"]["boxes"].shape[0]
    idx = np.array([pool_index(i, f) for i in range(n_chunks * t_chunk)])
    # both flattened to (frame, stream) order
    ref_w = {k: v[idx].reshape(-1, *v.shape[2:]) for k, v in ref_dets.items()}
    prog_w = {k: v.reshape(-1, *v.shape[3:]) for k, v in rec["dets"].items()}
    out["det_box_gap_mean_px"], out["det_score_gap_mean"], out["det_unmatched_pct"] = \
        compare_detections(prog_w, ref_w, device)
    if arch.SUPPRESSED:
        out["det_overlap_pairs"] = float(overlap_pairs(prog_w, det["iou_threshold"],
                                                       bool(det.get("agnostic_nms")), w, h,
                                                       device))

    # tracks and events, stream by stream
    mism = 0
    tgap = 0.0
    ref_events, prog_events = set(), set()
    tracks = rec["tracks"]
    for j, c, t, o, evs in reference_tracks(rec["dets"], cfg, tracks["boxes"].shape[3],
                                            len(streams), t_chunk, cam_fps):
        vis = tracks["visible"][c, t, j]
        mism += int(np.count_nonzero(vis != o["visible"]))
        both = vis & o["visible"]
        same = ((tracks["track_id"][c, t, j] == o["track_id"])
                & (tracks["class_id"][c, t, j] == o["class_id"]))
        mism += int(np.count_nonzero(both & ~same))
        both &= same
        if both.any():
            tgap = max(tgap, float(np.abs(tracks["boxes"][c, t, j][both].astype(np.float64)
                                          - o["boxes"][both]).max()))
        for e in evs:
            ref_events.add((j, *e[:6]))
    for e in rec["events"]:
        prog_events.add(tuple(e[:7]))
    out["track_mismatch"] = float(mism)
    out["track_box_gap_px"] = tgap
    out["event_mismatch"] = float(len(ref_events ^ prog_events))
    out["_events"] = float(len(prog_events))
    return out
