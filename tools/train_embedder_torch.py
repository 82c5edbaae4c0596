#!/usr/bin/env python
"""Train the DeepSORT / BoT-SORT appearance embedder with the PyTorch/CUDA
port, on synthetic re-identification.

The port's counterpart of ``tools/train_embedder.py``, with its flags:
supervised contrastive (NT-Xent) training over persistent synthetic
identities (``utils/synthetic.py::reid_patch`` under pose, lighting,
background, noise and occlusion), with hard-negative batches (same shape,
near color), optional resolution degradation (``--degrade-p``) and dense
scene crops (``--dense-frac``); ``adamw(cosine_decay(lr, steps, 0.05),
weight_decay=1e-4)``.  It reports the rank-1 retrieval accuracy and the
positive / hardest-negative cosine margin on held-out identities before and
after training, and writes the ``.npz`` layout ``models/embedder.py::
init_embedder`` loads (``tracking.deepsort.embedder``).  The card by
default; ``--cpu`` runs on the CPU.

    python tools/train_embedder_torch.py --steps 1500 --out build/embedder.npz
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def degrade_crop(patch: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """A ~25 px tracker crop upsampled to the embedder's input: downsample to
    a random small height (INTER_AREA), then back up (INTER_LINEAR)."""
    import cv2

    h, w = patch.shape[:2]
    th = int(rng.integers(14, 33))
    tw = max(2, round(th * w / h))
    small = cv2.resize(patch, (tw, th), interpolation=cv2.INTER_AREA)
    return cv2.resize(small, (w, h), interpolation=cv2.INTER_LINEAR)


def batch_views(ids: np.ndarray, views: np.ndarray, hw, seed: int,
                degrade_p: float = 0.0) -> np.ndarray:
    from rtmodt_tpu_torch.utils.synthetic import reid_patch

    out = []
    for i, v in zip(ids, views):
        patch = reid_patch(int(i), int(v), hw, seed)
        if degrade_p > 0.0:
            # deterministic in (identity, view, seed), like the render
            dg = np.random.default_rng((seed << 20) ^ (int(i) * 3 + 1) ^ (int(v) ^ 0xDEC0DE))
            if dg.random() < degrade_p:
                patch = degrade_crop(patch, dg)
        out.append(patch)
    return np.stack(out)


def identity_attrs(n: int, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """(shape, color) of each identity, from ``reid_patch``'s derivation
    without rendering: the handle for hard-negative batches."""
    shapes = np.empty(n, np.int64)
    colors = np.empty((n, 3), np.int64)
    for i in range(n):
        id_rng = np.random.default_rng((seed << 24) ^ (i * 2 + 1))
        colors[i] = id_rng.integers(70, 255, 3)
        id_rng.integers(40, 220, 3)          # color2 (consumed, unused here)
        shapes[i] = int(id_rng.integers(0, 5))
    return shapes, colors


def hard_batch(rng, shapes, colors, p_ids: int, group: int = 4) -> np.ndarray:
    """P identities as P/group groups sharing a shape, each an anchor and its
    nearest-color same-shape neighbors, padded with uniform draws."""
    chosen: list[int] = []
    for _ in range(p_ids // group):
        anchor = int(rng.integers(0, len(shapes)))
        same = np.flatnonzero(shapes == shapes[anchor])
        d = np.abs(colors[same] - colors[anchor]).sum(1)
        take = same[np.argsort(d)[:group * 3]]
        take = rng.permutation(take)[:group]
        chosen.extend(int(x) for x in take)
    seen, out = set(), []
    for c in chosen:
        if c not in seen:
            seen.add(c)
            out.append(c)
    while len(out) < p_ids:
        c = int(rng.integers(0, len(shapes)))
        if c not in seen:
            seen.add(c)
            out.append(c)
    return np.asarray(out[:p_ids])


def _dense_scene_crops(t: int, hw, n_objects: int, seed: int):
    """(crops resized to ``hw``, their persistent object ids) of one dense
    scene frame, crops under 4 px left out."""
    import cv2

    from rtmodt_tpu_torch.utils.synthetic import dense_moving_scene

    frame, boxes, _labels, ids = dense_moving_scene(t, 720, 1280, n_objects=n_objects,
                                                    seed=seed)
    out, kept = [], []
    for b, oid in zip(boxes.astype(int), ids):
        x1, y1, x2, y2 = b
        if x2 - x1 < 4 or y2 - y1 < 4:
            continue
        out.append(cv2.resize(frame[y1:y2, x1:x2], (hw[1], hw[0])))
        kept.append(int(oid))
    return out, kept


def build_dense_pool(hw, seeds, n_objects: int = 64, frames=tuple(range(0, 96, 8))):
    """{global id: [crop, ...]} of dense-scene object crops, one global id per
    (seed, object), its views the object's crops at several frames."""
    pool: dict[int, list] = {}
    for si, seed in enumerate(seeds):
        for t in frames:
            crops, ids = _dense_scene_crops(t, hw, n_objects, seed)
            for crop, oid in zip(crops, ids):
                pool.setdefault(si * 4096 + oid, []).append(crop)
    return {k: v for k, v in pool.items() if len(v) >= 2}


def dense_batch(rng, scenes, pool, p_ids: int, k_views: int):
    """A contrastive batch from one scene of the dense-crop pool, so the
    in-batch negatives are the objects' scene neighbors."""
    scene_ids = scenes[rng.integers(len(scenes))]
    picked = rng.choice(scene_ids, p_ids, replace=False)
    patches, labels = [], []
    for pid in picked:
        views = pool[pid]
        idx = rng.choice(len(views), k_views, replace=len(views) < k_views)
        for j in idx:
            patches.append(views[j])
            labels.append(pid)
    return np.stack(patches), np.asarray(labels)


def ntxent(z, labels, temp: float):
    """Supervised NT-Xent over unit embeddings ``z`` (B, E): every pair of the
    same identity is a positive."""
    import torch

    sim = z @ z.T / temp
    b = z.shape[0]
    eye = torch.eye(b, dtype=torch.bool, device=z.device)
    pos = (labels[:, None] == labels[None, :]) & ~eye
    logits = torch.where(eye, -1e9, sim)
    log_prob = logits - torch.logsumexp(logits, dim=1, keepdim=True)
    return -torch.sum(torch.where(pos, log_prob, 0.0)) / torch.clamp(pos.sum(), min=1)


def embed(model, patches: np.ndarray, device):
    import torch

    with torch.no_grad():
        return model(torch.from_numpy(patches).to(device)).cpu().numpy()


def held_out(model, eval_ids, gal_v, qry_v, hw, seed, device, degrade_p=0.0) -> dict:
    """Rank-1 retrieval of query views against gallery views of identities
    training never saw, and the mean positive / hardest-negative cosines."""
    gal = embed(model, batch_views(eval_ids, gal_v, hw, seed), device)
    qry = embed(model, batch_views(eval_ids, qry_v, hw, seed, degrade_p=degrade_p), device)
    sim = qry @ gal.T
    pos = np.diag(sim)
    neg = np.where(np.eye(len(sim), dtype=bool), -1, sim).max(1)
    return {"rank1": float(np.mean(sim.argmax(1) == np.arange(len(eval_ids)))),
            "pos": float(pos.mean()), "neg": float(neg.mean()),
            "margin": float((pos - neg).mean())}


def dense_crops_rank1(model, hw, n_objects: int, seed: int, device, t0: int = 3,
                      t1: int = 11) -> tuple[float, int]:
    """Transfer: rank-1 of dense-scene object crops at frame t1 against the
    same objects' crops at t0."""
    gal, gal_ids = _dense_scene_crops(t0, hw, n_objects, seed)
    qry, qry_ids = _dense_scene_crops(t1, hw, n_objects, seed)
    sim = embed(model, np.stack(qry), device) @ embed(model, np.stack(gal), device).T
    hit = sum(1 for qi, row in zip(qry_ids, sim) if gal_ids[int(np.argmax(row))] == qi)
    return hit / max(1, len(qry_ids)), len(qry_ids)


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=4000)
    ap.add_argument("--identities", type=int, default=2048)
    ap.add_argument("--batch-ids", type=int, default=32)   # P identities
    ap.add_argument("--views", type=int, default=4)        # K views each
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--temp", type=float, default=0.07)
    ap.add_argument("--crop", type=int, nargs=2, default=(64, 32))
    ap.add_argument("--embed-dim", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--hard-frac", type=float, default=0.7,
                    help="fraction of steps using same-shape near-color hard-negative batches")
    ap.add_argument("--degrade-p", type=float, default=0.0,
                    help="per-view probability of resolution degradation")
    ap.add_argument("--dense-frac", type=float, default=0.0,
                    help="fraction of steps training on dense-scene object crops")
    ap.add_argument("--dense-seeds", type=int, default=16,
                    help="number of dense training scenes to pre-render")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    ap.add_argument("--out", default="checkpoints/embedder.npz")
    return ap.parse_args(argv)


def run(args: argparse.Namespace) -> dict:
    """Train, evaluate and write the weights; returns the metrics."""
    import torch

    from rtmodt_tpu_torch.device import resolve_device
    from rtmodt_tpu_torch.models.embedder import AppearanceEmbedder, _seeded_init
    from rtmodt_tpu_torch.models.weights import embedder_to_jax
    from rtmodt_tpu_torch.training.train_step import AdamW, cosine_decay_schedule

    device = resolve_device("cpu" if args.cpu else "cuda")
    hw = tuple(args.crop)
    model = AppearanceEmbedder(embed_dim=args.embed_dim)
    _seeded_init(model, args.seed)
    model.to(device)
    tx = AdamW(cosine_decay_schedule(args.lr, args.steps, 0.05), weight_decay=1e-4,
               clip_norm=None, b1=0.9, b2=0.999, mask=None)
    params = dict(model.named_parameters())
    opt_state = tx.init(params)
    p_ids, k_views = args.batch_ids, args.views

    rng = np.random.default_rng(args.seed)
    eval_ids = np.arange(args.identities, args.identities + 128)
    eval_rng = np.random.default_rng(args.seed + 1)
    gal_v = eval_rng.integers(1 << 30, 1 << 31, eval_ids.shape[0])
    qry_v = eval_rng.integers(1 << 30, 1 << 31, eval_ids.shape[0])
    model.eval()
    before = held_out(model, eval_ids, gal_v, qry_v, hw, args.seed, device)
    print(f"held-out rank-1 before training: {before['rank1']:.4f}  margin "
          f"{before['margin']:.3f}", flush=True)

    train_ids = np.arange(args.identities)
    shapes, colors = identity_attrs(args.identities, args.seed)
    pool, scenes = None, None
    if args.dense_frac > 0.0:
        t_pool = time.time()
        pool = build_dense_pool(hw, seeds=range(1000, 1000 + args.dense_seeds))
        by_scene: dict[int, list] = {}
        for k in pool:
            by_scene.setdefault(k // 4096, []).append(k)
        scenes = [np.asarray(v) for v in by_scene.values() if len(v) >= p_ids]
        if not scenes:
            raise SystemExit("dense pool has no scene with enough ids")
        print(f"dense pool: {len(pool)} identities over {len(scenes)} scenes "
              f"({time.time() - t_pool:.0f}s)", flush=True)
    t0 = time.time()
    losses = []
    for it in range(args.steps):
        if pool is not None and rng.random() < args.dense_frac:
            patches, ids = dense_batch(rng, scenes, pool, p_ids, k_views)
        else:
            if rng.random() < args.hard_frac:
                picked = hard_batch(rng, shapes, colors, p_ids)
            else:
                picked = rng.choice(train_ids, p_ids, replace=False)
            ids = np.repeat(picked, k_views)
            views = rng.integers(0, 1 << 30, ids.shape[0])
            patches = batch_views(ids, views, hw, args.seed, degrade_p=args.degrade_p)
        z = model(torch.from_numpy(patches).to(device))
        loss = ntxent(z, torch.from_numpy(np.asarray(ids)).to(device), args.temp)
        grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
        tx.update(grads, opt_state, params)
        losses.append(loss.detach())
        if it % 100 == 0 or it == args.steps - 1:
            print(f"step {it}: loss {float(loss.detach()):.4f} ({(time.time() - t0):.0f}s)",
                  flush=True)
    seconds = time.time() - t0

    after = held_out(model, eval_ids, gal_v, qry_v, hw, args.seed, device)
    print(f"held-out rank-1: {after['rank1']:.4f}  pos cos {after['pos']:.3f}  "
          f"hardest-neg cos {after['neg']:.3f}  margin {after['margin']:.3f}", flush=True)
    degraded = held_out(model, eval_ids, gal_v, qry_v, hw, args.seed, device, degrade_p=1.0)
    print(f"held-out rank-1 (degraded queries): {degraded['rank1']:.4f}", flush=True)
    transfer = {}
    for n_obj in (32, 64):
        r1, n_q = dense_crops_rank1(model, hw, n_obj, seed=777, device=device)
        transfer[n_obj] = r1
        print(f"dense-mot transfer rank-1 @ {n_obj} objects: {r1:.4f} ({n_q} queries)",
              flush=True)

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    flat = embedder_to_jax(model)
    np.savez(args.out, **flat)
    print(f"saved {args.out} ({len(flat)} tensors); wire it with "
          f"tracking.deepsort.embedder: {args.out}", flush=True)
    return {"before": before, "after": after, "degraded": degraded, "transfer": transfer,
            "seconds": seconds, "losses": [float(x) for x in losses]}


def main(argv: list[str] | None = None) -> int:
    """Prints the metrics as one JSON line last."""
    import json

    r = run(parse_args(argv))
    print(json.dumps({k: v for k, v in r.items() if k != "losses"}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
