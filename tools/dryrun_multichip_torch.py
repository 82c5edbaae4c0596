#!/usr/bin/env python
"""Dry run of the port's programs over a mesh of N ranks, on tiny shapes.

The port's counterpart of ``__graft_entry__.py``'s ``dryrun_multichip``:

  1. the data-parallel TRAINING step (``make_sharded_train_step``): the
     batch split over the ranks, one sample each, the parameters
     replicated, the gradients all-reduced; the loss must be finite and the
     parameters identical on every rank after the step;
  2. a multi-stream INFERENCE chunk: S = N camera streams, rank r running
     stream r (``MultiStreamPipeline`` with the mesh, planar I420 packed
     transport); the per-stream boxes must differ across streams;
  3. the appearance + GMC chunk: BoT-SORT with per-stream ROI crops, the
     embedder and per-stream phase-correlation carries; every stream's
     gallery must hold embeddings, the galleries must differ, and every
     stream's GMC carry must turn valid.

Each part prints the reference's "OK" line.  ``--devices`` lists the
mesh's devices (the counterpart of the reference's virtual device count):
``cpu,cpu,cpu,cpu`` runs four CPU ranks over gloo, ``cuda:0,cuda:0`` two
ranks sharing one card over gloo, ``cuda:0,cuda:1`` two cards over NCCL.
Without ``--devices`` (or ``RTMODT_MESH_DEVICES``) it takes every visible
card, and where there is none it exits with an error: the CPU runs only
where it is named.

    python tools/dryrun_multichip_torch.py 4 --devices cpu,cpu,cpu,cpu
    python tools/dryrun_multichip_torch.py --devices cuda:0,cuda:0
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SIZE, T_CHUNK, SRC_H, SRC_W = 64, 2, 96, 128


def _train_part(mesh, batch: tuple) -> dict:
    import torch

    from rtmodt_tpu_torch.models.yolov8 import build_model
    from rtmodt_tpu_torch.parallel.mesh import all_reduce_sum, replicate
    from rtmodt_tpu_torch.training.train_step import (Batch, create_train_state,
                                                      make_optimizer, make_schedule,
                                                      make_sharded_train_step)

    model = build_model("yolov8n", num_classes=8).to(mesh.device)
    tx = make_optimizer(make_schedule(1e-3, 0.01, 100, 10))
    state = create_train_state(model, tx, torch.Generator().manual_seed(0))
    replicate(model, mesh)
    step_fn, put_batch = make_sharded_train_step(model, tx, SIZE, mesh)
    state, metrics = step_fn(state, put_batch(Batch(*(torch.from_numpy(a) for a in batch))))
    # the parameters of every rank against rank 0's: the sum of |p - p0|
    with torch.no_grad():
        flat = torch.cat([p.detach().reshape(-1).double() for p in model.parameters()])
        ref = flat.clone()
        torch.distributed.broadcast(ref, 0)
        apart = float(all_reduce_sum((flat - ref).abs().sum()[None])[0])
    return {"loss": float(metrics["loss"]), "apart": apart}


def _stream_part(mesh, overrides: dict, planes: tuple, appearance: bool) -> dict:
    from rtmodt_tpu_torch.config import load_config
    from rtmodt_tpu_torch.parallel.multistream import MultiStreamPipeline

    msp = MultiStreamPipeline(load_config(overrides=overrides), mesh=mesh)
    outs, res = msp.submit_chunk_packed(planes, SRC_H, SRC_W)
    out = {"device": str(msp.device), "boxes": res.boxes.cpu().numpy(),
           "track_boxes": outs.boxes.cpu().numpy()}
    if appearance:
        out["feats"] = np.stack([st.feat.cpu().numpy() for st in msp.state])
        out["gmc_valid"] = np.stack([c[1].cpu().numpy() for c in msp._gmc_carry])
    return out


def _rank(mesh, batch: tuple, streams: tuple, appearance: tuple) -> dict:
    """The three parts in one rank (one process start for all three)."""
    return {"train": _train_part(mesh, batch), "streams": _stream_part(mesh, *streams, False),
            "appearance": _stream_part(mesh, *appearance, True)}


def _packed(frames: np.ndarray) -> tuple:
    from rtmodt_tpu_torch.ops.yuv import pack_chunk

    t, s = frames.shape[:2]
    planes, _ = pack_chunk(frames.reshape(t * s, SRC_H, SRC_W, 3), SIZE)
    return tuple(p.reshape(t, s, *p.shape[1:]) for p in planes)


def dryrun_multichip(mesh) -> None:
    from rtmodt_tpu_torch.parallel.mesh import spawn
    from rtmodt_tpu_torch.utils.synthetic import moving_boxes_frame

    n = s = mesh.world           # one sample and one stream per rank
    rng = np.random.default_rng(0)
    batch = (rng.random((n, SIZE, SIZE, 3), np.float32),
             np.asarray([[[8, 8, 40, 40], [20, 20, 60, 60]]] * n, np.float32),
             np.zeros((n, 2), np.int32), np.ones((n, 2), bool))
    device = "cpu" if mesh.device.type == "cpu" else "cuda"
    base = {"system": {"device": device},
            "profiling": {"per_stage": False}, "visualization": {"enabled": False},
            "events": {"enabled": False}, "parallel": {"num_streams": s}}
    cfg = {**base, "detection": {"model": "yolov8n", "input_size": SIZE,
                                 "conf_threshold": 0.001, "classes": []}}
    frames = np.stack([np.stack([moving_boxes_frame(t + 13 * si, SRC_H, SRC_W, n_objects=3)[0]
                                 for si in range(s)]) for t in range(T_CHUNK)])
    cfg_bs = {**base,
              "detection": {"model": "yolov8n", "input_size": SIZE, "conf_threshold": 0.001,
                            "nms_candidates": 16, "max_detections": 4, "classes": []},
              "tracking": {"algorithm": "botsort",
                           "deepsort": {"max_tracks": 8, "n_init": 1, "embedder": "random"},
                           "botsort": {"track_thresh": 0.001, "new_track_thresh": 0.001,
                                       "low_thresh": 0.0001},
                           "gmc": {"method": "phase", "grid": 32}}}
    bgs = rng.integers(0, 255, (s, SRC_H, SRC_W, 3), np.uint8)
    frames_bs = np.empty((T_CHUNK, s, SRC_H, SRC_W, 3), np.uint8)
    for t in range(T_CHUNK):
        for si in range(s):
            f = bgs[si].copy()
            x = 8 + 6 * t + 5 * si
            f[20:60, x:x + 28] = ((37 * si) % 255, (91 * si) % 255, 200)
            frames_bs[t, si] = f
    res = spawn(_rank, mesh, batch, (cfg, _packed(frames)), (cfg_bs, _packed(frames_bs)))

    # 1. the data-parallel train step
    train = [r["train"] for r in res]
    loss = train[0]["loss"]
    if not np.isfinite(loss):
        raise SystemExit(f"non-finite loss {loss}")
    if any(r["apart"] != 0.0 for r in train) or len({r["loss"] for r in train}) != 1:
        raise SystemExit(f"the ranks' parameters or losses differ after the step: {train}")
    print(f"dryrun_multichip({n}): train OK, loss={loss:.4f}", flush=True)

    # 2. S = N streams, one per rank
    streams = [r["streams"] for r in res]
    boxes = np.concatenate([r["boxes"] for r in streams], axis=1)    # (T, S, K, 4)
    if not np.isfinite(boxes).all() or boxes.shape[:2] != (T_CHUNK, s):
        raise SystemExit(f"detection boxes of shape {boxes.shape} or not finite")
    flat = boxes[-1].reshape(s, -1)
    if s > 1 and all(np.allclose(flat[0], flat[si]) for si in range(1, s)):
        raise SystemExit("per-stream outputs identical; the streams are not independent")
    print(f"dryrun_multichip({n}): multistream OK ({s} streams x {T_CHUNK} frames, "
          f"split over {n} ranks: {', '.join(r['device'] for r in streams)})", flush=True)

    # 3. BoT-SORT with the embedder and per-stream GMC
    app = [r["appearance"] for r in res]
    if not all(np.isfinite(r["track_boxes"]).all() for r in app):
        raise SystemExit("non-finite track boxes")
    feats = np.concatenate([r["feats"] for r in app])               # (S, slots, E)
    if (np.linalg.norm(feats, axis=-1).max(axis=1) <= 0).any():
        raise SystemExit("some stream's embedding gallery is empty; appearance path inactive")
    gal = feats.reshape(s, -1)
    if s > 1 and all(np.allclose(gal[0], gal[si]) for si in range(1, s)):
        raise SystemExit("per-stream embedding galleries identical")
    valid = np.concatenate([r["gmc_valid"] for r in app])
    if valid.min() != 1.0:
        raise SystemExit("a stream's GMC carry never turned valid")
    print(f"dryrun_multichip({n}): appearance+gmc OK (botsort gallery diverged across {s} "
          f"streams, GMC carries valid on {n} ranks)", flush=True)


def main(argv: list[str] | None = None) -> int:
    from rtmodt_tpu_torch.parallel.mesh import create_mesh

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("num_devices", nargs="?", type=int, default=None,
                    help="ranks (default: every device of --devices, or every visible card)")
    ap.add_argument("--devices", default=None,
                    help="comma-separated mesh devices, e.g. cpu,cpu,cpu,cpu or cuda:0,cuda:0")
    a = ap.parse_args(argv)
    devices = a.devices.split(",") if a.devices else None
    try:
        mesh = create_mesh(a.num_devices, devices=devices)
    except (ValueError, RuntimeError) as e:    # RuntimeError: no card, none named
        raise SystemExit(f"dryrun_multichip_torch: {e}")
    dryrun_multichip(mesh)
    return 0


if __name__ == "__main__":
    sys.exit(main())
