"""Kill-and-resume snapshots of the pipeline's state.

The port's copy of ``rtmodt_tpu/runtime/state_store.py``, in its format: one
``.npz`` written atomically (a temporary file, then ``os.replace``) that holds

  * ``tracker/<field>``: every tracker slot (boxes, Kalman state, ids, ages,
    ``next_id``, appearance galleries, OC-SORT's observation rings) and the
    trails (``MultiObjectTracker.state_arrays``), as host numpy arrays under
    the reference's field names and dtypes;
  * ``gmc/grids``, ``gmc/valid``: the camera-motion carry where GMC is on;
  * ``meta``: a JSON string with the version (1), the algorithm, the frame
    counters and each zone engine's ``state_dict`` (dwell timers, cooldowns,
    per-zone counts, the event log's byte offset at snapshot time).

``frames_done`` is the position in a FILE source: a resumed run drops that
many frames first, so stream-time dwell clocks continue exactly; live
sources continue from the current frame.  A snapshot written by either
package loads into the other: the reference's single-stream snapshot has no
GMC carry (the port then restarts GMC cold), and the reference ignores the
port's.

Over several ranks (``parallel/mesh.py``) the multi-stream snapshot is still
one file in this format: rank 0 gathers every rank's streams (in rank order,
which is stream order) and writes it; on resume every rank reads it and
keeps its own streams, so a snapshot written by N ranks resumes under any
rank count that divides the streams.
"""

from __future__ import annotations

import json
import os
from typing import Any

import numpy as np
import torch

from rtmodt_tpu_torch.parallel.mesh import barrier, gather_objects
from rtmodt_tpu_torch.utils.logging import logger

_VERSION = 1


def _write(path: str, meta: dict, payload: dict[str, np.ndarray]) -> None:
    """Write the npz beside ``path`` and rename it into place: a reader never
    sees a partial snapshot, and a kill mid-write leaves the previous one."""
    tmp = f"{path}.tmp.{os.getpid()}"
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(tmp, "wb") as f:
        np.savez(f, meta=np.asarray(json.dumps(meta)), **payload)
    os.replace(tmp, path)


def _read_meta(z, path: str) -> dict:
    meta = json.loads(str(z["meta"]))
    if meta.get("version") != _VERSION:
        raise ValueError(f"snapshot {path} has version {meta.get('version')}; "
                         f"this build reads version {_VERSION}")
    return meta


def _check_algorithm(meta: dict, algorithm: str, path: str) -> None:
    if meta["algorithm"] != algorithm:
        raise ValueError(f"snapshot {path} was taken with tracking.algorithm="
                         f"{meta['algorithm']!r}; the running pipeline uses {algorithm!r} - "
                         "refusing to misinterpret the state")


def _gmc_payload(carry) -> dict[str, np.ndarray]:
    grids, valid = carry
    return {"gmc/grids": grids.detach().cpu().numpy(), "gmc/valid": valid.detach().cpu().numpy()}


def _load_gmc(z, carry, path: str, streams: slice | None = None):
    """The snapshot's GMC carry (its ``streams`` of a multi-stream one) on
    the device of ``carry``, or None (with a warning) where the snapshot has
    none of that shape."""
    if "gmc/grids" in z.files:
        grids, valid = z["gmc/grids"], z["gmc/valid"]
        if streams is not None:
            grids, valid = grids[streams], valid[streams]
        if grids.shape == tuple(carry[0].shape) and valid.shape == tuple(carry[1].shape):
            dev = carry[0].device
            return (torch.from_numpy(grids.astype(np.float32)).to(dev),
                    torch.from_numpy(valid.astype(np.float32)).to(dev))
    logger.warning(f"snapshot {path} has no GMC carry; compensation restarts cold "
                   "(the first frame per stream is not compensated)")
    return None


def _warn_engine_mismatch(path: str, have_engine: bool, snap_engine: bool) -> None:
    """One side has zone state and the other has none: say so, don't drop
    dwell timers silently (an operator toggled events.enabled between runs)."""
    if have_engine == snap_engine:
        return
    logger.warning(f"snapshot {path} " + (
        "has no zone-engine state but zones are enabled in this run; dwell timers start cold"
        if have_engine else
        "carries zone-engine state but zones are disabled in this run; "
        "dwell/cooldown/analytics state is discarded"))


def save_snapshot(path: str, tracker, events=None, *, frames_done: int = 0,
                  last_ts: float = 0.0, gmc_carry=None) -> None:
    """Atomically write one single-stream snapshot; never corrupts a prior
    one.  Call only with no frame in flight: the tracker state must describe
    exactly ``frames_done`` frames."""
    meta: dict[str, Any] = {
        "version": _VERSION,
        "algorithm": tracker.algorithm,
        "frames_done": int(frames_done),
        "last_ts": float(last_ts),
        "events": events.state_dict() if events is not None else None,
    }
    payload = {f"tracker/{k}": v for k, v in tracker.state_arrays().items()}
    if gmc_carry is not None:
        payload.update(_gmc_payload(gmc_carry))
    _write(path, meta, payload)


def load_snapshot(path: str, tracker, events=None, gmc_carry=None) -> dict[str, Any]:
    """Restore the tracker (and the zone engine) from a single-stream
    snapshot; returns its meta (``frames_done``, ``last_ts``, ...) with the
    restored GMC carry under ``"gmc_carry"`` when ``gmc_carry`` (the running
    pipeline's) is given.  Refuses another version, a multi-stream snapshot,
    another algorithm or another slot layout before changing anything."""
    with np.load(path, allow_pickle=False) as z:
        meta = _read_meta(z, path)
        if meta.get("kind") is not None:
            raise ValueError(f"snapshot {path} is a {meta['kind']!r} snapshot; refusing to "
                             "restore it into a single-stream pipeline (its arrays carry a "
                             "leading stream axis)")
        _check_algorithm(meta, tracker.algorithm, path)
        tracker.load_state_arrays({k[len("tracker/"):]: z[k] for k in z.files
                                   if k.startswith("tracker/")})
        if gmc_carry is not None:
            meta["gmc_carry"] = _load_gmc(z, gmc_carry, path)
    if events is not None and meta.get("events") is not None:
        events.load_state_dict(meta["events"])
    _warn_engine_mismatch(path, events is not None, meta.get("events") is not None)
    logger.info(f"resumed pipeline state from {path} (frames_done={meta['frames_done']}, "
                f"algorithm={meta['algorithm']})")
    return meta


# -- several streams (MultiStreamPipeline.run) ------------------------------------

def _state_dict(state) -> dict[str, torch.Tensor]:
    """Field -> (S, ...) tensor of a multi-stream state: ByteTrack's one
    S-leading state, or the other trackers' list of per-stream states."""
    if isinstance(state, list):
        return {k: torch.stack([getattr(st, k) for st in state]) for k in state[0]._fields}
    return state._asdict()


def _carry_pair(carry):
    """(grids (S, G, G), valid (S,)) of a batched or per-stream GMC carry."""
    if isinstance(carry, list):
        return torch.stack([c[0] for c in carry]), torch.stack([c[1] for c in carry])
    return carry


def save_multistream_snapshot(path: str, msp, engines=None, *, per_stream_frames: list[int],
                              last_meta: list, dead: list, fps: list | None = None) -> None:
    """Snapshot S camera streams: the tracker state with its leading stream
    axis, the per-stream GMC carry where GMC is on, every stream's zone
    engine and the per-stream frame counters a resumed run fast-forwards
    file sources by (and, as ``fps``, each stream's frame rate, which a
    stream that has ended keeps stamping its blank frames with; the
    reference ignores that key).  Call only at a drained window (every
    submitted chunk consumed), so the tracker and the engines describe the
    same frames.  Over several ranks every rank calls it with its own
    streams' lists (a collective: the ranks meet first, so that each
    engine's ``log_offset`` counts every rank's lines); rank 0 writes."""
    mesh = msp.mesh
    barrier(mesh)
    payload = {f"tracker/{k}": v.detach().cpu().numpy()
               for k, v in _state_dict(msp.state).items()}
    if msp._gmc_on:
        payload.update(_gmc_payload(_carry_pair(msp._gmc_carry)))
    part = {"per_stream_frames": [int(n) for n in per_stream_frames],
            "last_meta": [[int(f), float(t)] for f, t in last_meta],
            "dead": [bool(d) for d in dead],
            "engines": [e.state_dict() for e in engines] if engines is not None else None,
            "fps": None if fps is None else [float(f) for f in fps],
            "payload": payload}
    parts = gather_objects(part, mesh)
    if parts is None:
        return
    meta: dict[str, Any] = {
        "version": _VERSION,
        "kind": "multistream",
        "algorithm": msp.cfg.tracking.algorithm,
        "num_streams": int(msp.num_streams),
        "per_stream_frames": [n for p in parts for n in p["per_stream_frames"]],
        "last_meta": [m for p in parts for m in p["last_meta"]],
        "dead": [d for p in parts for d in p["dead"]],
        "engines": (None if engines is None
                    else [e for p in parts for e in p["engines"]]),
        "gmc": bool(msp._gmc_on),
    }
    if fps is not None:
        meta["fps"] = [f for p in parts for f in p["fps"]]
    _write(path, meta, {k: np.concatenate([p["payload"][k] for p in parts])
                        for k in payload})


def load_multistream_snapshot(path: str, msp, engines=None) -> dict[str, Any]:
    """Restore a multi-stream snapshot into ``msp`` (and the per-stream
    ``engines``); returns the meta (``per_stream_frames`` drives each file
    source's fast-forward).  Refuses another version, a single-stream
    snapshot, another algorithm, another stream count or another slot layout
    before changing anything.  Over several ranks it restores this rank's
    streams, and the per-stream lists of the meta it returns are this
    rank's; ``total_frames`` sums every stream's frames."""
    with np.load(path, allow_pickle=False) as z:
        meta = _read_meta(z, path)
        if meta.get("kind") != "multistream":
            raise ValueError(f"snapshot {path} is a single-stream snapshot; refusing to "
                             "restore it into a multi-camera pipeline")
        _check_algorithm(meta, msp.cfg.tracking.algorithm, path)
        if meta["num_streams"] != msp.num_streams:
            raise ValueError(f"snapshot {path} holds {meta['num_streams']} streams; the "
                             f"running pipeline has {msp.num_streams}")
        if engines is not None and meta.get("engines") is not None \
                and len(meta["engines"]) != msp.num_streams:
            raise ValueError(f"snapshot {path} holds {len(meta['engines'])} zone engines "
                             f"for {msp.num_streams} streams")
        mine = msp.stream_slice
        cur = _state_dict(msp.state)
        fields = {}
        for k, t in cur.items():
            key = f"tracker/{k}"
            arr = z[key] if key in z.files else None
            want = (tuple(t.shape), t.cpu().numpy().dtype)
            if arr is not None:     # every field leads with the stream axis
                arr = arr[mine]
            if arr is None or (arr.shape, arr.dtype) != want:
                got = "missing" if arr is None else f"{arr.shape}/{arr.dtype}"
                raise ValueError(f"snapshot field {k!r} is {got}; the running pipeline "
                                 f"expects {want[0]}/{want[1]} (max_tracks / embed_dim "
                                 "config mismatch?)")
            fields[k] = torch.from_numpy(arr.copy()).to(msp.device)
        if isinstance(msp.state, list):
            cls = type(msp.state[0])
            msp.state = [cls(**{k: v[si] for k, v in fields.items()})
                         for si in range(msp.local_streams)]
        else:
            msp.state = type(msp.state)(**fields)
        if msp._gmc_on:
            carry = _load_gmc(z, _carry_pair(msp._gmc_carry), path, mine)
            if carry is None:
                msp._gmc_reset()
            elif isinstance(msp._gmc_carry, list):
                msp._gmc_carry = [(carry[0][si], carry[1][si])
                                  for si in range(msp.local_streams)]
            else:
                msp._gmc_carry = carry
    _warn_engine_mismatch(path, engines is not None, meta.get("engines") is not None)
    meta["total_frames"] = sum(int(n) for n in meta["per_stream_frames"])
    for key in ("per_stream_frames", "last_meta", "dead", "fps", "engines"):
        if meta.get(key) is not None:
            meta[key] = meta[key][mine]
    if engines is not None and meta.get("engines") is not None:
        for eng, st in zip(engines, meta["engines"]):
            eng.load_state_dict(st)
    logger.info(f"resumed multi-stream state from {path} "
                f"(per_stream_frames={meta['per_stream_frames']}, "
                f"algorithm={meta['algorithm']})")
    return meta
