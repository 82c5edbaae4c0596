"""Kill-and-resume snapshots of the port (``runtime/state_store.py``), at the
level of the tracker facade and the zone engine, against the JAX package.

  * The tracker's ``state_arrays`` have the reference's keys, shapes and
    dtypes for all four algorithms; a port tracker restored from its own
    arrays continues bit for bit, and the arrays cross between the packages
    in both directions: a tracker restored from the other package's arrays
    continues with the same ids (boxes within 1e-4 px).
  * The zone engine's ``state_dict`` equals the reference's after the same
    chunks, and a restored engine raises the same events as the original.
  * ``state_store`` refuses what the reference refuses (version, kind,
    algorithm, stream count, slot layout, engine count), warns where one
    side has zone state and the other none, and writes atomically.
"""

from __future__ import annotations

import json
import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtmodt_tpu.events.zone_engine import ZoneEventEngine as JaxEngine
from rtmodt_tpu.runtime.state_store import load_snapshot as jax_load_snapshot
from rtmodt_tpu.runtime.state_store import save_snapshot as jax_save_snapshot
from rtmodt_tpu.tracking.tracker import MultiObjectTracker as JaxTracker
from rtmodt_tpu_torch.events.zone_engine import ZoneEventEngine
from rtmodt_tpu_torch.runtime import state_store
from rtmodt_tpu_torch.tracking.tracker import MultiObjectTracker
from tests.test_torch_port_threads import torch_threads  # noqa: F401 (autouse)

ALGORITHMS = ("bytetrack", "ocsort", "deepsort", "botsort")
D, E = 8, 128
BOX_ATOL = 1e-4
ZONES = [{"name": "z", "polygon": [[0, 0], [200, 0], [200, 200], [0, 200]],
          "dwell_time_sec": 0.0, "cooldown_sec": 0.1},
         {"name": "gate", "polygon": [[90, 0], [400, 0], [400, 400], [90, 400]],
          "trigger": "crossing", "direction": "left_to_right", "cooldown_sec": 0.2}]


def _kwargs(algorithm: str) -> dict:
    if algorithm in ("deepsort", "botsort"):
        extra = {"n_init": 1} if algorithm == "deepsort" else {}
        return {algorithm: {"max_tracks": 16, "embed_dim": E, **extra}}
    return {algorithm: {"max_tracks": 16}}


def _trackers(algorithm: str):
    kw = _kwargs(algorithm)
    return (MultiObjectTracker(algorithm, trail_length=5, device="cpu", **kw),
            JaxTracker(algorithm, trail_length=5, **kw))


def _dets(t: int):
    """Frame t: four objects moving right (two low-score), appearance
    features fixed per object; (D,) padded, numpy."""
    boxes = np.zeros((D, 4), np.float32)
    base = np.array([[10, 10, 60, 60], [100, 20, 150, 90], [30, 120, 80, 180],
                     [200, 150, 260, 210]], np.float32)
    boxes[:4] = base + np.array([4 * t, 0, 4 * t, 0], np.float32)
    scores = np.zeros(D, np.float32)
    scores[:4] = [0.9, 0.85, 0.8, 0.7]
    feats = np.random.default_rng(7).normal(size=(D, E)).astype(np.float32)
    feats /= np.linalg.norm(feats, axis=1, keepdims=True)
    return boxes, scores, np.zeros(D, np.int32), np.arange(D) < 4, feats


def _step_port(tr, t: int):
    boxes, scores, classes, valid, feats = (torch.from_numpy(np.asarray(a)) for a in _dets(t))
    out = tr.step(boxes, scores, classes, valid,
                  feats if tr.algorithm in ("deepsort", "botsort") else None)
    tr.tracks_from_outputs(out, ["obj"])          # the trails
    return tuple(np.asarray(x) for x in out)


def _step_jax(tr, t: int):
    boxes, scores, classes, valid, feats = (jnp.asarray(a) for a in _dets(t))
    args = (feats,) if tr.algorithm in ("deepsort", "botsort") else ()
    tr.state, out = tr._step(tr.state, boxes, scores, classes, valid, *args)
    tr.tracks_from_outputs(out, ["obj"])
    return tuple(np.asarray(x) for x in out)


def _same_outputs(a, b, exact: bool) -> None:
    boxes_a, *rest_a = a
    boxes_b, *rest_b = b
    for x, y in zip(rest_a, rest_b):
        np.testing.assert_array_equal(x, y)
    if exact:
        np.testing.assert_array_equal(boxes_a, boxes_b)
    else:
        np.testing.assert_allclose(boxes_a, boxes_b, rtol=0, atol=BOX_ATOL)


@pytest.mark.parametrize("algorithm", ALGORITHMS)
def test_tracker_state_round_trips_and_crosses_packages(algorithm):
    port, ref = _trackers(algorithm)
    fresh_p, fresh_r = port.state_arrays(), ref.state_arrays()
    assert sorted(fresh_p) == sorted(fresh_r)
    for k in fresh_p:
        assert (fresh_p[k].shape, fresh_p[k].dtype) == (fresh_r[k].shape, fresh_r[k].dtype), k
    for t in range(4):
        _same_outputs(_step_port(port, t), _step_jax(ref, t), exact=False)
    arrays_p, arrays_r = port.state_arrays(), ref.state_arrays()
    assert int(arrays_p["next_id"]) > 1 and len(arrays_p["trail_ids"]) > 0
    np.testing.assert_array_equal(arrays_p["trail_data"], arrays_r["trail_data"])

    own, from_ref = _trackers(algorithm)[0], _trackers(algorithm)[0]
    own.load_state_arrays(arrays_p)
    from_ref.load_state_arrays(arrays_r)
    to_ref = _trackers(algorithm)[1]
    to_ref.load_state_arrays(arrays_p)
    assert own._trail_map == port._trail_map == from_ref._trail_map
    for t in range(4, 7):
        want_p, want_r = _step_port(port, t), _step_jax(ref, t)
        _same_outputs(_step_port(own, t), want_p, exact=True)
        _same_outputs(_step_port(from_ref, t), want_r, exact=False)
        _same_outputs(_step_jax(to_ref, t), want_p, exact=False)


def test_host_lapjv_state_is_not_saved():
    tr = MultiObjectTracker("bytetrack", device="cpu", bytetrack={"assignment": "lapjv"})
    with pytest.raises(NotImplementedError):
        tr.state_arrays()
    with pytest.raises(NotImplementedError):
        tr.load_state_arrays({})


def _chunk(c: int, k: int = 4, s: int = 6):
    """Chunk c of synthetic (K, S) tracker outputs: slot i holds track i + 1
    moving right, visible except in the odd frames of slot 2."""
    f = np.arange(c * k, (c + 1) * k)
    tid = np.tile(np.arange(1, s + 1, dtype=np.int32), (k, 1))
    boxes = np.zeros((k, s, 4), np.float32)
    x0 = 20.0 * f[:, None] + 30.0 * np.arange(s)[None] - 60.0
    boxes[..., 0], boxes[..., 2] = x0, x0 + 40.0
    boxes[..., 1], boxes[..., 3] = 40.0 + 10 * np.arange(s)[None], 80.0 + 10 * np.arange(s)[None]
    visible = np.ones((k, s), bool)
    visible[f % 2 == 1, 2] = False
    return (tid, np.zeros((k, s), np.int32), boxes, visible, [int(i) + 1 for i in f],
            np.asarray(f / 25.0, np.float64))


def _events(path) -> list:
    rows = [json.loads(line) for line in open(path)]
    return [(r["event_type"], r["zone_name"], r["track_id"], r["frame_id"],
             round(r["dwell_time_sec"], 6)) for r in rows]


def test_engine_state_dict_equals_the_reference_and_restores(tmp_path):
    port = ZoneEventEngine(ZONES, log_path=str(tmp_path / "port.jsonl"), trail_length=5)
    ref = JaxEngine(ZONES, log_path=str(tmp_path / "ref.jsonl"), trail_length=5)
    for c in range(3):
        port.process_chunk(*_chunk(c), class_names=["obj"])
        ref.process_chunk(*_chunk(c), class_names=["obj"])
    got, want = port.state_dict(), ref.state_dict()
    assert got["log_offset"] == (tmp_path / "port.jsonl").stat().st_size > 0
    got.pop("log_offset"), want.pop("log_offset")     # wall-clock stamps in the logs
    assert json.loads(json.dumps(got)) == json.loads(json.dumps(want))
    assert "hist" in got and got["occupancy"] and got["cooldown"]

    restored = ZoneEventEngine(ZONES, log_path=str(tmp_path / "restored.jsonl"), trail_length=5)
    restored.load_state_dict(json.loads(json.dumps(ref.state_dict())))
    assert restored.zone_counts() == port.zone_counts()
    n_before = len(_events(tmp_path / "port.jsonl"))
    for c in range(3, 6):
        port.process_chunk(*_chunk(c), class_names=["obj"])
        restored.process_chunk(*_chunk(c), class_names=["obj"])
    after = _events(tmp_path / "port.jsonl")[n_before:]
    assert after and _events(tmp_path / "restored.jsonl") == after
    assert restored.zone_counts() == port.zone_counts()


def _stepped(algorithm: str = "bytetrack", **kw) -> MultiObjectTracker:
    tr = MultiObjectTracker(algorithm, trail_length=5, device="cpu", **(kw or _kwargs(algorithm)))
    for t in range(3):
        _step_port(tr, t)
    return tr


def test_snapshot_crosses_packages_with_engine_and_offset(tmp_path):
    """A port snapshot loads into the JAX package and a JAX one into the port,
    tracker and engine; the meta keys are the reference's."""
    port_tr = _stepped()
    jax_tr = JaxTracker("bytetrack", trail_length=5, bytetrack={"max_tracks": 16})
    for t in range(3):
        _step_jax(jax_tr, t)
    eng = ZoneEventEngine(ZONES, log_path=str(tmp_path / "a.jsonl"), trail_length=5)
    eng.process_chunk(*_chunk(0), class_names=["obj"])
    state_store.save_snapshot(str(tmp_path / "port.npz"), port_tr, eng, frames_done=4,
                              last_ts=0.12)
    jeng = JaxEngine(ZONES, log_path=str(tmp_path / "b.jsonl"), trail_length=5)
    jax_save_snapshot(str(tmp_path / "jax.npz"), jax_tr, jeng, frames_done=4, last_ts=0.12)
    with np.load(tmp_path / "port.npz") as zp, np.load(tmp_path / "jax.npz") as zj:
        assert sorted(zp.files) == sorted(zj.files)
        assert sorted(json.loads(str(zp["meta"]))) == sorted(json.loads(str(zj["meta"])))

    into_jax = JaxTracker("bytetrack", trail_length=5, bytetrack={"max_tracks": 16})
    jeng2 = JaxEngine(ZONES, log_path=str(tmp_path / "c.jsonl"), trail_length=5)
    meta = jax_load_snapshot(str(tmp_path / "port.npz"), into_jax, jeng2)
    assert meta["frames_done"] == 4 and meta["events"]["log_offset"] == (
        tmp_path / "a.jsonl").stat().st_size
    assert jeng2.zone_counts() == eng.zone_counts()
    into_port = MultiObjectTracker("bytetrack", trail_length=5, device="cpu",
                                   bytetrack={"max_tracks": 16})
    meta = state_store.load_snapshot(str(tmp_path / "jax.npz"), into_port)
    assert meta["frames_done"] == 4
    _same_outputs(_step_port(into_port, 3), _step_jax(into_jax, 3), exact=False)


def _write_snapshot(path, meta: dict, arrays: dict) -> None:
    np.savez(path, meta=np.asarray(json.dumps(meta)),
             **{f"tracker/{k}": v for k, v in arrays.items()})


@pytest.mark.parametrize("case,match", [
    ("version", "version"),
    ("multistream_kind", "multistream"),
    ("algorithm", "algorithm"),
    ("max_tracks", "max_tracks"),
    ("dtype", "float64"),
])
def test_single_stream_load_refuses(tmp_path, case, match):
    tr = _stepped()
    arrays = tr.state_arrays()
    meta = {"version": 1, "algorithm": "bytetrack", "frames_done": 3, "last_ts": 0.0,
            "events": None}
    target = MultiObjectTracker("bytetrack", trail_length=5, device="cpu",
                                bytetrack={"max_tracks": 16})
    if case == "version":
        meta["version"] = 2
    elif case == "multistream_kind":
        meta.update(kind="multistream", num_streams=2)
        arrays = {k: np.stack([v, v]) for k, v in arrays.items()}
    elif case == "algorithm":
        target = MultiObjectTracker("ocsort", device="cpu", ocsort={"max_tracks": 16})
    elif case == "max_tracks":
        target = MultiObjectTracker("bytetrack", device="cpu", bytetrack={"max_tracks": 32})
    else:
        arrays["boxes"] = arrays["boxes"].astype(np.float64)
    before = {k: v.copy() for k, v in target.state_arrays().items()}
    _write_snapshot(tmp_path / "s.npz", meta, arrays)
    with pytest.raises(ValueError, match=match):
        state_store.load_snapshot(str(tmp_path / "s.npz"), target)
    for k, v in target.state_arrays().items():         # nothing was changed
        np.testing.assert_array_equal(v, before[k])


@pytest.mark.parametrize("case,match", [
    ("single_kind", "single-stream"),
    ("streams", "3 streams"),
    ("algorithm", "algorithm"),
    ("max_tracks", "max_tracks"),
    ("engines", "zone engines"),
])
def test_multistream_load_refuses(tmp_path, case, match):
    from rtmodt_tpu_torch.config import load_config
    from rtmodt_tpu_torch.parallel.multistream import MultiStreamPipeline

    cfg = load_config(overrides={
        "detection": {"model": "yolov8n", "input_size": 128, "half": False},
        "tracking": {"bytetrack": {"max_tracks": 16}},
        "events": {"zones": ZONES, "alert": {"log_path": str(tmp_path / "ev.jsonl")}}})
    msp = MultiStreamPipeline(cfg, num_streams=2, device="cpu")
    engines = [ZoneEventEngine(ZONES, log_path=str(tmp_path / "ev.jsonl")) for _ in range(2)]
    state_store.save_multistream_snapshot(str(tmp_path / "ms.npz"), msp, engines,
                                          per_stream_frames=[4, 4], last_meta=[(4, 0.1)] * 2,
                                          dead=[False, False])
    path = str(tmp_path / "ms.npz")
    with np.load(path) as z:
        meta = json.loads(str(z["meta"]))
        arrays = {k[len("tracker/"):]: z[k] for k in z.files if k.startswith("tracker/")}
    if case == "single_kind":
        meta.pop("kind")
    elif case == "streams":
        meta["num_streams"] = 3
    elif case == "algorithm":
        meta["algorithm"] = "ocsort"
    elif case == "max_tracks":
        arrays = {k: (np.concatenate([v, v], axis=1) if v.ndim > 1 else v)
                  for k, v in arrays.items()}
    else:
        meta["engines"] = meta["engines"] * 2
    _write_snapshot(path, meta, arrays)
    with pytest.raises(ValueError, match=match):
        state_store.load_multistream_snapshot(path, msp, engines)


def test_engine_presence_mismatch_warns(tmp_path, caplog):
    log = logging.getLogger("rtmodt_tpu_torch")
    log.addHandler(caplog.handler)
    try:
        tr = _stepped()
        eng = ZoneEventEngine(ZONES, log_path=str(tmp_path / "a.jsonl"))
        state_store.save_snapshot(str(tmp_path / "wz.npz"), tr, eng)
        state_store.save_snapshot(str(tmp_path / "nz.npz"), tr, None)
        with caplog.at_level(logging.WARNING, logger="rtmodt_tpu_torch"):
            caplog.clear()
            state_store.load_snapshot(str(tmp_path / "wz.npz"), tr, None)
            assert any("discarded" in r.message for r in caplog.records)
            caplog.clear()
            state_store.load_snapshot(str(tmp_path / "nz.npz"), tr, eng)
            assert any("cold" in r.message for r in caplog.records)
            caplog.clear()
            state_store.load_snapshot(str(tmp_path / "nz.npz"), tr, None)
            state_store.load_snapshot(str(tmp_path / "wz.npz"), tr, eng)
            assert not any("discarded" in r.message or "cold" in r.message
                           for r in caplog.records)
    finally:
        log.removeHandler(caplog.handler)


def test_atomic_write_keeps_the_previous_snapshot_on_a_failed_write(tmp_path, monkeypatch):
    tr = _stepped()
    snap = tmp_path / "s.npz"
    state_store.save_snapshot(str(snap), tr, frames_done=3)
    first = snap.read_bytes()
    state_store.save_snapshot(str(snap), tr, frames_done=3)      # replaced by rename
    assert snap.read_bytes() == first
    assert not list(tmp_path.glob("s.npz.tmp.*"))

    def broken(f, **arrays):                 # dies half way through the write
        f.write(b"PK\x03\x04 partial")
        raise OSError("disk full")

    _step_port(tr, 3)
    monkeypatch.setattr(np, "savez", broken)
    with pytest.raises(OSError):
        state_store.save_snapshot(str(snap), tr, frames_done=4)
    monkeypatch.undo()
    assert snap.read_bytes() == first        # the last good snapshot stands
    with np.load(snap) as z:
        assert json.loads(str(z["meta"]))["frames_done"] == 3
