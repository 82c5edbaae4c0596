"""The chunk's ByteTrack steps as one CUDA graph (``tracking/chunk_graph.py``,
``Pipeline.track_chunk``).

On the card, over sequences of chunks of synthetic detections (objects that
move, leave and come back, confidences across both association stages),
the graph's outputs and state equal the eager loop's (the same pipeline
with ``_eager_reason`` forced) bit for bit through: a ``reset()`` mid-run,
``load_state_arrays`` from a snapshot, a ``MultiStreamPipeline`` resumed from
its snapshot, a change of S and of T (a new capture; back to a shape seen,
no capture), and callers that hold every chunk's outputs while later chunks
replay.  One capture per key, one replay per chunk, no eager chunk.

On the CPU, ``track_chunk`` runs the steps one by one and counts each chunk
under its reason; the span test's ``sync`` expectations
(``tests/test_torch_port_spans.py``) hold there as before.

This file imports neither JAX nor the JAX package: on the card, ``python -m
pytest --noconftest -m cuda tests/test_torch_port_track_graph.py``.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from rtmodt_tpu_torch.config import load_config
from rtmodt_tpu_torch.ops.nms import NMSResult
from rtmodt_tpu_torch.parallel.multistream import MultiStreamPipeline, init_multistream_state
from rtmodt_tpu_torch.runtime.pipeline import Pipeline
from rtmodt_tpu_torch.runtime.state_store import (load_multistream_snapshot,
                                                  save_multistream_snapshot)
from rtmodt_tpu_torch.tracking.bytetrack import TrackState
from rtmodt_tpu_torch.tracking.chunk_graph import clone_state

D, N_OBJ = 16, 7


def det_chunk(f0: int, t: int, s: int | None, device, seed: int = 0) -> NMSResult:
    """T frames from frame ``f0`` of S streams (no stream axis for None):
    N_OBJ objects each, moving, absent a quarter of the time, shuffled into D
    detection slots with confidences that reach both association stages."""
    ns = 1 if s is None else s
    rng = np.random.default_rng([seed, f0, ns])
    boxes = np.zeros((t, ns, D, 4), np.float32)
    scores = np.zeros((t, ns, D), np.float32)
    classes = np.full((t, ns, D), -1, np.int32)
    valid = np.zeros((t, ns, D), bool)
    for ti in range(t):
        f = f0 + ti
        for si in range(ns):
            slots = rng.permutation(D)
            n = 0
            for k in range(N_OBJ):
                if (f + 7 * k + 3 * si) % 40 >= 30:
                    continue
                x = (50 + 60 * k + 4 * f * (1 + 0.1 * k)) % 560
                y = 40 + 30 * si + 20 * k + 2 * f
                w, h = 40 + 3 * k + rng.uniform(-2, 2), 60 + rng.uniform(-2, 2)
                j = slots[n]
                n += 1
                boxes[ti, si, j] = (x, y, x + w, y + h)
                scores[ti, si, j] = rng.uniform(0.05, 1.0)
                classes[ti, si, j] = k % 3
                valid[ti, si, j] = True
    out = [boxes, scores, classes, valid, valid.sum(-1).astype(np.int32)]
    if s is None:
        out = [x[:, 0] for x in out]
    return NMSResult(*(torch.from_numpy(x).to(device) for x in out))


def cfg(device: str):
    return load_config(overrides={
        "system": {"device": device},
        "detection": {"model": "yolov8n", "input_size": 128, "half": False,
                      "max_detections": D},
        "events": {"enabled": False}, "visualization": {"enabled": False},
        "profiling": {"per_stage": False, "log_interval": 0},
        "parallel": {"chunk_size": 4}})


def forced_eager(pipe: Pipeline) -> Pipeline:
    pipe._eager_reason = lambda res, feats, grids: "forced"
    return pipe


def assert_same(a, b) -> None:
    """Two TrackOutputs or two TrackStates, bit for bit."""
    for name, x, y in zip(a._fields, a, b):
        assert torch.equal(x, y), name


# -- the CPU half ----------------------------------------------------------------
def test_cpu_chunks_run_step_by_step_counted_as_device():
    pipe = Pipeline(cfg("cpu"), device="cpu")
    hand = Pipeline(cfg("cpu"), device="cpu")
    for c in range(2):
        res = det_chunk(4 * c, 4, None, "cpu")
        got = pipe.track_chunk(res)
        want = [hand.tracker.step(res.boxes[i], res.scores[i], res.classes[i], res.valid[i])
                for i in range(4)]
        for f, (name, x) in enumerate(zip(got._fields, got)):
            assert torch.equal(x, torch.stack([w[f] for w in want])), name
    assert_same(pipe.tracker.state, hand.tracker.state)
    t = pipe.tracker
    assert t.eager_chunks == {"device": 2}
    assert t.graph_captures == t.graph_replays == 0
    assert int(t.state.next_id) > 1


@pytest.mark.parametrize("algorithm,feats,grids,reason", [
    ("bytetrack", False, False, "device"),
    ("bytetrack", False, True, "gmc"),
    ("bytetrack", True, False, "embeddings"),
    ("ocsort", False, False, "tracker"),
    ("ocsort", False, True, "tracker"),
])
def test_eager_reason_is_the_first_that_holds(algorithm, feats, grids, reason):
    pipe = Pipeline(load_config(overrides={
        "system": {"device": "cpu"}, "tracking": {"algorithm": algorithm},
        "detection": {"model": "yolov8n", "input_size": 128, "half": False},
        "events": {"enabled": False}, "visualization": {"enabled": False}}), device="cpu")
    res = det_chunk(0, 2, None, "cpu")
    got = pipe._eager_reason(res, torch.zeros(2, D, 8) if feats else None,
                             torch.zeros(2, 16, 16) if grids else None)
    assert got == reason


def test_clone_state_copies_every_tensor():
    st = init_multistream_state(2, 8)
    copy = clone_state(st)
    assert type(copy) is TrackState
    assert_same(copy, st)
    assert all(a.data_ptr() != b.data_ptr() for a, b in zip(copy, st))
    listed = clone_state([st, st])
    assert len(listed) == 2 and listed[0].active.data_ptr() != st.active.data_ptr()
    assert clone_state(None) is None


# -- on the card -----------------------------------------------------------------
@pytest.fixture(scope="module")
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (CUDA graphs and the assignment kernel)")
    return "cuda"


@pytest.mark.cuda
def test_graph_equals_eager_through_reset_snapshot_and_shape_changes(cuda_device):
    g = Pipeline(cfg(cuda_device), device=cuda_device)
    e = forced_eager(Pipeline(cfg(cuda_device), device=cuda_device))
    held: list = []          # every chunk's outputs, held while later chunks replay

    def both(res) -> None:
        got, want = g.track_chunk(res), e.track_chunk(res)
        assert_same(got, want)
        assert_same(g.tracker.state, e.tracker.state)
        held.append((got, want))

    # one stream (no stream axis), T = 4
    for c in range(3):
        both(det_chunk(4 * c, 4, None, cuda_device))
    snap = g.tracker.state_arrays()
    first = [det_chunk(12 + 4 * c, 4, None, cuda_device) for c in range(2)]
    for res in first:
        both(res)
    after = held[-2:]
    # load_state_arrays from the snapshot: the same two chunks again
    g.tracker.load_state_arrays(snap)
    e.tracker.load_state_arrays(snap)
    for res, (was, _) in zip(first, after):
        both(res)
        assert_same(held[-1][0], was)
    # reset mid-run: the first chunk again gives what it gave first
    g.reset()
    e.reset()
    both(det_chunk(0, 4, None, cuda_device))
    assert_same(held[-1][0], held[0][0])
    # T = 2 (a new capture), then back to T = 4 (none)
    both(det_chunk(4, 2, None, cuda_device))
    both(det_chunk(6, 4, None, cuda_device))
    # S = 3, then S = 5, each from a fresh stream-leading state
    for s in (3, 5):
        g.tracker.state = init_multistream_state(s, g.tracker.cfg.max_tracks, cuda_device)
        e.tracker.state = init_multistream_state(s, e.tracker.cfg.max_tracks, cuda_device)
        for c in range(3):
            both(det_chunk(4 * c, 4, s, cuda_device, seed=s))
    torch.cuda.synchronize()
    for got, want in held:                 # nothing held was overwritten
        assert_same(got, want)
    assert int(g.tracker.state.next_id.min()) > 1
    t = g.tracker
    assert t.graph_captures == 4           # (T 4, one stream), (T 2), (S 3), (S 5)
    assert t.graph_replays == len(held) and t.eager_chunks == {}
    assert e.tracker.graph_replays == 0 and e.tracker.eager_chunks == {"forced": len(held)}


@pytest.mark.cuda
def test_multistream_resume_replays_as_the_uninterrupted_run(cuda_device, tmp_path):
    s, t = 3, 4
    run = MultiStreamPipeline(cfg(cuda_device), num_streams=s, device=cuda_device)
    eager = MultiStreamPipeline(cfg(cuda_device), num_streams=s, device=cuda_device)
    forced_eager(eager._pipe)
    chunks = [det_chunk(t * c, t, s, cuda_device, seed=1) for c in range(5)]
    path = str(tmp_path / "snap.npz")
    outs, want = [], []
    for c, res in enumerate(chunks):
        outs.append(run._track(res, None, None, (1.0, 1.0)))
        want.append(eager._track(res, None, None, (1.0, 1.0)))
        assert_same(run.state, eager.state)
        if c == 2:
            save_multistream_snapshot(path, run, per_stream_frames=[t * 3] * s,
                                      last_meta=[(t * 3, 0.0)] * s, dead=[False] * s)
    resumed = MultiStreamPipeline(cfg(cuda_device), num_streams=s, device=cuda_device)
    load_multistream_snapshot(path, resumed)
    for c in (3, 4):
        assert_same(resumed._track(chunks[c], None, None, (1.0, 1.0)), want[c])
    assert_same(resumed.state, eager.state)
    for got, w in zip(outs, want):
        assert_same(got, w)
    # a warm-up through the same graph (its chunk's shapes are these) keeps
    # the state it found
    before = clone_state(run.state)
    run.warmup((96, 160), chunk_size=t)
    assert_same(run.state, before)
    assert_same(run._track(chunks[4], None, None, (1.0, 1.0)),
                eager._track(chunks[4], None, None, (1.0, 1.0)))
    assert run.tracker.graph_captures == 1 and run.tracker.graph_replays == 7
    assert resumed.tracker.graph_captures == 1 and resumed.tracker.graph_replays == 2
