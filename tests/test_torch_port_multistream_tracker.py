"""The batched tracker of the multi-stream pipeline on the CPU.

* ``greedy_assign`` over (S, R, C) equals S calls over (R, C): NaN entries,
  invalid rows and columns, a stream with no pair above the threshold beside
  one whose greedy chain needs a round per pair.
* ``bytetrack_update`` on an S-leading state (S = 3, 10 frames) equals three
  single-stream updates bit for bit, and the JAX ``jax.vmap(bytetrack_update)``
  on the same inputs: ``track_id`` / ``visible`` identical, boxes within 1e-5
  (tests/test_torch_port_tracker.py's tolerance).
* GMC with a stream axis (``phase_shift``, ``gmc_step``, ``compensate``)
  equals GMC stream by stream.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtmodt_tpu.config.loader import ByteTrackConfig as JaxByteTrackConfig
from rtmodt_tpu.tracking.bytetrack import bytetrack_update as jax_update
from rtmodt_tpu.tracking.bytetrack import init_track_state as jax_init
from rtmodt_tpu_torch.config.loader import ByteTrackConfig, GMCConfig
from rtmodt_tpu_torch.ops.assignment import greedy_assign
from rtmodt_tpu_torch.ops.gmc import compensate, gmc_step, init_carry, phase_shift
from rtmodt_tpu_torch.parallel.multistream import init_multistream_state
from rtmodt_tpu_torch.tracking.bytetrack import bytetrack_update, init_track_state
from tests.test_torch_port_threads import torch_threads  # noqa: F401 (autouse)

S, D, FRAMES = 3, 16, 10


def _chain(n: int) -> np.ndarray:
    """Greedy needs one mutual-best round per pair: (r0, c0) > (r1, c0) >
    (r1, c1) > (r2, c1) > ..."""
    sim = np.full((n, n), 0.05, np.float32)
    v = 0.99
    for i in range(n):
        sim[i, i] = v
        v -= 0.02
        if i + 1 < n:
            sim[i + 1, i] = v
            v -= 0.02
    return sim


@pytest.mark.parametrize("thr", [0.3, 0.5])
def test_batched_greedy_assign_equals_per_stream(thr):
    rng = np.random.default_rng(7)
    r, c = 9, 9
    sims = rng.uniform(0, 1, (4, r, c)).astype(np.float32)
    sims[0][rng.uniform(size=(r, c)) < 0.1] = np.nan
    sims[1] = rng.uniform(0, 0.2, (r, c))           # nothing reaches the threshold
    sims[2] = _chain(r)                             # r rounds
    row_valid = rng.uniform(size=(4, r)) < 0.8
    col_valid = rng.uniform(size=(4, c)) < 0.8
    row_valid[2] = col_valid[2] = True
    t = torch.from_numpy
    got = greedy_assign(t(sims), thr, t(row_valid), t(col_valid))
    rounds = []
    for si in range(4):
        one = greedy_assign(t(sims[si]), thr, t(row_valid[si]), t(col_valid[si]))
        assert torch.equal(got.row_to_col[si], one.row_to_col)
        assert torch.equal(got.col_to_row[si], one.col_to_row)
        rounds.append(one.rounds)
    assert rounds[1] == 0 and rounds[2] == r
    assert got.rounds == max(rounds)
    assert int((got.row_to_col[0] >= 0).sum()) > 0


def _detections(seed: int):
    """(FRAMES, S, D) padded detections: walkers with drop-outs and jittered
    confidences per stream, stream 2 empty on two frames."""
    rng = np.random.default_rng(seed)
    boxes = np.zeros((FRAMES, S, D, 4), np.float32)
    conf = np.zeros((FRAMES, S, D), np.float32)
    cls = np.zeros((FRAMES, S, D), np.int32)
    valid = np.zeros((FRAMES, S, D), bool)
    for si in range(S):
        n = 6 + 3 * si
        start = rng.uniform(50, 600, (n, 2))
        vel = rng.uniform(-12, 12, (n, 2))
        for f in range(FRAMES):
            if si == 2 and f in (4, 5):
                continue
            xy = start + vel * f
            b = np.concatenate([xy, xy + [60, 120]], axis=1)
            keep = np.where(rng.uniform(size=n) < 0.85)[0]
            k = len(keep)
            boxes[f, si, :k] = b[keep]
            conf[f, si, :k] = rng.uniform(0.05, 0.95, k)
            cls[f, si, :k] = keep % 3
            valid[f, si, :k] = True
    return boxes, conf, cls, valid


CONFIGS = {
    "default": {},
    "fuse_gate": {"fuse_score": True, "gate_distance": True},
    "no_kalman": {"motion_model": "none", "match_metric": "iou", "match_thresh": 0.3},
    "few_slots": {"max_tracks": 8, "new_track_thresh": 0.2, "track_buffer": 2},
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_batched_bytetrack_equals_single_streams_and_jax_vmap(name):
    kw = CONFIGS[name]
    tcfg, jcfg = ByteTrackConfig(**kw), JaxByteTrackConfig(**kw)
    boxes, conf, cls, valid = _detections(seed=len(name))
    batched = init_multistream_state(S, tcfg.max_tracks)
    singles = [init_track_state(tcfg.max_tracks) for _ in range(S)]
    one = jax_init(jcfg.max_tracks)
    js = jax.tree.map(lambda x: jnp.broadcast_to(x, (S,) + x.shape), one)
    jstep = jax.jit(jax.vmap(functools.partial(jax_update, cfg=jcfg)))
    t = torch.from_numpy
    seen = 0
    for f in range(FRAMES):
        batched, bo = bytetrack_update(batched, t(boxes[f]), t(conf[f]), t(cls[f]),
                                       t(valid[f]), tcfg)
        for si in range(S):
            singles[si], so = bytetrack_update(singles[si], t(boxes[f, si]), t(conf[f, si]),
                                               t(cls[f, si]), t(valid[f, si]), tcfg)
            for a, b in zip(bo, so):
                assert torch.equal(a[si], b)
            for a, b in zip(batched, singles[si]):
                assert torch.equal(a[si], b)
        js, jo = jstep(js, jnp.asarray(boxes[f]), jnp.asarray(conf[f]), jnp.asarray(cls[f]),
                       jnp.asarray(valid[f]))
        np.testing.assert_array_equal(bo.visible.numpy(), np.asarray(jo.visible))
        np.testing.assert_array_equal(bo.track_id.numpy(), np.asarray(jo.track_id))
        np.testing.assert_array_equal(bo.class_id.numpy(), np.asarray(jo.class_id))
        np.testing.assert_array_equal(bo.tsu.numpy(), np.asarray(jo.tsu))
        np.testing.assert_allclose(bo.boxes.numpy(), np.asarray(jo.boxes), rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(batched.next_id.numpy(), np.asarray(js.next_id))
        seen += int(bo.visible.sum())
    assert seen > FRAMES * S


def _grids(seed: int, g: int = 64) -> np.ndarray:
    """(S, G, G) textured grids; stream si's current grid is its previous one
    shifted by (si + 1, -si) cells, stream 2 also gets noise."""
    rng = np.random.default_rng(seed)
    prev = rng.uniform(0, 255, (S, g, g)).astype(np.float32)
    prev = (prev + np.roll(prev, 1, 1) + np.roll(prev, 1, 2)) / 3
    cur = np.stack([np.roll(prev[si], (-si, si + 1), axis=(0, 1)) for si in range(S)])
    cur[2] += rng.normal(0, 40, (g, g)).astype(np.float32)
    return prev, cur


def test_batched_phase_shift_equals_per_stream():
    prev, cur = _grids(3)
    shift, conf = phase_shift(torch.from_numpy(prev), torch.from_numpy(cur))
    assert shift.shape == (S, 2) and conf.shape == (S,)
    for si in range(S):
        s1, c1 = phase_shift(torch.from_numpy(prev[si]), torch.from_numpy(cur[si]))
        torch.testing.assert_close(shift[si], s1, rtol=0, atol=1e-6)
        torch.testing.assert_close(conf[si], c1, rtol=1e-6, atol=0)
    assert abs(float(shift[0, 0]) - 1.0) < 0.1 and abs(float(shift[1, 1]) + 1.0) < 0.1


def test_batched_gmc_step_and_compensate_equal_per_stream():
    cfg = GMCConfig(method="phase", grid=64)
    prev, cur = _grids(4)
    boxes, conf, cls, valid = _detections(seed=2)
    bcfg = ByteTrackConfig()
    t = torch.from_numpy
    state = init_multistream_state(S, 32)
    singles = [init_track_state(32) for _ in range(S)]
    state, _ = bytetrack_update(state, t(boxes[0]), t(conf[0]), t(cls[0]), t(valid[0]), bcfg)
    for si in range(S):
        singles[si], _ = bytetrack_update(singles[si], t(boxes[0, si]), t(conf[0, si]),
                                          t(cls[0, si]), t(valid[0, si]), bcfg)
    carry = (t(prev), torch.tensor([1.0, 1.0, 0.0]))   # stream 2: first frame, no shift
    new_state, (grid, ok) = gmc_step(state, t(cur), carry, cfg, (10.0, 5.625))
    assert torch.equal(grid, t(cur)) and torch.equal(ok, torch.ones(S))
    for si in range(S):
        one, _ = gmc_step(singles[si], t(cur[si]), (t(prev[si]), carry[1][si]), cfg,
                          (10.0, 5.625))
        for a, b in zip(new_state, one):
            torch.testing.assert_close(a[si], b, rtol=0, atol=1e-4)
    assert torch.equal(new_state.boxes[2], state.boxes[2])
    shift = torch.tensor([[3.0, -2.0], [0.5, 0.25], [0.0, 0.0]])
    moved = compensate(state, shift)
    for si in range(S):
        one = compensate(singles[si], shift[si])
        for a, b in zip(moved, one):
            assert torch.equal(a[si], b)
    z = init_carry(64, "cpu", S)
    assert z[0].shape == (S, 64, 64) and z[1].shape == (S,) and not z[1].any()
