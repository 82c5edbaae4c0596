"""The port's ByteTrack (rtmodt_tpu_torch/tracking/bytetrack.py) against the
JAX ``bytetrack_update`` on the scenarios of tests/test_tracker.py.

Both trackers get the same detection sequences (padded to a fixed D with a
validity mask, as the reference facade pads).  ``track_id`` and ``visible``
must be identical every frame and boxes within 1e-5 relative (float32 Kalman
arithmetic on coordinates of order 100-1000 px, rounded in a different order
by the two frameworks; 1e-5 relative is ~80 ulp at those magnitudes).
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
from rtmodt_tpu.tracking.bytetrack import claim_free_slots as jax_claim
from rtmodt_tpu.tracking.bytetrack import init_track_state as jax_init
from rtmodt_tpu_torch.config.loader import ByteTrackConfig
from rtmodt_tpu_torch.tracking.bytetrack import (bytetrack_update, claim_free_slots,
                                                 init_track_state)
from tests.test_torch_port_threads import torch_threads  # noqa: F401 (autouse)

D = 8


def walk(box, t, v=(4.0, 2.0)):
    return [box[0] + v[0] * t, box[1] + v[1] * t, box[2] + v[0] * t, box[3] + v[1] * t]


def _id_persistence():
    return [([walk([100, 100, 200, 300], t)], [0.9]) for t in range(10)]


def _two_objects():
    a, b = [100, 100, 200, 300], [800, 400, 900, 600]
    return [([walk(a, t), walk(b, t, (-3, 1))], [0.9, 0.85]) for t in range(10)]


def _low_conf_second_stage():
    box = [100, 100, 200, 300]
    seq = [([walk(box, t)], [0.9]) for t in range(5)]
    return seq + [([walk(box, 5)], [0.3]), ([walk(box, 6)], [0.9]), ([[10, 10, 50, 50]], [0.3])]


def _buffer_expiry():
    return [([[100, 100, 200, 300]], [0.9])] + [([], [])] * 5 + [([[100, 100, 200, 300]], [0.9])]


def _reappear():
    box = [100, 100, 200, 300]
    return ([([walk(box, t)], [0.9]) for t in range(5)] + [([], [])] * 3
            + [([walk(box, 8)], [0.9])])


def _teleport():
    box = np.array([100, 100, 200, 300], np.float32)
    vx = np.array([20, 0, 20, 0], np.float32)
    seq = [([box + t * vx], [0.9]) for t in range(12)]
    return seq + [([box + 12 * vx - np.array([60, 0, 60, 0], np.float32)], [0.9])]


def _crowd():
    """Eight walkers on crossing paths with jittered confidences."""
    rng = np.random.default_rng(9)
    starts = rng.uniform(50, 600, (8, 2))
    vel = rng.uniform(-12, 12, (8, 2))
    seq = []
    for t in range(20):
        xy = starts + vel * t
        boxes = np.concatenate([xy, xy + [60, 120]], axis=1)
        conf = rng.uniform(0.05, 0.95, 8)
        keep = rng.uniform(size=8) < 0.85
        seq.append((boxes[keep].tolist(), conf[keep].tolist()))
    return seq


SCENARIOS = {
    "id_persistence": (_id_persistence, dict(match_thresh=0.3)),
    "two_objects": (_two_objects, dict(match_thresh=0.3)),
    "low_conf_second_stage": (_low_conf_second_stage, dict(match_thresh=0.3)),
    "buffer_expiry": (_buffer_expiry, dict(track_buffer=3, match_thresh=0.3)),
    "reappear": (_reappear, dict(match_thresh=0.3)),
    "fuse_and_gate": (_id_persistence, dict(match_thresh=0.25, fuse_score=True,
                                            gate_distance=True)),
    "teleport_gated": (_teleport, dict(match_thresh=0.1, match_metric="iou",
                                       gate_distance=True)),
    "teleport_ungated": (_teleport, dict(match_thresh=0.1, match_metric="iou")),
    "no_kalman": (_two_objects, dict(motion_model="none", match_thresh=0.3)),
    "crowd_defaults": (_crowd, dict()),
    "crowd_birth_gate": (_crowd, dict(new_track_thresh=0.6, max_tracks=6)),
}


def _pad(boxes, conf, cls_seed):
    n = len(boxes)
    b = np.zeros((D, 4), np.float32)
    c = np.zeros((D,), np.float32)
    k = np.zeros((D,), np.int32)
    v = np.zeros((D,), bool)
    if n:
        b[:n] = np.asarray(boxes, np.float32).reshape(n, 4)
        c[:n] = conf
        k[:n] = np.arange(n) % 3 + cls_seed
        v[:n] = True
    return b, c, k, v


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_bytetrack_matches_jax(name):
    make, kw = SCENARIOS[name]
    tcfg, jcfg = ByteTrackConfig(**kw), JaxByteTrackConfig(**kw)
    ts = init_track_state(tcfg.max_tracks)
    js = jax_init(jcfg.max_tracks)
    jax_step = jax.jit(functools.partial(jax_update, cfg=jcfg))
    seen = 0
    for boxes, conf in make():
        b, c, k, v = _pad(boxes, conf, 0)
        ts, to = bytetrack_update(ts, torch.from_numpy(b), torch.from_numpy(c),
                                  torch.from_numpy(k), torch.from_numpy(v), tcfg)
        js, jo = jax_step(js, jnp.asarray(b), jnp.asarray(c), jnp.asarray(k),
                          jnp.asarray(v))
        np.testing.assert_array_equal(to.visible.numpy(), np.asarray(jo.visible))
        np.testing.assert_array_equal(to.track_id.numpy(), np.asarray(jo.track_id))
        np.testing.assert_array_equal(to.class_id.numpy(), np.asarray(jo.class_id))
        np.testing.assert_array_equal(to.age.numpy(), np.asarray(jo.age))
        np.testing.assert_array_equal(to.tsu.numpy(), np.asarray(jo.tsu))
        np.testing.assert_array_equal(ts.active.numpy(), np.asarray(js.active))
        np.testing.assert_allclose(to.boxes.numpy(), np.asarray(jo.boxes), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(to.confidence.numpy(), np.asarray(jo.confidence), atol=1e-6)
        assert int(ts.next_id) == int(js.next_id)
        seen += int(to.visible.sum())
    assert seen > 0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_claim_free_slots_matches_jax(seed):
    rng = np.random.default_rng(seed)
    active = rng.uniform(size=16) < 0.7
    is_new = rng.uniform(size=10) < 0.6
    got = claim_free_slots(torch.from_numpy(active), torch.from_numpy(is_new),
                           torch.tensor(5, dtype=torch.int32))
    want = jax_claim(jnp.asarray(active), jnp.asarray(is_new), jnp.int32(5))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
