"""OC-SORT, DeepSORT, BoT-SORT, the host ByteTrack and LAPJV of the port
against the JAX package on the CPU.

  * ``lapjv``: the port's C++ solver (built here with the host compiler)
    gives the assignments of the reference's ``native.lapjv`` on square,
    wide and tall matrices, with and without a cost limit;
  * the update functions (``ocsort_update``, ``deepsort_update``,
    ``botsort_update``) over a seeded scene of objects that cross, leave and
    come back with confidences across both BYTE stages, with seeded
    appearance features: identical ``visible`` and ``track_id`` in every
    frame, visible boxes within 1e-5 relative (float32), identical
    ``next_id``;
  * the facade ``MultiObjectTracker.update(detections, frame)`` for every
    algorithm and ``bytetrack`` with ``assignment: lapjv``, on the scenes of
    ``tests/test_ocsort.py`` / ``tests/test_tracker.py`` (walking objects, a
    stop-and-go gap, a low-confidence stretch) and, GMC off and on, on the
    camera-shake scene of ``tests/test_gmc.py``: identical Track lists (ids,
    classes, ages, trails), boxes within 1e-5.
"""

from __future__ import annotations

import functools

import jax
import numpy as np
import pytest
import torch

from rtmodt_tpu.config import loader as jl
from rtmodt_tpu.detection.detector import Detections as JaxDetections
from rtmodt_tpu.native import lapjv as jax_lapjv
from rtmodt_tpu.tracking import botsort as jbs
from rtmodt_tpu.tracking import deepsort as jds
from rtmodt_tpu.tracking import ocsort as jos
from rtmodt_tpu.tracking.tracker import MultiObjectTracker as JaxTracker
from rtmodt_tpu_torch.config import loader as tl
from rtmodt_tpu_torch.detection.detector import Detections
from rtmodt_tpu_torch.ops.lapjv import lapjv
from rtmodt_tpu_torch.tracking import botsort as tbs
from rtmodt_tpu_torch.tracking import deepsort as tds
from rtmodt_tpu_torch.tracking import ocsort as tos
from rtmodt_tpu_torch.tracking.tracker import MultiObjectTracker
from tests.test_gmc import _shake_scene
from tests.test_torch_port_facade import _same_tracks, scene
from tests.test_torch_port_threads import torch_threads  # noqa: F401 (autouse)

NAMES = ["person", "bicycle", "car", "motorcycle"]
EMBED = 16


@pytest.mark.parametrize("shape,limit", [((6, 6), np.inf), ((5, 9), 0.7), ((9, 4), 0.5),
                                         ((40, 40), 0.8), ((1, 7), np.inf), ((7, 1), 0.3)])
def test_lapjv_matches_the_reference_solver(shape, limit):
    rng = np.random.default_rng(shape[0] * 31 + shape[1])
    for _ in range(5):
        cost = rng.uniform(0, 1, shape)
        cost[rng.uniform(size=shape) < 0.2] = 1.0           # ties at the limit
        np.testing.assert_array_equal(lapjv(cost, limit), jax_lapjv(cost, limit))
    assert lapjv(np.zeros((0, 3))).shape == (0,)
    np.testing.assert_array_equal(lapjv(np.zeros((3, 0))), [-1, -1, -1])


def _features(rng, n_obj):
    base = rng.normal(size=(n_obj, EMBED)).astype(np.float32)

    def feats(n):
        f = base[:n] + 0.15 * rng.normal(size=(n, EMBED)).astype(np.float32)
        return f / np.linalg.norm(f, axis=1, keepdims=True)
    return feats


def _padded(boxes, conf, cls, feat, d=16):
    n = len(boxes)
    out = [np.zeros((d, 4), np.float32), np.zeros(d, np.float32), np.full(d, -1, np.int32),
           np.zeros(d, bool), np.zeros((d, EMBED), np.float32)]
    for a, v in zip(out, (boxes, conf, cls, np.ones(n, bool), feat)):
        a[:n] = v
    return out


UPDATES = {
    "ocsort": (jos.ocsort_update, tos.ocsort_update, lambda: (
        jos.init_ocsort_state(32, 3), tos.init_ocsort_state(32, 3)),
        jl.OCSortConfig, tl.OCSortConfig, {"max_tracks": 32, "min_hits": 2}),
    "ocsort_byte": (jos.ocsort_update, tos.ocsort_update, lambda: (
        jos.init_ocsort_state(32, 2), tos.init_ocsort_state(32, 2)),
        jl.OCSortConfig, tl.OCSortConfig,
        {"max_tracks": 32, "use_byte": True, "delta_t": 2, "det_thresh": 0.5}),
    "deepsort": (jds.deepsort_update, tds.deepsort_update, lambda: (
        jds.init_deepsort_state(32, EMBED), tds.init_deepsort_state(32, EMBED)),
        jl.DeepSortConfig, tl.DeepSortConfig, {"max_tracks": 32, "embed_dim": EMBED,
                                               "n_init": 2}),
    "deepsort_nogate": (jds.deepsort_update, tds.deepsort_update, lambda: (
        jds.init_deepsort_state(32, EMBED), tds.init_deepsort_state(32, EMBED)),
        jl.DeepSortConfig, tl.DeepSortConfig, {"max_tracks": 32, "embed_dim": EMBED,
                                               "gate_distance": False, "max_dist": 0.4}),
    "botsort": (jbs.botsort_update, tbs.botsort_update, lambda: (
        jbs.init_botsort_state(32, EMBED), tbs.init_botsort_state(32, EMBED)),
        jl.BotSortConfig, tl.BotSortConfig, {"max_tracks": 32, "embed_dim": EMBED}),
    "botsort_nofuse": (jbs.botsort_update, tbs.botsort_update, lambda: (
        jbs.init_botsort_state(32, EMBED), tbs.init_botsort_state(32, EMBED)),
        jl.BotSortConfig, tl.BotSortConfig, {"max_tracks": 32, "embed_dim": EMBED,
                                             "fuse_score": False, "track_buffer": 5}),
}


@pytest.mark.parametrize("name", sorted(UPDATES))
def test_update_functions_match(name):
    jfn, tfn, init, jcfg_cls, tcfg_cls, kw = UPDATES[name]
    appearance = "ocsort" not in name
    jstep = jax.jit(functools.partial(jfn, cfg=jcfg_cls(**kw)))
    tstep = functools.partial(tfn, cfg=tcfg_cls(**kw))
    jstate, tstate = init()
    rng = np.random.default_rng(7)
    feats = _features(rng, 14)
    n_visible = 0
    for boxes, conf, cls in scene(50, 14, 5):
        args = _padded(boxes, conf, cls, feats(len(boxes)))
        if not appearance:
            args = args[:4]
        jstate, jo = jstep(jstate, *args)
        tstate, to = tstep(tstate, *(torch.from_numpy(a) for a in args))
        jv = np.asarray(jo.visible)
        np.testing.assert_array_equal(to.visible.numpy(), jv)
        np.testing.assert_array_equal(to.track_id.numpy()[jv], np.asarray(jo.track_id)[jv])
        np.testing.assert_allclose(to.boxes.numpy()[jv], np.asarray(jo.boxes)[jv],
                                   rtol=1e-5, atol=1e-5)
        n_visible += int(jv.sum())
    assert int(tstate.next_id) == int(jstate.next_id) > 1
    assert n_visible > 100


def _walk_scene(n_frames=30):
    """The scenes of tests/test_ocsort.py and tests/test_tracker.py in one:
    objects walking at constant speed, two crossing, one stopping behind an
    occluder for 5 frames and re-appearing where it was last seen, one at
    low confidence for a stretch.  Per frame (boxes, conf, cls) and a drawn
    frame."""
    out = []
    for t in range(n_frames):
        boxes, conf = [], []
        boxes.append([20 + 4 * t, 30 + 2 * t, 70 + 4 * t, 110 + 2 * t])
        conf.append(0.9)
        boxes.append([300 - 5 * t, 60, 350 - 5 * t, 140])            # crosses the first
        conf.append(0.85)
        if not 12 <= t < 17:                                          # stop and go
            x = 40 + 9 * min(t, 11)
            boxes.append([x, 200, x + 40, 280])
            conf.append(0.8)
        boxes.append([400, 150 + t, 450, 230 + t])
        conf.append(0.3 if 20 <= t < 26 else 0.9)                    # low-conf stretch
        b = np.asarray(boxes, np.float32)
        frame = np.full((320, 480, 3), 40, np.uint8)
        for i, bx in enumerate(b.astype(int)):
            x1, y1, x2, y2 = np.clip(bx, 0, [479, 319, 479, 319])
            frame[y1:y2, x1:x2] = (60 + 45 * i, 200 - 40 * i, 90 + 30 * i)
        out.append((b, np.asarray(conf, np.float32), np.zeros(len(b), np.int32), frame))
    return out


def _shake():
    frames, gt = _shake_scene()
    return [(np.stack(list(gt[t + 1].values())), np.full(len(gt[t + 1]), 0.9, np.float32),
             np.zeros(len(gt[t + 1]), np.int32), f) for t, f in enumerate(frames)]


FACADE = [
    ("bytetrack", {}), ("bytetrack_lapjv", {"bytetrack": {"assignment": "lapjv"}}),
    ("bytetrack_lapjv_gated", {"bytetrack": {"assignment": "lapjv", "gate_distance": True,
                                             "fuse_score": True}}),
    ("ocsort", {"ocsort": {"min_hits": 1, "det_thresh": 0.5}}),
    ("deepsort", {"deepsort": {"n_init": 1, "max_dist": 0.4}}),
    ("botsort", {"botsort": {"track_thresh": 0.5, "new_track_thresh": 0.5}}),
]


# GMC on the shake scene (on the static walk scene it has nothing to do);
# GMC is refused with the host lapjv tracker by both packages' config checks
CASES = [(name, kwargs, gmc, scenario) for name, kwargs in FACADE
         for gmc in ("none", "phase") for scenario in ("walk", "shake")
         if not ("lapjv" in name and gmc == "phase")
         and not (scenario == "walk" and gmc == "phase")]


@pytest.mark.parametrize("name,kwargs,gmc,scenario", CASES,
                         ids=[f"{c[0]}-{c[2]}-{c[3]}" for c in CASES])
def test_facade_matches(name, kwargs, gmc, scenario):
    algorithm = name.split("_")[0]
    kw = dict(kwargs, gmc={"method": gmc, "grid": 64})
    port = MultiObjectTracker(algorithm, trail_length=5, device="cpu", **kw)
    ref = JaxTracker(algorithm, trail_length=5, **kw)
    assert (port._host is None) == (ref._host is None)
    data = _walk_scene() if scenario == "walk" else _shake()
    n = 0
    for boxes, conf, cls, frame in data:
        got = port.update(Detections(boxes, conf, cls, NAMES), frame)
        want = ref.update(JaxDetections(boxes, conf, cls, NAMES), frame)
        _same_tracks(got, want)
        n += len(got)
    assert n > len(data)
    port.reset()
    ref.reset()
    boxes, conf, cls, frame = data[0]
    _same_tracks(port.update(Detections(boxes, conf, cls, NAMES), frame),
                 ref.update(JaxDetections(boxes, conf, cls, NAMES), frame))


def test_appearance_trackers_need_the_frame():
    for algorithm in ("deepsort", "botsort"):
        tr = MultiObjectTracker(algorithm, device="cpu", **{algorithm: {"embedder": "random"}})
        boxes = np.asarray([[10, 10, 50, 90]], np.float32)
        with pytest.raises(ValueError, match="requires the frame"):
            tr.update(Detections(boxes, np.asarray([0.9], np.float32),
                                 np.zeros(1, np.int32), NAMES))
    with pytest.raises(OSError):
        MultiObjectTracker("deepsort", device="cpu", deepsort={"embedder": "no/such.npz"})
