"""Every tracker, with camera-motion compensation on, through the port's three
pipeline paths against the JAX package on the CPU.

A shaky clip (6 frames of 512x288: a scene of moving boxes seen through a
window that jumps up to 16 px a frame) goes through the port's
``Pipeline.step`` (per stage), ``step_packed`` (packed per frame) and
``run_chunked`` (chunks of 3) with each of ``bytetrack``, ``ocsort``,
``deepsort`` and ``botsort`` and ``tracking.gmc.method: phase``, with
``gmc.method: none`` through ``run_chunked`` (OC-SORT, BoT-SORT; ByteTrack's
is ``tests/test_torch_port_pipeline.py``), and with ``bytetrack`` +
``assignment: lapjv`` through ``step``; every tracker setting loads from
config as the reference's loader reads it.  The reference is the
JAX composition of the same stages, as the JAX pipeline orders them:

  * per stage: ``letterbox`` -> forward -> NMS -> ``unletterbox_boxes``;
    ``gmc_step`` on the full-resolution BGR frame; the facade's
    ``embed_fn`` on the frame's ROI crops; the tracker update;
  * packed (per frame and chunked): ``pack_chunk`` -> ``planar_letterbox``
    -> forward -> NMS; crops of the padded Y/U/V planes (``crop_yuv_rgb``)
    into the embedder; ``gmc_step`` on ``luma_grid(half_res_luma(y))``;
    ``unletterbox_boxes_packed``; the tracker update;
  * lapjv: the per-stage detections to host ``Detections``, the reference
    facade's ``HostByteTrack``.

The trained rich640d weights at a 256 px input in float32 and the shipped
``embedder.npz``, for the reason in ``tests/test_torch_port_pipeline.py``.
The JAX detections are made once and shared by every tracker's reference.
Per-frame visible track ids and classes must be identical, boxes within
1e-4 px, and the zone-event JSONL identical less ``timestamp_utc``, with
``bbox_xyxy`` within 1e-4 px.  Not against the JAX ``step_packed`` /
chunk programs: they run the space-to-depth front, which differs on a 1-px
border ring (``ops/planar_stem.py``).
"""

from __future__ import annotations

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rtmodt_tpu.config.loader import load_config as jax_load_config
from rtmodt_tpu.detection.detector import Detections as JaxDetections
from rtmodt_tpu.events.zone_engine import ZoneEventEngine as JaxEngine
from rtmodt_tpu.models.weights import fuse_bn as jax_fuse_bn
from rtmodt_tpu.models.weights import load_npz as jax_load_npz
from rtmodt_tpu.models.yolov8 import build_model as jax_build
from rtmodt_tpu.ops.gmc import gmc_step as jax_gmc_step
from rtmodt_tpu.ops.gmc import half_res_luma as jax_half_res_luma
from rtmodt_tpu.ops.gmc import luma_grid as jax_luma_grid
from rtmodt_tpu.ops.letterbox import letterbox as jax_letterbox
from rtmodt_tpu.ops.letterbox import letterbox_meta as jax_letterbox_meta
from rtmodt_tpu.ops.letterbox import unletterbox_boxes as jax_unletterbox
from rtmodt_tpu.ops.nms import batched_nms_from_logits as jax_nms
from rtmodt_tpu.ops.planar_stem import pad_planes as jax_pad_planes
from rtmodt_tpu.ops.roi import crop_yuv_rgb as jax_crop_yuv_rgb
from rtmodt_tpu.ops.yuv import pack_chunk as jax_pack_chunk
from rtmodt_tpu.ops.yuv import packed_meta as jax_packed_meta
from rtmodt_tpu.ops.yuv import planar_letterbox as jax_planar_letterbox
from rtmodt_tpu.ops.yuv import unletterbox_boxes_packed as jax_unletterbox_packed
from rtmodt_tpu.tracking.tracker import MultiObjectTracker as JaxTracker
from rtmodt_tpu.utils.coco_names import COCO_NAMES
from rtmodt_tpu_torch.config import load_config
from rtmodt_tpu_torch.runtime.pipeline import Pipeline
from rtmodt_tpu_torch.utils.synthetic import moving_boxes_frame

H, W, SIZE, K, N_FRAMES, FPS = 288, 512, 256, 3, 6, 25.0
CONF = 0.35
CLASSES = [0, 1, 2, 3, 5, 7]
NAMES = list(COCO_NAMES)[:8]
BOX_ATOL = 1e-4
GMC = {"method": "phase", "grid": 64}
ALGORITHMS = ("bytetrack", "ocsort", "deepsort", "botsort")
WEIGHTS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "checkpoints", "rich640d", "ema_final.npz")
ZONES = [
    {"name": "left_half", "polygon": [[0, 0], [256, 0], [256, 288], [0, 288]],
     "trigger": "intrusion", "dwell_time_sec": 0.08, "cooldown_sec": 0.1},
    {"name": "gate", "polygon": [[120, 0], [512, 0], [512, 288], [120, 288]],
     "trigger": "crossing", "cooldown_sec": 1.0},
]


def overrides(log_path: str, algorithm: str, gmc: dict | None = GMC, **extra) -> dict:
    """Config shared by both packages' loaders."""
    tracking = {"algorithm": algorithm, "ocsort": {"min_hits": 2},
                "deepsort": {"n_init": 2}}
    if gmc is not None:
        tracking["gmc"] = gmc
    out = {
        "system": {"device": "cpu"},
        "detection": {"model": "yolov8s", "input_size": SIZE, "num_classes": 8,
                      "weights": WEIGHTS, "half": False, "classes": CLASSES,
                      "conf_threshold": CONF},
        "tracking": tracking,
        "events": {"zones": ZONES, "alert": {"backend": "json_file", "log_path": log_path}},
        "profiling": {"warmup_frames": 0, "log_interval": 0},
        "visualization": {"enabled": False},
        "parallel": {"chunk_size": K, "pipeline_depth": 1},
    }
    for section, values in extra.items():
        out[section] = {**out.get(section, {}), **values}
    return out


@pytest.fixture(scope="module")
def clip():
    m = 16
    rng = np.random.default_rng(4)
    frames = []
    for t in range(N_FRAMES):
        big, _ = moving_boxes_frame(t, H + 2 * m, W + 2 * m, 6, seed=1)
        ox, oy = rng.integers(0, 2 * m + 1, 2) if t else (m, m)
        frames.append(np.ascontiguousarray(big[oy:oy + H, ox:ox + W]))
    return frames


@pytest.fixture(scope="module")
def jax_detect(clip):
    """JAX detections of every frame of the clip, made once for all trackers:
    ``bgr`` [(frame, res)] per stage from the BGR frame; ``planar`` [(y,
    res, boxes in model-input coordinates, padded planes)] from one packed
    frame at a time."""
    model = jax_build("yolov8s", num_classes=8, dtype=jnp.float32, fused=True)
    params = jax_fuse_bn(jax.device_get(jax_load_npz(WEIGHTS)))
    mask = jnp.asarray(np.isin(np.arange(8), CLASSES))
    geom = jax_packed_meta(H, W, SIZE)
    meta = jax_letterbox_meta(H, W, SIZE)

    def nms(bd, cl):
        return jax_nms(bd[0], cl[0], SIZE, CONF, 0.45, 100, 300, mask)

    @jax.jit
    def bgr(frame):
        img, _ = jax_letterbox(frame, SIZE, dtype=jnp.float32)
        res = nms(*model.apply(params, img[None], train=False))
        return res._replace(boxes=jax_unletterbox(res.boxes, meta))

    @jax.jit
    def planar(y, u, v):
        img = jax.vmap(lambda a, b, c: jax_planar_letterbox(
            a, b, c, SIZE, geom.pad_left, geom.pad_top, dtype=jnp.float32))(y, u, v)
        res_lb = nms(*model.apply(params, img, train=False))
        planes = jax_pad_planes(y, u, v, SIZE, geom.pad_left, geom.pad_top)
        return res_lb._replace(boxes=jax_unletterbox_packed(res_lb.boxes, geom)), \
            res_lb.boxes, planes

    out = {"bgr": [], "planar": []}
    for frame in clip:
        fdev = jnp.asarray(frame)
        out["bgr"].append((fdev, bgr(fdev)))
        (y, u, v), _ = jax_pack_chunk(frame[None], SIZE)
        out["planar"].append((jnp.asarray(y[0]),
                              *planar(jnp.asarray(y), jnp.asarray(u), jnp.asarray(v))))
    return out


def _jax_tracker(algorithm: str, gmc: dict | None = GMC, **extra):
    cfg = jax_load_config(overrides=overrides("unused.jsonl", algorithm, gmc, **extra))
    t = cfg.tracking
    return JaxTracker(t.algorithm, trail_length=t.trail_length, bytetrack=t.bytetrack,
                      deepsort=t.deepsort, botsort=t.botsort, ocsort=t.ocsort, gmc=t.gmc), t


def _jax_events(log_path: str) -> JaxEngine:
    return JaxEngine(ZONES, log_path=log_path, trail_length=30)


_REFS: dict = {}
_JITS: dict = {}


def _jax_programs(algorithm: str):
    """The reference facade of an algorithm, its jitted crop + embed of the
    padded planes, and the jitted GMC step and grid (each compiled once; the
    compositions keep their own state and carry)."""
    if algorithm not in _JITS:
        tr, tcfg = _jax_tracker(algorithm)
        if "gmc" not in _JITS:
            gcfg, g = tcfg.gmc, tcfg.gmc.grid
            _JITS["gmc"] = (
                jax.jit(lambda st, src, c: jax_gmc_step(st, src, c, gcfg, (W / g, H / g))),
                jax.jit(lambda y: jax_luma_grid(jax_half_res_luma(y), g)), g)
        crop_hw = tuple(getattr(tr.cfg, "crop_hw", (64, 32)))
        embed_planes = jax.jit(lambda yp, up, vp, boxes: tr.embedder.apply(
            tr.embedder_params, jax_crop_yuv_rgb(yp.astype(jnp.float32), up.astype(jnp.float32),
                                                 vp.astype(jnp.float32), boxes, crop_hw)))
        _JITS[algorithm] = tr, embed_planes
    return (*_JITS[algorithm], *_JITS["gmc"])


def jax_reference(algorithm: str, packed: bool, clip, jax_detect, log_path: str,
                  gmc_on: bool = True):
    """Per-frame [(id, class, box)] and the event logs (per frame, per
    chunk) of the JAX composition (one run per case, cached)."""
    key = (algorithm, packed, gmc_on)
    if key in _REFS:
        return _REFS[key]
    tr, embed_planes, gmc, grid_of, g = _jax_programs(algorithm)
    appearance = algorithm in ("deepsort", "botsort")
    engine = _jax_events(log_path)
    chunk_log = log_path + ".chunked"
    chunk_engine = _jax_events(chunk_log)
    chunk_outs = []
    state = tr.state
    carry = (jnp.zeros((g, g), jnp.float32), jnp.float32(0.0))
    frames = []
    for i in range(len(clip)):
        if packed:
            y, res, boxes_lb, (yp, up, vp) = jax_detect["planar"][i]
            if gmc_on:
                state, carry = gmc(state, grid_of(y), carry)
            feats = embed_planes(yp[0], up[0], vp[0], boxes_lb) if appearance else None
        else:
            fdev, res = jax_detect["bgr"][i]
            if gmc_on:
                state, carry = gmc(state, fdev, carry)
            feats = tr.embed_fn()(fdev, res.boxes) if appearance else None
        args = (res.boxes, res.scores, res.classes, res.valid)
        state, outputs = tr._step(state, *args, *((feats,) if appearance else ()))
        tracks = tr.tracks_from_outputs(outputs, NAMES)
        engine.process(tracks, i + 1, i / FPS)
        frames.append([(t.track_id, t.class_id, np.asarray(t.xyxy, np.float32))
                       for t in tracks])
        # the chunked path hands the engine K frames of raw outputs at once
        chunk_outs.append(jax.device_get(outputs))
        if len(chunk_outs) == K:
            stack = lambda f: np.stack([getattr(o, f) for o in chunk_outs])  # noqa: E731
            c0 = i + 1 - K
            chunk_engine.process_chunk(
                stack("track_id"), stack("class_id"), stack("boxes"), stack("visible"),
                list(range(c0 + 1, c0 + K + 1)), np.arange(c0, c0 + K, dtype=np.float64) / FPS,
                class_names=NAMES)
            chunk_outs = []
    _REFS[key] = frames, log_path, chunk_log
    return _REFS[key]


def events(path: str) -> list[dict]:
    with open(path) as f:
        out = [json.loads(line) for line in f]
    for e in out:
        e.pop("timestamp_utc")
    return out


def assert_same_run(got_frames, got_log, want_frames, want_log, n_min_visible=N_FRAMES):
    assert len(got_frames) == len(want_frames) == N_FRAMES
    n_visible = 0
    for g, w in zip(got_frames, want_frames):
        assert [(tid, cls) for tid, cls, _ in g] == [(tid, cls) for tid, cls, _ in w]
        for (_, _, gb), (_, _, wb) in zip(g, w):
            np.testing.assert_allclose(gb, wb, rtol=0, atol=BOX_ATOL)
        n_visible += len(g)
    assert n_visible >= n_min_visible
    got, want = events(got_log), events(want_log)
    assert len(want) > 0 and len(got) == len(want)
    got_boxes = np.array([e.pop("bbox_xyxy") for e in got])
    want_boxes = np.array([e.pop("bbox_xyxy") for e in want])
    assert got == want
    np.testing.assert_allclose(got_boxes, want_boxes, rtol=0, atol=BOX_ATOL)


def _tracks(tracks) -> list:
    return [(t.track_id, t.class_id, np.asarray(t.xyxy, np.float32)) for t in tracks]


def _chunk_frames(pipe) -> list:
    """Wrap ``track_chunk`` to keep each frame's visible (id, class, box)."""
    frames = []
    inner = pipe.track_chunk

    def wrapped(*args, **kwargs):
        outs = inner(*args, **kwargs)
        for f in range(outs.visible.shape[0]):
            idx = np.where(outs.visible[f].numpy())[0]
            idx = idx[np.argsort(outs.track_id[f].numpy()[idx])]
            frames.append([(int(outs.track_id[f, i]), int(outs.class_id[f, i]),
                            outs.boxes[f, i].numpy()) for i in idx])
        return outs

    pipe.track_chunk = wrapped
    return frames


@pytest.mark.parametrize("path", ["per_stage", "packed", "chunked"])
@pytest.mark.parametrize("algorithm", ALGORITHMS)
def test_tracker_with_gmc_matches_jax(algorithm, path, clip, jax_detect, tmp_path):
    want_frames, want_log, want_chunk_log = jax_reference(
        algorithm, path != "per_stage", clip, jax_detect, str(tmp_path / "jax.jsonl"))
    log = str(tmp_path / "port.jsonl")
    pipe = Pipeline(load_config(overrides=overrides(
        log, algorithm, profiling={"per_stage": path == "per_stage"})))
    assert pipe._gmc_on and pipe.tracker.algorithm == algorithm
    if path == "chunked":
        got = _chunk_frames(pipe)
        summary = pipe.run_chunked(list(clip), fps=FPS)
        assert summary["frames"] == N_FRAMES and summary["chunks"] == N_FRAMES // K
    else:
        step = pipe.step if path == "per_stage" else pipe.step_packed
        got = [_tracks(step(frame, i + 1, i / FPS)[0]) for i, frame in enumerate(clip)]
    assert_same_run(got, log, want_frames, want_chunk_log if path == "chunked" else want_log)


@pytest.mark.parametrize("algorithm", ["ocsort", "botsort"])
def test_tracker_without_gmc_matches_jax_chunked(algorithm, clip, jax_detect, tmp_path):
    want_frames, _, want_log = jax_reference(
        algorithm, True, clip, jax_detect, str(tmp_path / "jax.jsonl"), gmc_on=False)
    log = str(tmp_path / "port.jsonl")
    pipe = Pipeline(load_config(overrides=overrides(log, algorithm, gmc=None,
                                                    profiling={"per_stage": False})))
    assert not pipe._gmc_on
    got = _chunk_frames(pipe)
    pipe.run_chunked(list(clip), fps=FPS)
    assert_same_run(got, log, want_frames, want_log)


@pytest.mark.parametrize("algorithm", ALGORITHMS)
@pytest.mark.parametrize("gmc", ["none", "phase"])
def test_config_loads_every_tracker_setting_as_the_reference(algorithm, gmc):
    import dataclasses

    over = {"tracking": {"algorithm": algorithm, "gmc": {"method": gmc}}}
    port, ref = load_config(overrides=over).tracking, jax_load_config(overrides=over).tracking
    assert port.algorithm == ref.algorithm and port.gmc.method == gmc
    for name in ("gmc", "bytetrack", "deepsort", "botsort", "ocsort"):
        want = dataclasses.asdict(getattr(ref, name))
        got = dataclasses.asdict(getattr(port, name))
        assert {k: v for k, v in want.items() if k in got} == got, name
    lapjv = {"tracking": {"bytetrack": {"assignment": "lapjv"}, "gmc": {"method": gmc}}}
    if gmc == "phase":          # GMC needs the device tracker state: both refuse
        for loader in (load_config, jax_load_config):
            with pytest.raises(ValueError, match="lapjv"):
                loader(overrides=lapjv)
    else:
        assert load_config(overrides=lapjv).tracking.bytetrack.assignment == "lapjv"


def test_lapjv_per_stage_matches_the_jax_host_tracker(clip, jax_detect, tmp_path):
    lapjv = {"tracking": {"bytetrack": {"assignment": "lapjv"}}}
    ref, _ = _jax_tracker("bytetrack", gmc=None, **lapjv)
    assert ref._host is not None
    want_log = str(tmp_path / "jax.jsonl")
    engine = _jax_events(want_log)
    want = []
    for i, (_, res) in enumerate(jax_detect["bgr"]):
        res = jax.device_get(res)
        n = int(res.count)
        tracks = ref.update(JaxDetections(
            np.asarray(res.boxes[:n], np.float32), np.asarray(res.scores[:n], np.float32),
            np.asarray(res.classes[:n], np.int32), NAMES))
        engine.process(tracks, i + 1, i / FPS)
        want.append(_tracks(tracks))
    log = str(tmp_path / "port.jsonl")
    for per_stage in (True, False):      # the host tracker runs per frame either way
        if os.path.exists(log):
            os.remove(log)
        pipe = Pipeline(load_config(overrides=overrides(
            log, "bytetrack", gmc=None, profiling={"per_stage": per_stage}, **lapjv)))
        assert pipe.tracker._host is not None and pipe.tracker.state is None
        got = [_tracks(pipe.step(frame, i + 1, i / FPS)[0]) for i, frame in enumerate(clip)]
        assert_same_run(got, log, want, want_log)
        with pytest.raises(ValueError, match="lapjv"):
            pipe.step_packed(clip[0], 1, 0.0)
        with pytest.raises(ValueError, match="lapjv"):
            pipe.run_chunked(list(clip), fps=FPS)
