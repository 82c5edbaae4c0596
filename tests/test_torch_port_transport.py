"""The transports and device zone masks of the port against the JAX package.

  * ``ops/polygon.py``: ``pad_polygons`` and ``points_in_polygons`` equal
    the reference's on random points and on the edge cases (vertices,
    points on edges, the padding's repeated vertex).
  * ``ops/yuv.py``: ``planes_to_x6`` / ``planes_to_x24`` equal the
    reference's byte for byte, their device inverses give the planes back
    exactly, and ``s2d_level`` decides as the reference's ``_s2d_level`` on
    a host with two cores (x24 pinned on a geometry it cannot block raises).
  * A chunk fed as planes, as an x6 array or as an x24 array gives bit-equal
    ``TrackOutputs`` (``Pipeline.submit_packed_yuv`` and
    ``MultiStreamPipeline.submit_chunk_packed``); mismatched layouts are
    refused as the reference refuses them.
  * ``run_chunked`` with ``events.device_masks`` writes the event log of the
    host masks, and the masks equal ``points_in_polygons`` on the CPU for the
    run's own slot centres; x6 and x24 runs (which ship the planes) write the
    planar run's log, and x24 pinned on a geometry it cannot block raises.
  * ``transport: bgr``: a chunk through ``submit_chunk`` and a whole
    ``run_chunked`` equal the JAX package's (rich640d at 256 px, float32;
    ids exact, boxes within 1e-4 px, the BGR letterbox's tolerance in
    tests/test_torch_port_live.py).
"""

from __future__ import annotations

import json
import os
import types

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtmodt_tpu.config.loader import load_config as jax_load_config
from rtmodt_tpu.ops.polygon import pad_polygons as jax_pad_polygons
from rtmodt_tpu.ops.polygon import points_in_polygons as jax_points_in_polygons
from rtmodt_tpu.ops.yuv import planes_to_x6 as jax_planes_to_x6
from rtmodt_tpu.ops.yuv import planes_to_x24 as jax_planes_to_x24
import rtmodt_tpu.runtime.pipeline as jax_pipeline_mod
from rtmodt_tpu.runtime.pipeline import Pipeline as JaxPipeline
from rtmodt_tpu_torch.config import load_config
from rtmodt_tpu_torch.ops import yuv
from rtmodt_tpu_torch.ops.polygon import pad_polygons, points_in_polygons
from rtmodt_tpu_torch.parallel.multistream import MultiStreamPipeline
from rtmodt_tpu_torch.runtime.pipeline import Pipeline
from rtmodt_tpu_torch.utils.synthetic import write_synthetic_video

H, W = 288, 512
BOX_ATOL = 1e-4
WEIGHTS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "checkpoints", "rich640d", "ema_final.npz")
POLYS = [[[100, 100], [500, 100], [500, 400], [100, 400]],
         [[600, 50], [900, 300], [700, 500], [550, 350], [500, 120]],
         [[0, 0], [50, 0], [25, 80]]]
ZONES = [{"name": "left_half", "polygon": [[0, 0], [256, 0], [256, 288], [0, 288]],
          "trigger": "intrusion", "dwell_time_sec": 0.12, "cooldown_sec": 0.2},
         {"name": "gate", "polygon": [[120, 0], [512, 0], [300, 288], [120, 288]],
          "trigger": "crossing", "direction": "left_to_right", "cooldown_sec": 1.0}]


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads while this module runs: the suite runs several
    workers on one host, and models at this size gain little from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("clip") / "clip25.mp4")
    write_synthetic_video(path, frames=12, h=H, w=W, n_objects=6, fps=25.0, seed=1)
    return path


@pytest.fixture(scope="module")
def frames(clip):
    cap = cv2.VideoCapture(clip)
    out = np.stack([cap.read()[1] for _ in range(4)])
    cap.release()
    return out


# -- polygons ---------------------------------------------------------------------

def test_points_in_polygons_equal_the_reference():
    rng = np.random.default_rng(0)
    padded = pad_polygons(POLYS, 8)
    np.testing.assert_array_equal(padded, jax_pad_polygons(POLYS, 8))
    verts = np.concatenate([np.asarray(p, np.float32) for p in POLYS])
    nxt = np.concatenate([np.roll(np.asarray(p, np.float32), -1, axis=0) for p in POLYS])
    t = rng.uniform(0, 1, (len(verts), 1)).astype(np.float32)
    pts = np.concatenate([
        rng.uniform(0, 1000, (400, 2)).astype(np.float32),     # random
        verts, (verts + nxt) / 2, verts + t * (nxt - verts),   # vertices, on edges
        verts + 1e-3, verts - 1e-3,                           # just off them
        np.array([[100, 250], [500, 250], [300, 100], [300, 400]], np.float32),
    ])
    got = points_in_polygons(torch.from_numpy(pts), torch.from_numpy(padded)).numpy()
    want = np.asarray(jax_points_in_polygons(jnp.asarray(pts), jnp.asarray(padded)))
    np.testing.assert_array_equal(got, want)
    assert got[:400].any() and not got[:400].all()
    # the padding adds nothing
    np.testing.assert_array_equal(
        points_in_polygons(torch.from_numpy(pts), torch.from_numpy(pad_polygons(POLYS, 5))).numpy(),
        got)
    with pytest.raises(ValueError, match="max_vertices"):
        pad_polygons(POLYS, 4)


# -- the space-to-depth layouts ------------------------------------------------------

@pytest.mark.parametrize("lead", [(3,), (2, 3)])
def test_x6_x24_pack_like_the_reference_and_unpack_exactly(lead):
    rng = np.random.default_rng(1)
    n, ch, cw = int(np.prod(lead)), 72, 128
    y = rng.integers(0, 256, (n, ch, cw), dtype=np.uint8)
    u = rng.integers(0, 256, (n, ch // 2, cw // 2), dtype=np.uint8)
    v = rng.integers(0, 256, (n, ch // 2, cw // 2), dtype=np.uint8)
    for pack, ref, unpack in ((yuv.planes_to_x6, jax_planes_to_x6, yuv.x6_to_planes),
                              (yuv.planes_to_x24, jax_planes_to_x24, yuv.x24_to_planes)):
        x = pack(y, u, v)
        np.testing.assert_array_equal(x, ref(y, u, v))
        x = torch.from_numpy(x).reshape(*lead, *x.shape[1:])
        for got, want in zip(unpack(x), (y, u, v)):
            np.testing.assert_array_equal(got.reshape(n, *got.shape[len(lead):]).numpy(), want)
        for got, want in zip(yuv.s2d_to_planes(x), (y, u, v)):
            np.testing.assert_array_equal(got.reshape(want.shape).numpy(), want)


@pytest.mark.parametrize("transport", ["packed", "x6", "x24", "i420", "bgr"])
@pytest.mark.parametrize("src_hw,size", [((720, 1280), 640), ((288, 512), 128),
                                         ((480, 640), 256), ((300, 500), 256)])
def test_s2d_level_decides_as_the_reference(transport, src_hw, size, monkeypatch):
    # the reference's `packed` picks x24 only on a host with two cores; the
    # port drops that host rule (it never repacks), so the reference is
    # asked as on such a host
    monkeypatch.setattr(jax_pipeline_mod, "_host_cpus", lambda: 2)
    cfg = jax_load_config(overrides={"detection": {"input_size": size},
                                     "parallel": {"transport": transport}})
    ns = types.SimpleNamespace(cfg=cfg, _is_appearance=False)
    ns._x6_transport = lambda: JaxPipeline._x6_transport(ns)
    try:
        want = JaxPipeline._s2d_level(ns, *src_hw)
    except ValueError as e:
        with pytest.raises(ValueError, match="x24 pinned") as got:
            yuv.s2d_level(transport, *src_hw, size)
        assert str(got.value) == str(e)
        return
    assert yuv.s2d_level(transport, *src_hw, size) == want


def _pipe(tmp_path, **over) -> Pipeline:
    o = {"system": {"device": "cpu"},
         "detection": {"model": "yolov8n", "input_size": 128, "conf_threshold": 0.01,
                       "classes": None, "nms_candidates": 64, "max_detections": 20,
                       "half": False},
         "tracking": {"bytetrack": {"max_tracks": 32}},
         "events": {"zones": ZONES, "alert": {"log_path": str(tmp_path / "ev.jsonl")}},
         "parallel": {"chunk_size": 4}, "visualization": {"enabled": False}}
    for k, v in over.items():
        o[k] = {**o.get(k, {}), **v}
    return Pipeline(load_config(overrides=o))


def _equal(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b))


def test_prepacked_chunks_give_bit_equal_tracks(tmp_path, frames):
    pipe = _pipe(tmp_path)
    (y, u, v), _ = yuv.pack_chunk(frames, 128)
    outs = {}
    for name, arg in (("planes", (y, u, v)), ("x6", yuv.planes_to_x6(y, u, v)),
                      ("x24", torch.from_numpy(yuv.planes_to_x24(y, u, v)))):
        pipe.reset()
        outs[name] = pipe.submit_packed_yuv(arg, H, W)
    assert int(outs["planes"][0].visible.sum()) > 0
    for name in ("x6", "x24"):
        assert _equal(outs[name][0], outs["planes"][0]) and _equal(outs[name][1],
                                                                    outs["planes"][1])
    msp = MultiStreamPipeline(pipe.cfg, num_streams=2, device="cpu")
    two = tuple(np.stack([p[:2], p[2:]], axis=1) for p in (y, u, v))      # (T=2, S=2, ...)
    got = {}
    for name, arg in (("planes", two), ("x6", yuv.planes_to_x6(*(p.reshape(4, *p.shape[2:])
                                                                 for p in two)))):
        msp.reset()
        if name == "x6":
            arg = arg.reshape(2, 2, *arg.shape[1:])
        got[name] = msp.submit_chunk_packed(arg, H, W)[0]
    assert _equal(got["x6"], got["planes"])


@pytest.mark.parametrize("transport,layout,match", [
    ("x6", "x24", "expects 6"),
    ("x24", "x6", "channels"),
    ("i420", "x6", "not s2d"),
    ("packed", "bad", "channels"),
])
def test_prepacked_layouts_the_transport_cannot_take_are_refused(tmp_path, frames, transport,
                                                                 layout, match):
    pipe = _pipe(tmp_path, parallel={"transport": transport})
    (y, u, v), _ = yuv.pack_chunk(frames, 128)
    x = {"x6": yuv.planes_to_x6, "x24": yuv.planes_to_x24}.get(
        layout, lambda *p: yuv.planes_to_x6(*p)[..., :5])(y, u, v)
    with pytest.raises(ValueError, match=match):
        pipe.submit_packed_yuv(x, H, W)


def _log(path) -> list[dict]:
    if not os.path.exists(path):
        return []
    rows = [json.loads(line) for line in open(path)]
    for r in rows:
        r.pop("timestamp_utc")
    return rows


def test_device_masks_and_s2d_transports_keep_the_event_log(tmp_path, clip):
    logs = {}
    for name, over in (("host", {}), ("masks", {"events": {"device_masks": True}}),
                       ("x6", {"parallel": {"transport": "x6"}}),
                       ("x24", {"parallel": {"transport": "x24"}})):
        log = tmp_path / f"{name}.jsonl"
        pipe = _pipe(tmp_path, **over)
        pipe.events.log_path = log
        assert (pipe._mask_polys is not None) == (name == "masks")
        seen = []
        inner = pipe.events.process_chunk

        def process_chunk(*args, inside=None, **kw):
            seen.append((args[2], inside))
            return inner(*args, inside=inside, **kw)

        pipe.events.process_chunk = process_chunk
        pipe.run_chunked(clip)
        logs[name] = _log(log)
        if name == "masks":
            polys = jnp.asarray(jax_pad_polygons([z["polygon"] for z in ZONES], 16))
            for boxes, inside in seen:
                assert inside is not None and inside.shape == (*boxes.shape[:2], len(ZONES))
                cents = (boxes[..., 0:2] + boxes[..., 2:4]) * 0.5
                want = np.asarray(jax_points_in_polygons(jnp.asarray(cents.reshape(-1, 2)), polys))
                np.testing.assert_array_equal(inside.reshape(-1, len(ZONES)), want)
    assert logs["host"]
    for name in ("masks", "x6", "x24"):
        assert logs[name] == logs["host"], name


def test_run_chunked_refuses_x24_pinned_on_a_geometry_it_cannot_block(tmp_path):
    pipe = _pipe(tmp_path, parallel={"transport": "x24"})
    frames = [np.zeros((300, 500, 3), np.uint8)] * 4
    with pytest.raises(ValueError, match="x24 pinned"):
        pipe.run_chunked(frames)


# -- transport: bgr ------------------------------------------------------------------

def _bgr_overrides(log: str) -> dict:
    return {"system": {"device": "cpu"},
            "detection": {"model": "yolov8s", "input_size": 256, "num_classes": 8,
                          "weights": WEIGHTS, "half": False},
            "events": {"zones": ZONES, "alert": {"log_path": log}},
            "profiling": {"per_stage": False, "warmup_frames": 0, "log_interval": 0},
            "parallel": {"chunk_size": 4, "transport": "bgr"},
            "visualization": {"enabled": False}}


def test_bgr_transport_equals_the_reference(tmp_path, clip, frames):
    ref = JaxPipeline(jax_load_config(overrides=_bgr_overrides(str(tmp_path / "jax.jsonl"))))
    port = Pipeline(load_config(overrides=_bgr_overrides(str(tmp_path / "port.jsonl"))))
    want, _ = ref.submit_chunk(frames)
    got, _ = port.submit_chunk(frames)
    want = jax.device_get(want)
    assert int(np.asarray(want.visible).sum()) > 0
    for field in ("track_id", "class_id", "visible", "age", "tsu"):
        np.testing.assert_array_equal(getattr(got, field).numpy(), np.asarray(getattr(want, field)))
    np.testing.assert_allclose(got.boxes.numpy(), np.asarray(want.boxes), rtol=0, atol=BOX_ATOL)

    ref.tracker.reset()
    port.reset()
    ref.run_chunked(clip)
    port.run_chunked(clip)
    got_log, want_log = _log(tmp_path / "port.jsonl"), _log(tmp_path / "jax.jsonl")
    assert want_log and len(got_log) == len(want_log)
    got_boxes = np.array([e.pop("bbox_xyxy") for e in got_log])
    want_boxes = np.array([e.pop("bbox_xyxy") for e in want_log])
    assert got_log == want_log
    np.testing.assert_allclose(got_boxes, want_boxes, rtol=0, atol=BOX_ATOL)
    assert port.events.zone_counts() == ref.events.zone_counts()
