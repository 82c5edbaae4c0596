"""The slice end to end: the port's ``Pipeline`` on the CPU against the JAX
composition of the same stages.

One synthetic clip (8 frames of 512x288, 2 chunks of 4, numpy-drawn) goes
through
  port: pack_chunk -> Pipeline.submit_packed_yuv / run_chunked
  JAX:  pack_chunk -> planar_letterbox -> apply -> batched_nms_from_logits ->
        unletterbox_boxes_packed -> bytetrack_update (sequential) ->
        ZoneEventEngine.process_chunk
with the repository's trained yolov8s weights (rich640d, 8 classes) at a
256 px input, in float32 with BN folded on both sides.  Per-frame track ids
and visibility must be identical, and so must the zone-event JSONL (less its
wall-clock ``timestamp_utc`` field) in every field but ``bbox_xyxy``, which
is held at 1e-4 px: box coordinates carry the DFL softmax's ulp-level
difference between the frameworks (see tests/test_torch_port_nms.py).

Trained weights, not random ones: random weights put ~40 heavily overlapping
boxes in every frame, and the DFL decode's softmax rounds an ulp differently
in XLA and PyTorch (box coordinates differ by up to 3e-5 px), which flips
near-tied greedy matches among those boxes.  The trackers themselves agree
exactly on identical detections (tests/test_torch_port_tracker.py).
"""

from __future__ import annotations

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rtmodt_tpu.config.loader import ByteTrackConfig as JaxByteTrackConfig
from rtmodt_tpu.config.loader import EventsConfig as JaxEventsConfig
from rtmodt_tpu.config.loader import _build as jax_build_cfg
from rtmodt_tpu.events.zone_engine import ZoneEventEngine as JaxZoneEventEngine
from rtmodt_tpu.models.weights import fuse_bn as jax_fuse_bn
from rtmodt_tpu.models.weights import load_npz as jax_load_npz
from rtmodt_tpu.models.yolov8 import build_model as jax_build
from rtmodt_tpu.ops.nms import batched_nms_from_logits as jax_nms
from rtmodt_tpu.ops.yuv import pack_chunk as jax_pack_chunk
from rtmodt_tpu.ops.yuv import packed_meta as jax_packed_meta
from rtmodt_tpu.ops.yuv import planar_letterbox as jax_planar_letterbox
from rtmodt_tpu.ops.yuv import unletterbox_boxes_packed as jax_unletterbox
from rtmodt_tpu.tracking.bytetrack import bytetrack_update as jax_update
from rtmodt_tpu.tracking.bytetrack import init_track_state as jax_init
from rtmodt_tpu_torch.config import load_config
from rtmodt_tpu_torch.ops import nms_kernel
from rtmodt_tpu_torch.ops.yuv import pack_chunk
from rtmodt_tpu_torch.runtime.pipeline import Pipeline
from rtmodt_tpu_torch.utils.synthetic import moving_boxes_frame
from tests.test_torch_port_threads import torch_threads  # noqa: F401 (autouse)

H, W, SIZE, K, N_FRAMES, FPS = 288, 512, 256, 4, 8, 30.0
CONF = 0.35
CLASSES = [0, 1, 2, 3, 5, 7]
WEIGHTS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "checkpoints", "rich640d", "ema_final.npz")


def _events_cfg(log_path: str) -> dict:
    return {
        "zones": [
            {"name": "left_half", "polygon": [[0, 0], [256, 0], [256, 288], [0, 288]],
             "trigger": "intrusion", "dwell_time_sec": 0.05, "cooldown_sec": 0.1},
            {"name": "gate", "polygon": [[120, 0], [512, 0], [512, 288], [120, 288]],
             "trigger": "crossing", "cooldown_sec": 1.0},
        ],
        "alert": {"backend": "json_file", "log_path": log_path},
    }


@pytest.fixture(scope="module")
def clip():
    return np.stack([moving_boxes_frame(t, H, W, 6, seed=1)[0] for t in range(N_FRAMES)])


@pytest.fixture(scope="module")
def weights():
    return WEIGHTS, jax_load_npz(WEIGHTS)


def _port_cfg(weights_path: str, log_path: str):
    return load_config(overrides={
        "detection": {"model": "yolov8s", "input_size": SIZE, "num_classes": 8,
                      "weights": weights_path, "conf_threshold": CONF, "half": False,
                      "classes": CLASSES},
        "events": _events_cfg(log_path),
        "parallel": {"chunk_size": K, "pipeline_depth": 1},
    })


@pytest.fixture(scope="module")
def jax_run(clip, weights, tmp_path_factory):
    """Per-frame (visible, track_id) and the event log of the JAX composition."""
    _, variables = weights
    model = jax_build("yolov8s", num_classes=8, dtype=jnp.float32, fused=True)
    params = jax_fuse_bn(jax.device_get(variables))
    mask = jnp.asarray(np.isin(np.arange(8), CLASSES))
    bt = JaxByteTrackConfig()
    geom = jax_packed_meta(H, W, SIZE)

    @jax.jit
    def detect(y, u, v):
        img = jax.vmap(lambda a, b, c: jax_planar_letterbox(
            a, b, c, SIZE, geom.pad_left, geom.pad_top, dtype=jnp.float32))(y, u, v)
        box_dist, cls = model.apply(params, img, train=False)
        res = jax.vmap(lambda bd, cl: jax_nms(bd, cl, SIZE, CONF, 0.45, 100, 300, mask))(
            box_dist, cls)
        return res._replace(boxes=jax_unletterbox(res.boxes, geom))

    log = str(tmp_path_factory.mktemp("ev") / "jax.jsonl")
    engine = JaxZoneEventEngine.from_config(
        jax_build_cfg(JaxEventsConfig, _events_cfg(log), "events"))
    step = jax.jit(functools.partial(jax_update, cfg=bt))
    state = jax_init(bt.max_tracks)
    frames = []
    for c0 in range(0, N_FRAMES, K):
        (y, u, v), _ = jax_pack_chunk(clip[c0:c0 + K], SIZE)
        res = detect(jnp.asarray(y), jnp.asarray(u), jnp.asarray(v))
        outs = []
        for i in range(K):
            state, o = step(state, res.boxes[i], res.scores[i], res.classes[i], res.valid[i])
            outs.append(jax.device_get(o))
        frames += [(np.asarray(o.visible), np.asarray(o.track_id)) for o in outs]
        stack = lambda f: np.stack([getattr(o, f) for o in outs])  # noqa: E731
        engine.process_chunk(stack("track_id"), stack("class_id"), stack("boxes"),
                             stack("visible"), list(range(c0 + 1, c0 + K + 1)),
                             np.arange(c0, c0 + K, dtype=np.float64) / FPS,
                             class_names=None)
    return frames, log


def _events(path: str) -> list[dict]:
    with open(path) as f:
        out = [json.loads(line) for line in f]
    for e in out:
        e.pop("timestamp_utc")
        e["class_name"] = ""        # the reference's bare engine carries no names
    return out


def test_track_ids_match_jax_composition(clip, weights, jax_run, tmp_path):
    pipe = Pipeline(_port_cfg(weights[0], str(tmp_path / "ev.jsonl")), device="cpu")
    want, _ = jax_run
    got = []
    for c0 in range(0, N_FRAMES, K):
        planes, _ = pack_chunk(clip[c0:c0 + K], SIZE)
        outs, _ = pipe.submit_packed_yuv(planes, H, W)
        got += [(outs.visible[i].numpy(), outs.track_id[i].numpy()) for i in range(K)]
    assert pipe.chunks_submitted == N_FRAMES // K
    n_visible = 0
    for (gv, gid), (wv, wid) in zip(got, want):
        np.testing.assert_array_equal(gv, wv)
        np.testing.assert_array_equal(gid[gv], wid[wv])
        n_visible += int(gv.sum())
    assert n_visible > 0


def test_event_log_matches_jax_composition(clip, weights, jax_run, tmp_path):
    log = str(tmp_path / "port.jsonl")
    pipe = Pipeline(_port_cfg(weights[0], log), device="cpu")
    before = nms_kernel.launches
    summary = pipe.run_chunked(list(clip), fps=FPS)
    assert summary["frames"] == N_FRAMES and summary["chunks"] == N_FRAMES // K
    assert nms_kernel.launches == before            # the CPU runs the plain version
    got, want = _events(log), _events(jax_run[1])
    assert len(want) > 0 and len(got) == len(want)
    got_boxes = np.array([e.pop("bbox_xyxy") for e in got])
    want_boxes = np.array([e.pop("bbox_xyxy") for e in want])
    assert got == want
    np.testing.assert_allclose(got_boxes, want_boxes, rtol=0, atol=1e-4)


def test_run_chunked_pads_the_tail_chunk(clip, weights, tmp_path):
    pipe = Pipeline(_port_cfg(weights[0], str(tmp_path / "ev.jsonl")), device="cpu")
    summary = pipe.run_chunked(iter(clip[:6]), fps=FPS)
    assert summary["frames"] == 6 and summary["chunks"] == 2
    summary = pipe.run_chunked(iter(clip), max_frames=3)
    assert summary["frames"] == 3 and summary["chunks"] == 1
    assert pipe.chunks_submitted == 3
