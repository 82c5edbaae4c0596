"""Multi-stream kill-and-resume snapshots across the two packages.

Two 25-fps clips (16 frames of 512x288 each) run at S = 2, T = 4 through
``MultiStreamPipeline.run`` of both packages with the trained rich640d
weights at 256 px in float32, planar I420 and zone events on.  The JAX chunk
program's space-to-depth front is replaced, for this module only, by
``planar_letterbox`` and the forward, as in
tests/test_torch_port_resume_chunked.py, so that both packages compute the
same detections and only the loops and their snapshots are compared.

A JAX snapshot taken half-way and resumed by the port, and a port snapshot
taken half-way and resumed by the JAX package, must each write the JAX
uninterrupted run's event log for both streams (less the wall-clock
``timestamp_utc``, ``bbox_xyxy`` within 1e-4 px) and its ``zone_counts``:
for ByteTrack, and for OC-SORT + GMC, whose per-stream states and GMC
carries the port stacks into the reference's S-leading arrays.
"""

from __future__ import annotations

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rtmodt_tpu.ops.s2d_front as jax_s2d_front
from rtmodt_tpu.config.loader import load_config as jax_load_config
from rtmodt_tpu.ops.yuv import content_dims as jax_content_dims
from rtmodt_tpu.ops.yuv import pack_chunk as jax_pack_chunk
from rtmodt_tpu.ops.yuv import packed_meta as jax_packed_meta
from rtmodt_tpu.ops.yuv import planar_letterbox as jax_planar_letterbox
from rtmodt_tpu.parallel.multistream import MultiStreamPipeline as JaxMultiStream
from rtmodt_tpu_torch.config import load_config
from rtmodt_tpu_torch.parallel.multistream import MultiStreamPipeline
from rtmodt_tpu_torch.utils.synthetic import write_synthetic_video

H, W, SIZE, T, N, FPS = 288, 512, 256, 4, 16, 25.0
BOX_ATOL = 1e-4
WEIGHTS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "checkpoints", "rich640d", "ema_final.npz")


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads while this module runs: the suite runs several
    workers on one host, and models at this size gain little from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def overrides(log: str, tracking: dict) -> dict:
    """Config shared by both packages' loaders (``transport: i420`` keeps the
    JAX chunk program on planes)."""
    return {
        "system": {"device": "cpu"},
        "ingestion": {"max_reconnects": 0},
        "detection": {"model": "yolov8s", "input_size": SIZE, "num_classes": 8,
                      "weights": WEIGHTS, "half": False},
        "tracking": tracking,
        "events": {"zones": [
            {"name": "left_half", "polygon": [[0, 0], [256, 0], [256, 288], [0, 288]],
             "trigger": "intrusion", "dwell_time_sec": 0.12, "cooldown_sec": 0.2},
            {"name": "gate", "polygon": [[120, 0], [512, 0], [512, 288], [120, 288]],
             "trigger": "crossing", "cooldown_sec": 1.0}],
            "alert": {"backend": "json_file", "log_path": log}},
        "profiling": {"per_stage": False, "log_interval": 0},
        "parallel": {"chunk_size": T, "pipeline_depth": 1, "transport": "i420"},
        "visualization": {"enabled": False},
    }


@pytest.fixture(scope="module", autouse=True)
def jax_packer_built():
    """Pack one frame through the JAX package on this thread first.  Its
    native packer is built on first use, and while one ingest thread builds
    it the other stream's thread packs with cv2 (in a fresh checkout the
    first multi-stream run would then mix the two packers); after this every
    JAX run packs as the port's loop does."""
    jax_pack_chunk(np.zeros((1, H, W, 3), np.uint8), SIZE)


@pytest.fixture(scope="module", autouse=True)
def planar_jax_front():
    geom = jax_packed_meta(H, W, SIZE)
    ch, cw = jax_content_dims(H, W, SIZE)
    t, le = geom.pad_top, geom.pad_left

    def apply_front(params, model, yp, up, vp, quant, dtype=jnp.bfloat16):
        y = yp[:, t:t + ch, le:le + cw]
        u = up[:, t // 2:(t + ch) // 2, le // 2:(le + cw) // 2]
        v = vp[:, t // 2:(t + ch) // 2, le // 2:(le + cw) // 2]
        img = jax.vmap(lambda a, b, c: jax_planar_letterbox(a, b, c, SIZE, le, t,
                                                            dtype=dtype))(y, u, v)
        return model.apply(params, img, train=False)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_s2d_front, "apply_front", apply_front)
        yield


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    d = tmp_path_factory.mktemp("clips")
    out = []
    for i in range(2):
        path = str(d / f"cam{i}.mp4")
        write_synthetic_video(path, frames=N, h=H, w=W, n_objects=6, fps=FPS, seed=1 + i)
        out.append(path)
    return out


def run_in(package: str, log: str, sources: list, tracking: dict, **kw) -> dict:
    over = overrides(log, tracking)
    if package == "jax":
        pipe = JaxMultiStream(jax_load_config(overrides=over), num_streams=len(sources))
    else:
        pipe = MultiStreamPipeline(load_config(overrides=over), num_streams=len(sources),
                                   device="cpu")
    return pipe.run(sources, chunk_size=T, **kw)


def logged(path: str) -> tuple[list[dict], np.ndarray]:
    """The log's events less ``timestamp_utc`` and ``bbox_xyxy``, and the
    boxes apart."""
    rows = [json.loads(line) for line in open(path)]
    for r in rows:
        r.pop("timestamp_utc")
    return rows, np.array([r.pop("bbox_xyxy") for r in rows])


@pytest.mark.parametrize("tracking", [
    {}, {"algorithm": "ocsort", "gmc": {"method": "phase"},
         "ocsort": {"det_thresh": 0.3, "min_hits": 1}}], ids=["bytetrack", "ocsort_gmc"])
def test_snapshots_cross_between_the_packages(clips, tmp_path, tracking):
    want_log = str(tmp_path / "jax_whole.jsonl")
    want = run_in("jax", want_log, clips, tracking)
    want_events, want_boxes = logged(want_log)
    assert want["per_stream_frames"] == [N, N]
    assert {e["metadata"]["stream"] for e in want_events} == {0, 1}
    for first, then in (("jax", "port"), ("port", "jax")):
        log, snap = str(tmp_path / f"{first}_{then}.jsonl"), str(tmp_path / f"{first}.npz")
        half = run_in(first, log, clips, tracking, max_frames=N // 2, state_path=snap)
        assert half["per_stream_frames"] == [N // 2] * 2
        got = run_in(then, log, clips, tracking, state_path=snap)
        assert got["per_stream_frames"] == [N, N], (first, then)
        got_events, got_boxes = logged(log)
        assert got_events == want_events, (first, then)
        np.testing.assert_allclose(got_boxes, want_boxes, rtol=0, atol=BOX_ATOL)
        assert got["zone_counts"] == want["zone_counts"], (first, then)
