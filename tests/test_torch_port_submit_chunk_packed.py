"""``Pipeline.submit_chunk_packed`` of the port against the JAX package.

  * The planes it submits are byte-equal to the JAX ``pack_i420_planar`` of
    each frame, one frame at a time, at 720p (the native packer's exact
    downsamples) and at 481x853 (cv2), at 640 and 256 px: the whole-chunk
    ``pack_chunk`` dispatches as the per-frame packer does.
  * Its tracks and detections equal ``submit_packed_yuv`` on those planes
    bit for bit (rich640d at 256 px, float32, on the CPU), chunk after chunk.
  * It refuses the host LAPJV tracker, as ``submit_chunk`` does.
"""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

from rtmodt_tpu.ops.yuv import pack_i420_planar as jax_pack_i420_planar
from rtmodt_tpu_torch.config import load_config
from rtmodt_tpu_torch.ops.yuv import pack_chunk
from rtmodt_tpu_torch.runtime.pipeline import Pipeline
from rtmodt_tpu_torch.utils.synthetic import moving_boxes_frame
from tests.test_torch_port_threads import torch_threads  # noqa: F401 (autouse)

K = 4
GEOMETRIES = [(720, 1280), (481, 853)]
WEIGHTS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "checkpoints", "rich640d", "ema_final.npz")


def _frames(h: int, w: int, t0: int = 0, noise: int = 24) -> np.ndarray:
    """K frames of moving rectangles with seeded noise on every pixel."""
    rng = np.random.default_rng(h * w + t0)
    out = []
    for t in range(t0, t0 + K):
        f = moving_boxes_frame(t, h, w, 6, seed=2)[0].astype(np.int16)
        f += rng.integers(-noise, noise + 1, f.shape, dtype=np.int16)
        out.append(np.clip(f, 0, 255).astype(np.uint8))
    return np.stack(out)


def _pipeline(size: int, **detection) -> Pipeline:
    return Pipeline(load_config(overrides={
        "system": {"device": "cpu"},
        "detection": {"model": "yolov8n", "input_size": size, **detection},
        "events": {"enabled": False}, "visualization": {"enabled": False},
        "parallel": {"chunk_size": K}}))


@pytest.mark.parametrize("size", [640, 256])
@pytest.mark.parametrize("hw", GEOMETRIES, ids=["720p", "481x853"])
def test_planes_equal_the_reference_per_frame_packer(hw, size, monkeypatch):
    h, w = hw
    frames = _frames(h, w)
    pipe = _pipeline(size)
    seen = []
    monkeypatch.setattr(pipe, "submit_packed_yuv",
                        lambda planes, src_h, src_w: seen.append((planes, src_h, src_w)))
    pipe.submit_chunk_packed(frames)
    (planes, src_h, src_w), = seen
    assert (src_h, src_w) == (h, w)
    for i in range(K):
        want, _ = jax_pack_i420_planar(frames[i], size)
        for got_p, want_p in zip(planes, want):
            assert got_p[i].dtype == np.uint8
            np.testing.assert_array_equal(got_p[i], want_p)


@pytest.fixture(scope="module")
def rich():
    return _pipeline(256, model="yolov8s", num_classes=8, weights=WEIGHTS, half=False,
                     conf_threshold=0.35)


@pytest.mark.parametrize("hw", GEOMETRIES, ids=["720p", "481x853"])
def test_tracks_equal_submit_packed_yuv(rich, hw):
    h, w = hw

    def two_chunks(submit):             # the second chunk tracks on from the first
        rich.reset()
        return [submit(_frames(h, w, t0, noise=4)) for t0 in (0, K)]

    got = two_chunks(rich.submit_chunk_packed)
    want = two_chunks(lambda frames: rich.submit_packed_yuv(pack_chunk(frames, 256)[0], h, w))
    for g_chunk, w_chunk in zip(got, want):
        for g, w_ in zip(g_chunk, w_chunk):           # TrackOutputs, NMSResult
            for name, a, b in zip(g._fields, g, w_):
                assert torch.equal(a, b), name
    assert int(got[-1][0].visible[-1].sum()) >= 3    # the trained model tracks the boxes


def test_refuses_the_host_tracker():
    pipe = Pipeline(load_config(overrides={
        "system": {"device": "cpu"}, "detection": {"model": "yolov8n", "input_size": 128},
        "tracking": {"bytetrack": {"assignment": "lapjv"}},
        "events": {"enabled": False}, "visualization": {"enabled": False}}))
    with pytest.raises(ValueError, match="submit_chunk_packed"):
        pipe.submit_chunk_packed(_frames(144, 256))
