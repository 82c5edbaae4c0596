"""S = 4 streams split over 4 CPU ranks of the port against the JAX
package's ``MultiStreamPipeline`` on ``create_mesh(4)`` (the conftest's
virtual CPU devices: the stream axis sharded over 4 devices, one SPMD
program), on the same packed I420 chunks: two chunks of T = 4 frames of
512x288 scenes, the trained rich640d weights at 256 px in float32.

The JAX chunk program's space-to-depth front is replaced, for this module
only, by ``planar_letterbox`` and the forward (as in
tests/test_torch_port_multistream_resume_cross.py), so that both compute
the same detections.  Every rank's streams: identical detection validity
and track visibility and ids, boxes within 1e-4 px (the DFL softmax's
ulp-level difference between the frameworks).
"""

from __future__ import annotations

import os

import numpy as np
import pytest

from rtmodt_tpu.config.loader import load_config as jax_load_config
from rtmodt_tpu.parallel.mesh import create_mesh as jax_create_mesh
from rtmodt_tpu.parallel.multistream import MultiStreamPipeline as JaxMultiStream
from rtmodt_tpu_torch.config import load_config
from rtmodt_tpu_torch.ops.yuv import pack_chunk
from rtmodt_tpu_torch.parallel import mesh as M
from rtmodt_tpu_torch.parallel.ranks import multistream_chunks
from rtmodt_tpu_torch.utils.synthetic import moving_boxes_frame
from tests.test_torch_port_multistream_resume_cross import planar_jax_front  # noqa: F401
from tests.test_torch_port_threads import torch_threads  # noqa: F401 (autouse)

H, W, SIZE, T, S = 288, 512, 256, 4, 4
BOX_ATOL = 1e-4
WEIGHTS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "checkpoints", "rich640d", "ema_final.npz")


def overrides() -> dict:
    return {
        "system": {"device": "cpu"},
        "detection": {"model": "yolov8s", "input_size": SIZE, "num_classes": 8,
                      "weights": WEIGHTS, "half": False},
        "events": {"enabled": False},
        "profiling": {"per_stage": False, "log_interval": 0},
        "parallel": {"chunk_size": T, "transport": "i420", "num_streams": S},
        "visualization": {"enabled": False},
    }


@pytest.fixture(scope="module")
def chunks():
    frames = np.stack([np.stack([moving_boxes_frame(t + 5 * s, H, W, 6, seed=s + 1)[0]
                                 for s in range(S)]) for t in range(2 * T)])
    out = []
    for c in range(2):
        planes, _ = pack_chunk(frames[c * T:(c + 1) * T].reshape(T * S, H, W, 3), SIZE)
        out.append(tuple(p.reshape(T, S, *p.shape[1:]) for p in planes))
    return out


def test_four_ranks_equal_the_jax_program_sharded_over_four_devices(chunks):
    ref = JaxMultiStream(jax_load_config(overrides=overrides()), num_streams=S,
                         mesh=jax_create_mesh(4))
    want = []
    for planes in chunks:
        outs, res = ref.submit_chunk_packed(planes, H, W)
        want.append(({k: np.asarray(v) for k, v in outs._asdict().items()},
                     {k: np.asarray(v) for k, v in res._asdict().items()}))
    assert len(ref.state.boxes.sharding.device_set) == 4
    out = M.spawn(multistream_chunks, M.create_mesh(devices=["cpu"] * 4),
                  load_config(overrides=overrides()), S, chunks, (H, W), timeout=300)
    assert [r["streams"] for r in out] == [(s, s + 1) for s in range(S)]
    for r in out:
        lo, hi = r["streams"]
        for got, (tracks, dets) in zip(r["outs"], want):
            valid = dets["valid"][:, lo:hi]
            np.testing.assert_array_equal(got["detections"]["valid"], valid)
            np.testing.assert_allclose(got["detections"]["boxes"][valid],
                                       dets["boxes"][:, lo:hi][valid], rtol=0, atol=BOX_ATOL)
            vis = tracks["visible"][:, lo:hi]
            np.testing.assert_array_equal(got["tracks"]["visible"], vis)
            np.testing.assert_array_equal(got["tracks"]["track_id"][vis],
                                          tracks["track_id"][:, lo:hi][vis])
            np.testing.assert_allclose(got["tracks"]["boxes"][vis],
                                       tracks["boxes"][:, lo:hi][vis], rtol=0, atol=BOX_ATOL)
            assert valid.any() and vis.any()
