"""int8 on the pipelines and the several-stream runner, on the CPU.

  * ``Pipeline.run_chunked`` with ``detection.quant: int8`` (rich640d
    ``qat_final.npz`` with its frozen ``qat_act_scales.npz`` at 256 px,
    float32, zone events on) against the JAX ``run_chunked`` on the same
    clip, with the JAX chunk program's front replaced by ``planar_letterbox``
    and the forward as in tests/test_torch_port_resume_chunked.py: every
    chunk's visible track ids equal, and the event logs equal less the
    wall-clock ``timestamp_utc``, ``bbox_xyxy`` within the int8 bar of
    tests/test_torch_port_quant.py (0.8 px).  The JAX program is jitted,
    where XLA fuses the requantization's multiply-add into one rounding; the
    port rounds twice, as the op-by-op reference does, so an int8 rounding
    may flip between them (measured here: event boxes 0.043 px apart);
  * ``MultiStreamPipeline.submit_chunk_packed`` with int8 at S = 2: each
    stream equals the single-stream int8 ``submit_packed_yuv`` on its frames.
"""

from __future__ import annotations

import os

import numpy as np

from rtmodt_tpu.config.loader import load_config as jax_load_config
from rtmodt_tpu.runtime.pipeline import Pipeline as JaxPipeline
from rtmodt_tpu_torch.config import load_config
from rtmodt_tpu_torch.parallel.multistream import MultiStreamPipeline
from rtmodt_tpu_torch.quant.ptq import QuantizedConvBN
from rtmodt_tpu_torch.runtime.pipeline import Pipeline
from tests.test_torch_port_multistream import (S, _multi_outputs, _packed,
                                               _single_stream_outputs, assert_same_outputs,
                                               stream_frames)
from tests.test_torch_port_multistream import overrides as multi_overrides
from tests.test_torch_port_resume_chunked import clip, events, planar_jax_front  # noqa: F401
from tests.test_torch_port_resume_chunked import overrides as chunked_overrides
from tests.test_torch_port_threads import torch_threads  # noqa: F401 (autouse)

CKPT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "checkpoints", "rich640d")
INT8 = {"weights": os.path.join(CKPT, "qat_final.npz"), "quant": "int8",
        "quant_scales": os.path.join(CKPT, "qat_act_scales.npz")}
BOX_TOL = 0.8       # px, tests/test_torch_port_quant.py


def int8_overrides(over: dict) -> dict:
    return {**over, "detection": {**over["detection"], **INT8}}


def visible_ids(pipe_or_tracker, into: list) -> None:
    """Record each chunk's visible track ids (K, S) as the chunk is consumed."""
    inner = pipe_or_tracker.step

    def step(*a, **kw):
        out = inner(*a, **kw)
        into.append(np.where(out.visible.cpu().numpy(), out.track_id.cpu().numpy(), 0))
        return out

    pipe_or_tracker.step = step


def test_run_chunked_int8_matches_the_jax_run_chunked(clip, tmp_path):  # noqa: F811
    jax_log, port_log = str(tmp_path / "jax.jsonl"), str(tmp_path / "port.jsonl")
    ref = JaxPipeline(jax_load_config(overrides=int8_overrides(chunked_overrides(jax_log))))
    ref.run_chunked(clip)
    want_counts = ref.events.zone_counts()

    pipe = Pipeline(load_config(overrides=int8_overrides(chunked_overrides(port_log))))
    assert sum(isinstance(m, QuantizedConvBN) for m in pipe.detector.model.modules()) == 56
    got_ids: list = []
    visible_ids(pipe.tracker, got_ids)
    summary = pipe.run_chunked(clip)
    assert summary["frames"] == 16

    got, want = events(port_log), events(jax_log)
    assert len(want) > 0 and len(got) == len(want)
    got_boxes = np.array([e.pop("bbox_xyxy") for e in got])
    want_boxes = np.array([e.pop("bbox_xyxy") for e in want])
    assert got == want                                   # ids, zones, frames, dwell
    np.testing.assert_allclose(got_boxes, want_boxes, rtol=0, atol=BOX_TOL)
    assert pipe.events.zone_counts() == want_counts
    # the tracker saw the same visible ids on every frame as the reference's
    st, rst = pipe.tracker.state, ref.tracker.state
    np.testing.assert_array_equal(st.active.numpy(), np.asarray(rst.active))
    np.testing.assert_array_equal(st.track_id.numpy()[st.active.numpy()],
                                  np.asarray(rst.track_id)[np.asarray(rst.active)])
    assert int(st.next_id) == int(rst.next_id) and np.concatenate(got_ids).any()


def test_multistream_int8_equals_single_stream():
    cfg = load_config(overrides=int8_overrides(multi_overrides()))
    msp = MultiStreamPipeline(cfg, num_streams=S)
    assert any(isinstance(m, QuantizedConvBN) for m in msp.detector.model.modules())
    planes = _packed(stream_frames(4))
    got = _multi_outputs(msp, planes, t=2)
    for si in range(S):
        want = _single_stream_outputs(cfg, planes, si, t=2)
        assert_same_outputs(type(want)(*(x[:, si] for x in got)), want)
        assert int(want.visible.sum()) > 4
