"""S camera streams split over CPU ranks (``MultiStreamPipeline`` with a
``parallel/mesh.py`` mesh) against one process, and their snapshots.

Four 25-fps clips of 512x288 (16 frames; the third 8, so that it ends
early) at S = 4, T = 4 with yolov8n at 128 px (seeded weights, conf 0.01,
float32), zone events on.  Two ranks of two streams each against one
process of four:

  * ``submit_chunk_packed`` on packed chunks: rank r gives streams [2r, 2r +
    2) of the one-process outputs: identical visibility and track ids,
    boxes within 1e-4 px (the same code on a batch of 8 frames instead of
    16);
  * ``run``: every stream's events (each rank appends its own streams' lines
    to the one log; compared as sets less ``timestamp_utc``, ``bbox_xyxy``
    within 1e-4 px), ``zone_counts``, ``per_stream_frames`` and
    ``dead_streams`` gathered to rank 0, the ended stream fed blanks until
    the last one ends, as in one process;
  * a snapshot written by the two ranks half-way (one file, the format of
    one process) resumed by one process, and the other way round: the
    uninterrupted run's events; the JAX package loads the two ranks'
    snapshot into its own ``MultiStreamPipeline``.
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from rtmodt_tpu.config.loader import load_config as jax_load_config
from rtmodt_tpu.parallel.multistream import MultiStreamPipeline as JaxMultiStream
from rtmodt_tpu.runtime.state_store import load_multistream_snapshot as jax_load_snapshot
from rtmodt_tpu_torch.config import load_config
from rtmodt_tpu_torch.ops.yuv import pack_chunk
from rtmodt_tpu_torch.parallel import mesh as M
from rtmodt_tpu_torch.parallel.multistream import MultiStreamPipeline
from rtmodt_tpu_torch.parallel.ranks import multistream_chunks, multistream_run
from rtmodt_tpu_torch.models.weights import save_npz
from rtmodt_tpu_torch.models.yolov8 import build_model, init_params
from rtmodt_tpu_torch.utils.synthetic import moving_boxes_frame, write_synthetic_video
from tests.test_torch_port_threads import torch_threads  # noqa: F401 (autouse)

H, W, SIZE, T, N, S = 288, 512, 128, 4, 16, 4
BOX_ATOL = 1e-4


def overrides(log: str | None) -> dict:
    return {
        "system": {"device": "cpu"},
        "ingestion": {"max_reconnects": 0},
        "detection": {"model": "yolov8n", "input_size": SIZE, "conf_threshold": 0.01,
                      "classes": None, "nms_candidates": 64, "max_detections": 20,
                      "half": False},
        "events": ({"zones": [
            {"name": "left_half", "polygon": [[0, 0], [256, 0], [256, 288], [0, 288]],
             "trigger": "intrusion", "dwell_time_sec": 0.12, "cooldown_sec": 0.2},
            {"name": "gate", "polygon": [[120, 0], [512, 0], [512, 288], [120, 288]],
             "trigger": "crossing", "cooldown_sec": 1.0}],
            "alert": {"backend": "json_file", "log_path": log}} if log else {"enabled": False}),
        "parallel": {"chunk_size": T, "pipeline_depth": 1},
        "visualization": {"enabled": False},
    }


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    d = tmp_path_factory.mktemp("clips")
    out = []
    for i, n in enumerate((N, N, N // 2, N)):
        path = str(d / f"cam{i}.mp4")
        write_synthetic_video(path, frames=n, h=H, w=W, n_objects=6, fps=25.0, seed=1 + i)
        out.append(path)
    return out


def two_ranks():
    return M.create_mesh(devices=["cpu", "cpu"])


def logged(path: str) -> tuple[list, np.ndarray]:
    """The log's events less ``timestamp_utc``, sorted; their boxes apart."""
    rows = [json.loads(line) for line in open(path)]
    for r in rows:
        r.pop("timestamp_utc")
    rows.sort(key=lambda r: json.dumps({k: v for k, v in r.items() if k != "bbox_xyxy"},
                                       sort_keys=True))
    return [{k: v for k, v in r.items() if k != "bbox_xyxy"} for r in rows], \
        np.array([r["bbox_xyxy"] for r in rows])


def assert_same_log(got: str, want: str) -> None:
    got_events, got_boxes = logged(got)
    want_events, want_boxes = logged(want)
    assert got_events == want_events and want_events
    np.testing.assert_allclose(got_boxes, want_boxes, rtol=0, atol=BOX_ATOL)


def one_process(log: str | None, sources: list, **kw) -> dict:
    return MultiStreamPipeline(load_config(overrides=overrides(log)), num_streams=S,
                               device="cpu").run(sources, chunk_size=T, **kw)


def ranks(log: str, sources: list, **kw) -> dict:
    out = M.spawn(multistream_run, two_ranks(), load_config(overrides=overrides(log)),
                  sources, {"chunk_size": T, **kw}, timeout=240)
    assert out[1]["summary"] is None
    return out[0]["summary"]


def test_chunks_split_over_two_ranks_equal_one_process():
    frames = np.stack([np.stack([moving_boxes_frame(t + 5 * s, H, W, 6, seed=s + 1)[0]
                                 for s in range(S)]) for t in range(2 * T)])
    chunks = []
    for c in range(2):
        block = frames[c * T:(c + 1) * T]
        planes, _ = pack_chunk(block.reshape(T * S, H, W, 3), SIZE)
        chunks.append(tuple(p.reshape(T, S, *p.shape[1:]) for p in planes))
    cfg = load_config(overrides=overrides(None))
    msp = MultiStreamPipeline(cfg, num_streams=S, device="cpu")
    want = [msp.submit_chunk_packed(planes, H, W) for planes in chunks]
    out = M.spawn(multistream_chunks, two_ranks(), cfg, S, chunks, (H, W), timeout=240)
    assert [r["streams"] for r in out] == [(0, 2), (2, 4)]
    for r in out:
        lo, hi = r["streams"]
        for got, (tracks, dets) in zip(r["outs"], want):
            vis = tracks.visible[:, lo:hi].numpy()
            np.testing.assert_array_equal(got["tracks"]["visible"], vis)
            np.testing.assert_array_equal(got["tracks"]["track_id"][vis],
                                          tracks.track_id[:, lo:hi].numpy()[vis])
            np.testing.assert_allclose(got["tracks"]["boxes"][vis],
                                       tracks.boxes[:, lo:hi].numpy()[vis], rtol=0,
                                       atol=BOX_ATOL)
            valid = dets.valid[:, lo:hi].numpy()
            np.testing.assert_array_equal(got["detections"]["valid"], valid)
            assert valid.any() and vis.any()


def test_run_over_two_ranks_equals_one_process(clips, tmp_path):
    want_log, got_log = str(tmp_path / "one.jsonl"), str(tmp_path / "two.jsonl")
    want = one_process(want_log, clips)
    got = ranks(got_log, clips)
    assert want["per_stream_frames"] == [N, N, N // 2, N] == got["per_stream_frames"]
    assert got["dead_streams"] == want["dead_streams"] == [0, 1, 2, 3]
    assert got["frames"] == want["frames"] and got["streams"] == S
    assert got["zone_counts"] == want["zone_counts"]
    assert_same_log(got_log, want_log)
    streams = {json.loads(line)["metadata"]["stream"] for line in open(got_log)}
    assert streams == {0, 1, 2, 3}


@pytest.mark.parametrize("first", ["ranks", "one"])
def test_snapshots_cross_rank_counts(clips, tmp_path, first):
    want_log = str(tmp_path / "whole.jsonl")
    want = one_process(want_log, clips)
    log, snap = str(tmp_path / "cut.jsonl"), str(tmp_path / "s.npz")
    runners = [ranks, one_process] if first == "ranks" else [one_process, ranks]
    half = runners[0](log, clips, max_frames=N // 2, state_path=snap, state_interval=8)
    assert half["per_stream_frames"] == [N // 2] * S
    with np.load(snap) as z:
        meta = json.loads(str(z["meta"]))
        assert meta["num_streams"] == S and len(meta["engines"]) == S
        assert all(z[k].shape[0] == S for k in z.files if k != "meta")
    got = runners[1](log, clips, state_path=snap)
    assert got["per_stream_frames"] == want["per_stream_frames"]
    assert got["zone_counts"] == want["zone_counts"]
    assert_same_log(log, want_log)
    if first == "ranks":
        # the two ranks' snapshot in the JAX package (written again at clean exit
        # by the one-process run: take the half-way one again)
        ranks(str(tmp_path / "again.jsonl"), clips, max_frames=N // 2,
              state_path=str(tmp_path / "r.npz"))
        # weights for the JAX detector: its random init compiles flax's init
        weights = str(tmp_path / "seeded.npz")
        save_npz(init_params(build_model("yolov8n", 80), torch.Generator().manual_seed(0)),
                 weights)
        over = overrides(None)
        over["detection"]["weights"] = weights
        ref = JaxMultiStream(jax_load_config(overrides=over), num_streams=S)
        meta = jax_load_snapshot(str(tmp_path / "r.npz"), ref)
        assert meta["per_stream_frames"] == [N // 2] * S
        with np.load(str(tmp_path / "r.npz")) as z:
            for k, v in ref.state._asdict().items():
                np.testing.assert_array_equal(np.asarray(v), z[f"tracker/{k}"], err_msg=k)
