"""The comparison that decides ``correct``, driven through a whole run of a
CPU-sized cell (the harness's look for a card skipped): a sound run is
correct; the control and each fault a cell can have on one card are not."""

from __future__ import annotations

import time

import pytest
import torch

from perfbench import bench, control
from perfbench.tests.helpers import tiny_root


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root(str(tmp_path_factory.mktemp("perfbench")))


@pytest.fixture(autouse=True)
def threads():
    n = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(n)


def _run(root, hooks=None):
    args = bench.parse_args(["--workload", "tiny", "--seed", "3000000007", "--seconds", "2",
                             "--trace", "0"])
    return bench.run(args, time.perf_counter(), root, device="cpu", hooks=hooks)


def _failed(res):
    return {k for k, v in res["checks"].items() if v["value"] > v["limit"]}


def test_sound_run_is_correct(root):
    res = _run(root)
    assert res["correct"], res["checks"]
    assert res["metrics"]["fps"]["value"] > 0


def test_state_left_unchanged_fails(root):
    def hook(pipe, pool):
        step = pipe.tracker.step

        def frozen(*a, **k):
            before = pipe.tracker.state
            out = step(*a, **k)
            pipe.tracker.state = before
            return out

        pipe.tracker.step = frozen

    res = _run(root, {"pipeline": hook})
    assert not res["correct"] and "track_mismatch" in _failed(res)


def test_half_the_batch_left_out_fails(root):
    def hook(pipe, pool):
        detect = pipe._pipe.packed_detect

        def half(planes, h, w):
            res, feats, grids, scale = detect(planes, h, w)
            n = res.boxes.shape[0] // 2
            res = type(res)(*(torch.cat([x[:n], x[:n]])[:x.shape[0]] for x in res))
            return res, feats, grids, scale

        pipe._pipe.packed_detect = half

    res = _run(root, {"pipeline": hook})
    assert not res["correct"] and "det_unmatched_pct" in _failed(res)


def test_detection_altered_where_produced_fails(root, monkeypatch):
    import rtmodt_tpu_torch.runtime.pipeline as pl

    nms = pl.batched_nms_from_logits

    def shifted(*a, **k):
        res = nms(*a, **k)
        boxes = res.boxes.clone()
        boxes[:, 0] += 4.0
        return res._replace(boxes=boxes)

    monkeypatch.setattr(pl, "batched_nms_from_logits", shifted)
    res = _run(root)
    assert not res["correct"] and "det_box_gap_mean_px" in _failed(res)


def test_detections_emitted_twice_fail(root, monkeypatch):
    """Every detection of K1's output emitted twice: the extra rows match
    nothing one to one and overlap their twins."""
    import rtmodt_tpu_torch.runtime.pipeline as pl

    nms = pl.batched_nms_from_logits

    def twice(*a, **k):
        res = nms(*a, **k)
        idx = torch.arange(res.boxes.shape[1], device=res.boxes.device) // 2
        return res._replace(boxes=res.boxes[:, idx], scores=res.scores[:, idx],
                            classes=res.classes[:, idx], valid=res.valid[:, idx],
                            count=res.valid[:, idx].sum(dim=1).to(res.count.dtype))

    monkeypatch.setattr(pl, "batched_nms_from_logits", twice)
    res = _run(root)
    assert not res["correct"]
    assert {"det_unmatched_pct", "det_overlap_pairs"} <= _failed(res)


def test_event_altered_where_produced_fails(root, monkeypatch):
    from rtmodt_tpu_torch.events.zone_engine import ZoneEventEngine

    process = ZoneEventEngine.process_chunk

    def drop_first(self, *a, **k):
        return process(self, *a, **k)[1:]

    monkeypatch.setattr(ZoneEventEngine, "process_chunk", drop_first)
    res = _run(root)
    assert not res["correct"] and _failed(res) == {"event_mismatch"}


def test_control_is_not_correct(root):
    res = _run(root, {"cell": control.int8_config, "pipeline": control.int8_detector,
                      "record": control.bf16_tracker})
    assert not res["correct"]
    assert {"det_score_gap_mean", "track_box_gap_px"} <= _failed(res)


@pytest.mark.cuda
def test_cell_runs_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    import json
    import subprocess
    import sys

    from perfbench import manifest

    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                          "yolov8s-640.streams32", "--seed", "3000000009", "--seconds", "5",
                          "--trace", "0"], cwd=manifest.ROOT, capture_output=True, text=True,
                         timeout=360)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
