"""The port's measuring tools on the CPU at tiny settings.

``tools/benchmark_torch.py``, ``bench_latency_torch.py`` and
``bench_dense_torch.py`` must write the report keys of the reference tools
(written out below from the reference's source lines), and
``bench_dense_torch``'s round counts must equal direct calls of
``nms_debug_from_logits`` / ``greedy_assign_rounds`` on the same frames.
``trace_chunk_torch.py`` captures one trace of the packed chunk program,
and its attribution maps a kernel to the aten op and shapes that launched
it, with the operations and bytes those shapes give.
"""

from __future__ import annotations

import glob
import json

import numpy as np
import pytest
import torch

from tests.test_torch_port_threads import torch_threads  # noqa: F401 (autouse)

TINY = ["--device", "cpu", "--model", "yolov8n", "--imgsz", "64", "--height", "72",
        "--width", "128"]

# tools/benchmark.py:71 (chunked) and :83 (the profiler's summary; the stages
# rtmodt_tpu/runtime/pipeline.py::step times, plus the renderer's)
_STATS = ("mean", "p95", "p99")
BENCH_KEYS = {
    "chunked": {"fps_mean", "mode", "chunk"},
    "per_stage": {f"{s}_{m}_ms" for s in ("preprocess", "inference", "nms", "tracking",
                                          "events", "visualization", "total", "frame")
                  for m in _STATS} | {"fps_mean", "fps_p5"},
    "fused": {f"{s}_{m}_ms" for s in ("inference", "events", "visualization", "total",
                                      "frame") for m in _STATS} | {"fps_mean", "fps_p5"},
}
# tools/bench_latency.py:79, :90, :107, :134-136, :145-147
LATENCY_KEYS = {"rpc_round_trip_ms": {"p50", "p95"}, "put_frame_ms": {"p50", "p95"},
                "device_compute_ms_per_frame_amortized": None,
                **{f"live_depth{d}_ms": {"mean", "p50", "p95", "p99"} for d in (0, 1, 2)},
                "relay_floor_ms_est": None, "framework_overhead_ms_est": None}
# tools/bench_dense.py:180-184
DENSE_KEYS = {"objects", "ms_per_frame", "device_ms_per_frame", "mean_detections",
              "live_tracks", "nms_rounds", "nms_pool_used", "nms_kept", "assign_rounds"}


@pytest.mark.parametrize("mode,frames", [("per_stage", 14), ("fused", 14), ("chunked", 8)])
def test_benchmark_writes_the_reference_summary_keys(mode, frames, tmp_path):
    from tools.benchmark_torch import main

    out = tmp_path / "summary.json"
    assert main([*TINY, "--mode", mode, "--frames", str(frames), "--chunk", "4",
                 "--json-out", str(out)]) == 0
    summary = json.loads(out.read_text())
    assert set(summary) == BENCH_KEYS[mode]
    assert summary["fps_mean"] > 0
    if mode == "chunked":
        assert (summary["mode"], summary["chunk"]) == ("chunked", 4)


def test_bench_latency_writes_the_reference_report_keys(tmp_path):
    from tools.bench_latency_torch import main

    out = tmp_path / "latency.json"
    assert main([*TINY, "--frames", "24", "--json", str(out)]) == 0
    report = json.loads(out.read_text())
    assert set(report) == set(LATENCY_KEYS)
    for key, sub in LATENCY_KEYS.items():
        if sub is None:
            assert np.isfinite(report[key])
        else:
            assert set(report[key]) == sub and all(v >= 0 for v in report[key].values())
    floor = (report["rpc_round_trip_ms"]["p50"] + report["put_frame_ms"]["p50"]
             + report["device_compute_ms_per_frame_amortized"])
    assert report["relay_floor_ms_est"] == pytest.approx(floor)
    assert report["framework_overhead_ms_est"] == pytest.approx(
        report["live_depth1_ms"]["p50"] - floor)


def test_bench_latency_needs_more_frames_than_it_drops():
    from tools.bench_latency_torch import main

    with pytest.raises(SystemExit):
        main([*TINY, "--frames", "20"])


def test_bench_dense_rows_and_round_counts(tmp_path):
    from rtmodt_tpu_torch.detection.detector import Detector
    from rtmodt_tpu_torch.ops.assignment import greedy_assign_rounds
    from rtmodt_tpu_torch.ops.iou import pairwise_iou
    from rtmodt_tpu_torch.ops.nms import batched_nms_from_logits, nms_debug_from_logits
    from rtmodt_tpu_torch.utils.synthetic import dense_moving_scene
    from tools.bench_dense_torch import dense_config, main

    out = tmp_path / "dense.json"
    h, w, k, reps = 96, 128, 2, 2
    assert main(["--device", "cpu", "--input-size", "64", "--height", str(h), "--width",
                 str(w), "--densities", "4,8", "--chunk", str(k), "--reps", str(reps),
                 "--trace", "--trace-dir", str(tmp_path / "traces"),
                 "--json", str(out)]) == 0
    rows = json.loads(out.read_text())
    assert [r["objects"] for r in rows] == [4, 8]
    assert all(set(r) == DENSE_KEYS for r in rows)
    for dens in (4, 8):
        assert len(glob.glob(str(tmp_path / "traces" / f"dense_{dens}" / "*.trace.json.gz"))) == 1
    # a CPU capture holds no device time
    assert all(r["device_ms_per_frame"] == 0.0 for r in rows)

    # the round counts, computed directly on the last two frames of each run
    cfg = dense_config(None, "yolov8n", 8, 64, 0.25)
    det = Detector(cfg.detection, device="cpu", warmup=False)
    d = cfg.detection
    n_frames = (2 + max(2, reps // 2) + reps) * k
    for row in rows:
        dens = row["objects"]
        frames = [dense_moving_scene(t, h, w, n_objects=dens, seed=1234 + dens)[0]
                  for t in (n_frames - 2, n_frames - 1)]
        results = []
        with torch.no_grad():
            for f in frames:
                bd, cl = det.forward(det.preprocess(torch.from_numpy(f)))
                results.append((nms_debug_from_logits(bd[0], cl[0], 64, d.conf_threshold,
                                                      d.iou_threshold, d.nms_candidates),
                                batched_nms_from_logits(bd, cl, 64, d.conf_threshold,
                                                        d.iou_threshold, d.max_detections,
                                                        d.nms_candidates)))
        (_, prev), ((rounds, pool, kept), cur) = results
        a_rounds = greedy_assign_rounds(pairwise_iou(prev.boxes[0], cur.boxes[0]), 0.2,
                                        prev.valid[0], cur.valid[0])
        assert (row["nms_rounds"], row["nms_pool_used"], row["nms_kept"],
                row["assign_rounds"]) == (rounds, pool, kept, a_rounds)
        assert row["nms_kept"] <= row["nms_pool_used"] <= d.nms_candidates


def test_trace_chunk_captures_one_trace_of_the_chunk_program(tmp_path, capsys):
    from tools.trace_chunk_torch import main

    tdir, out = tmp_path / "trace", tmp_path / "trace.json"
    assert main([*TINY, "--chunk", "2", "--iters", "2", "--out", str(tdir),
                 "--attribute", "--json", str(out)]) == 0
    assert len(glob.glob(str(tdir / "*.trace.json.gz"))) == 1
    report = json.loads(out.read_text())
    # the CPU lanes hold no device op: nothing to rank or attribute
    assert report["frames"] == 4 and report["top"] == [] and report["attribution"] == []
    assert "no device event" in capsys.readouterr().err


def _attribution_events() -> list:
    """A hand-built CUDA trace: a conv2d whose cuDNN op launches the conv
    kernel and a bias add, a matmul, and a kernel launched outside any aten
    op."""
    conv_args = {"External id": 1, "Input Dims": [[16, 32, 160, 160], [64, 32, 3, 3], [64],
                                                  [], [], [], []],
                 "Input type": ["c10::BFloat16", "c10::BFloat16", "c10::BFloat16",
                                "ScalarList", "ScalarList", "ScalarList", "Scalar"],
                 "Concrete Inputs": ["", "", "", "[2, 2]", "[1, 1]", "[1, 1]", "1"]}
    return [
        {"ph": "X", "cat": "cpu_op", "name": "aten::conv2d", "pid": 0, "tid": 1,
         "ts": 0.0, "dur": 100.0, "args": conv_args},
        {"ph": "X", "cat": "cpu_op", "name": "aten::cudnn_convolution", "pid": 0, "tid": 1,
         "ts": 10.0, "dur": 80.0, "args": {"External id": 2}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "pid": 0, "tid": 1,
         "ts": 20.0, "dur": 5.0, "args": {"correlation": 11, "External id": 2}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "pid": 0, "tid": 1,
         "ts": 40.0, "dur": 5.0, "args": {"correlation": 14, "External id": 2}},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "pid": 0, "tid": 1, "ts": 200.0,
         "dur": 50.0, "args": {"External id": 3, "Input Dims": [[128, 256], [256, 512]],
                               "Input type": ["float", "float"]}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "pid": 0, "tid": 1,
         "ts": 210.0, "dur": 5.0, "args": {"correlation": 12, "External id": 3}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "pid": 0, "tid": 1,
         "ts": 400.0, "dur": 5.0, "args": {"correlation": 13}},
        {"ph": "X", "cat": "kernel", "name": "sm90_conv_fprop", "pid": 1, "tid": 7,
         "ts": 30.0, "dur": 100.0, "args": {"correlation": 11, "External id": 2}},
        {"ph": "X", "cat": "kernel", "name": "bias_add", "pid": 1, "tid": 7,
         "ts": 130.0, "dur": 25.0, "args": {"correlation": 14, "External id": 2}},
        {"ph": "X", "cat": "kernel", "name": "gemm", "pid": 1, "tid": 7, "ts": 220.0,
         "dur": 10.0, "args": {"correlation": 12, "External id": 3}},
        {"ph": "X", "cat": "kernel", "name": "nms_greedy_kernel", "pid": 1, "tid": 7,
         "ts": 410.0, "dur": 5.0, "args": {"correlation": 13}},
    ]


def test_attribution_maps_kernels_to_their_aten_ops_and_rates():
    from tools.trace_chunk_torch import attribution

    rows = {r["kernel"]: r for r in attribution(_attribution_events(), frames=16)}
    assert list(rows) == ["sm90_conv_fprop", "bias_add", "gemm", "nms_greedy_kernel"]
    conv = rows["sm90_conv_fprop"]
    assert conv["ms_per_frame"] == pytest.approx(0.1 / 16) and conv["calls"] == 1
    (op,) = conv["ops"]
    (bias,) = rows["bias_add"]["ops"]
    assert op["op"].startswith("aten::conv2d [16, 32, 160, 160]x[64, 32, 3, 3]x[64]")
    assert bias["op"] == op["op"]
    assert (op["launches"], op["ms"], bias["ms"]) == (1, pytest.approx(0.1),
                                                      pytest.approx(0.025))
    # one call of the op, its time over both of its kernels
    assert (op["op_calls"], bias["op_calls"]) == (1, 1)
    assert op["op_ms"] == bias["op_ms"] == pytest.approx(0.125)
    # stride 2, pad 1: an 80 x 80 output; 2 * N * O * 80 * 80 * C * 3 * 3 operations
    flops = 2.0 * 16 * 64 * 80 * 80 * 32 * 9
    nbytes = 2 * (16 * 32 * 160 * 160 + 64 * 32 * 9 + 64 + 16 * 64 * 80 * 80)
    assert op["tflops"] == bias["tflops"] == pytest.approx(flops / 1.25e-4 / 1e12)
    assert op["gbps"] == pytest.approx(nbytes / 1.25e-4 / 1e9)
    (mm,) = rows["gemm"]["ops"]
    assert mm["tflops"] == pytest.approx(2.0 * 128 * 256 * 512 / 1e-5 / 1e12)
    assert mm["gbps"] == pytest.approx(4 * (128 * 256 + 256 * 512 + 128 * 512) / 1e-5 / 1e9)
    (k1,) = rows["nms_greedy_kernel"]["ops"]
    assert k1["op"] == "(no host op found)" and k1["tflops"] is None


def test_tools_default_to_the_card(monkeypatch):
    import tools.bench_dense_torch as dense
    import tools.bench_latency_torch as latency
    import tools.benchmark_torch as bench
    import tools.trace_chunk_torch as chunk

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main, argv in ((bench.main, []), (latency.main, []), (dense.main, []),
                       (chunk.main, [])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main(argv)
