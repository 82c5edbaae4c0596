"""The forward's operation count against Ultralytics' published figure."""

from __future__ import annotations

from perfbench.flops import conv_shapes, forward_flops

S = {"depth_multiple": 0.33, "width_multiple": 0.50, "max_channels": 1024, "nc": 80}


def test_yolov8s_640_matches_ultralytics_28_6_gflops():
    assert abs(forward_flops(S, 640) / 1e9 - 28.6) / 28.6 < 0.02


def test_scales_with_the_input_area():
    assert abs(forward_flops(S, 1280) / forward_flops(S, 640) - 4.0) < 1e-9


def test_conv_weights_match_the_program_s_model():
    from rtmodt_tpu_torch.models.yolov8 import build_model

    m = build_model("yolov8s", 8)
    n = sum(p.numel() for p in m.parameters() if p.ndim == 4)
    assert n == sum(a * b * k * k for a, b, k, _ in conv_shapes(dict(S, nc=8), 640))


def test_nms_bound_matches_the_smoke_s_arithmetic():
    from perfbench.nms_bound import nms_bound_ms

    # 16 frames of 300 candidates, 70 valid each: bytes bound
    ms, what = nms_bound_ms([70] * 16, 300)
    assert what == "bytes"
    assert abs(ms - (16 * 300 * 5 + 16 * 70 * 16) / 3.35e12 * 1e3) < 1e-12
    # K = 1000, all valid, one frame: operations bound
    ms, what = nms_bound_ms([1000], 1000)
    assert what == "operations" and abs(ms - 1.044e-4 * (1 + 0.01)) < 2e-6
