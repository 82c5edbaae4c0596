"""The trace reader: busy time as the union of device intervals, idle gaps by
harness span, K1 launches by kernel name (``fixtures/trace_small.json``: a
kernel and an overlapping copy, K1, a memset running past the window's end,
a kernel after it, a runtime call and an instant event)."""

from __future__ import annotations

import os

import pytest

from perfbench import devtrace

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "trace_small.json")
# the trace's zero is 1e9 us of Unix time; an offset of 1000 s puts
# perf_counter seconds s at trace microsecond s * 1e6
SPANS = [("pack", 50e-6, 90e-6), ("submit", 90e-6, 400e-6), ("events", 400e-6, 500e-6)]


def test_union_busy_and_labelled_idle():
    r = devtrace.reduce(FIXTURE, SPANS, 1000.0)
    assert r["window_s"] == pytest.approx(450e-6, abs=1e-9)
    # 100-180 (kernel and copy overlap), 300-320 (K1), 490-500 (memset, clipped)
    assert r["busy_s"] == pytest.approx(110e-6, abs=1e-9)
    idle = dict(r["idle_gaps"])
    assert idle["pack"] == pytest.approx(40e-6, abs=1e-9)      # 50-90
    assert idle["submit"] == pytest.approx(210e-6, abs=1e-9)   # 90-100, 180-300, 320-400
    assert idle["events"] == pytest.approx(90e-6, abs=1e-9)    # 400-490
    assert sum(idle.values()) + r["busy_s"] == pytest.approx(r["window_s"], abs=1e-9)
    assert r["k1_launches"] == 1
    ops = dict(r["device_ops"])
    assert "late_kernel" not in ops and "cudaLaunchKernel" not in ops


def test_a_sum_of_durations_would_count_the_overlap_twice():
    events, _ = devtrace.load(FIXTURE)
    inside = [(e["ts"], e["ts"] + e["dur"]) for e in events
              if e.get("ph") == "X" and e["cat"] in devtrace.DEVICE_CATS and e["ts"] < 500]
    summed = sum(b - a for a, b in devtrace.clip(inside, 50, 500))
    unioned = sum(b - a for a, b in devtrace.union(devtrace.clip(inside, 50, 500)))
    assert summed == pytest.approx(140.0) and unioned == pytest.approx(110.0)


def test_gaps_split_over_nested_spans():
    # an open loop's "due" wait holds a consume ("events"); gaps go innermost first
    spans = [("due", 0.0, 400e-6), ("events", 200e-6, 260e-6), ("pack", 400e-6, 500e-6)]
    r = devtrace.reduce(FIXTURE, spans, 1000.0)
    idle = dict(r["idle_gaps"])
    assert idle["events"] == pytest.approx(60e-6, abs=1e-9)
    assert idle["pack"] == pytest.approx(90e-6, abs=1e-9)      # 400-490
    assert idle["due"] == pytest.approx(100e-6 + 20e-6 + 40e-6 + 80e-6, abs=1e-9)
    assert "between spans" not in idle


def test_kernel_names():
    assert devtrace.kernel_name(
        "(anonymous namespace)::nms_wide_scan(unsigned int const*, int)") == "nms_wide_scan"
    assert devtrace.kernel_name("void at::native::foo<1>(int)") == "foo"
