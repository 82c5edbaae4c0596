#!/usr/bin/env python
"""K1's times on fixed inputs, kernel by kernel, in one checkout of the repository.

Builds that checkout's kernels and times its greedy-NMS kernel on seeded
synthetic candidates. The one-CTA path (K <= 1024, ``nms_greedy_kernel``) is
timed at the main path's shapes: 16 frames of 300 class-offset candidates
with 68-85 valid a frame, 32 frames of 300 with 60-80 valid, and one frame
of 1000 all valid. The wide path (K > 1024: ``nms_wide_compact``,
``nms_wide_conflicts``, ``nms_wide_scan``) is timed on random boxes with
every candidate valid, as ``chip_smoke.py``'s phase 3 times it: K = 1025 at
B = 16 and B = 1, 2048 at B = 16, 8400 at B = 2 and 33600 at B = 1; on 16
frames with the main path's 68-85 valid class-offset candidates a frame
(``detection.nms_candidates`` set past 1024 on a real scene) at K = 2048,
8400 and 33600; and on 16 frames of 2048 boxes in chains, each box
suppressing only the next (the scan's slowest blocks).

Each case is timed three times from a torch.profiler trace (each kernel's
mean over the launches the trace holds, with that count beside it, since a
trace can lose launches; ``trace`` is the kernels' sum) and three times
from a CUDA graph of the same calls. It prints one line, ``nms_kernel_times
<tree> <json>``, in milliseconds.

The module also holds what ``chip_smoke.py`` and the tests share about K1:
``trace_by_kernel``, and the wide scan's tile with the cases at its
boundaries (``SCAN_TILE``, ``WIDE_EDGE_K``, ``WIDE_EDGE_CASES``).

Two commits are compared on one card by unpacking each (``git archive``)
and running this in turns, parent / change / change / parent:

    python tools/nms_kernel_times_torch.py --tree outputs/parent
    python tools/nms_kernel_times_torch.py --tree .
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

# label -> (frames, candidates, fewest valid, most valid, class offset, scene)
CASES = {"b16_k300": (16, 300, 68, 85, True, "random"),
         "b32_k300": (32, 300, 60, 80, True, "random"),
         "b1_k1000": (1, 1000, 1000, 1000, True, "random"),
         "b16_k1025": (16, 1025, 1025, 1025, False, "random"),
         "b1_k1025": (1, 1025, 1025, 1025, False, "random"),
         "b16_k2048": (16, 2048, 2048, 2048, False, "random"),
         "b2_k8400": (2, 8400, 8400, 8400, False, "random"),
         "b1_k33600": (1, 33600, 33600, 33600, False, "random"),
         "b16_k2048_v80": (16, 2048, 68, 85, True, "random"),
         "b16_k8400_v80": (16, 8400, 68, 85, True, "random"),
         "b16_k33600_v80": (16, 33600, 68, 85, True, "random"),
         "b16_k2048_chain": (16, 2048, 2048, 2048, False, "chain")}
# The wide scan's tile (compact rows; kTile in rtmodt_tpu_torch/csrc/nms_kernel.cu)
# and the cases at its boundaries, held to the plain version at K = WIDE_EDGE_K,
# B = 1 and 16: (scene, valid rows a frame or None for all, threshold).  v =
# T - 1, T, T + 1 and 2T + 1 compact rows; every row suppressed across tiles by
# the first (identical boxes); none suppressed (disjoint boxes); one valid row,
# the frame's last; chains of boxes, each suppressing only the next (a block's
# fixpoint then takes a round a row); the thresholds where a zero overlap
# conflicts (t < 0), any overlap does (t = 0) and almost none does (0.9999)
SCAN_TILE = 512
WIDE_EDGE_K = 2048
WIDE_EDGE_CASES = ([("random", v, 0.45) for v in (SCAN_TILE - 1, SCAN_TILE, SCAN_TILE + 1,
                                                    2 * SCAN_TILE + 1)]
                   + [("identical", 2 * SCAN_TILE + 1, 0.45), ("disjoint", None, 0.45),
                      ("disjoint", SCAN_TILE + 1, 0.45), ("one_late", None, 0.45),
                      ("chain", 2 * SCAN_TILE + 1, 0.45)]
                   + [("random", 2 * SCAN_TILE + 1, t) for t in (-0.1, 0.0, 0.9999)])
KERNELS = ("nms_greedy_kernel", "nms_wide_compact", "nms_wide_conflicts", "nms_wide_scan")
ITERS, BIG_ITERS, BIG_K, REPEATS = 100, 20, 8400, 3


def candidates(b: int, k: int, lo: int, hi: int, offset: bool = True, scene: str = "random",
               seed: int = 7):
    """Score-sorted boxes (B, K, 4), class-offset where ``offset``, and
    scores (B, K) with lo..hi valid rows a frame.  ``scene`` "random" draws
    the boxes; "chain" lines them up in chains of 200, each box overlapping
    the next by IoU 7/13 and not the one after."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 560, (b, k, 2))
    wh = rng.uniform(8, 160, (b, k, 2))
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    if scene == "chain":
        x = (np.arange(k) % 200) * 3.0 + (np.arange(k) // 200) * 1000.0
        boxes[:] = np.stack([x, 0 * x, x + 10.0, 0 * x + 10.0], -1).astype(np.float32)
    if offset:
        boxes += (rng.integers(0, 8, (b, k, 1)) * 7680.0).astype(np.float32)
    scores = -np.sort(-rng.uniform(0.05, 1, (b, k)), 1).astype(np.float32)
    for f in range(b):
        scores[f, rng.integers(lo, hi + 1):] = 0.0
    return boxes, scores


def trace_by_kernel(fn, iters: int, names: tuple[str, ...] = KERNELS) -> dict:
    """{kernel: {"ms": mean device ms a launch, "launches": launches the
    trace holds}} over a torch.profiler trace of ``iters`` calls of fn(),
    for each of ``names`` found (a trace can lose launches, so each mean is
    over the launches it holds)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    acc: dict[str, list] = {}
    for evt in prof.key_averages():
        name = next((n for n in names if n in evt.key), None)
        if name is not None and evt.count:
            us = getattr(evt, "self_device_time_total", getattr(evt, "self_cuda_time_total", 0.0))
            prev = acc.setdefault(name, [0.0, 0])
            prev[0] += us
            prev[1] += evt.count
    return {n: {"ms": us / count / 1e3, "launches": count}
            for n, (us, count) in acc.items() if us > 0}


def graph_ms(torch, fn, iters: int) -> float:
    """Time per call replayed from a CUDA graph of ``iters`` calls."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(5):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 5 / iters


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=".", help="the checkout whose kernel is timed")
    a = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(a.tree))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("nms_kernel_times_torch: needs a CUDA card")
    from rtmodt_tpu_torch import _build
    from rtmodt_tpu_torch.ops import nms_kernel

    _build.build_all()
    dev = torch.device("cuda")
    out = {}
    for label, (b, k, lo, hi, offset, scene) in CASES.items():
        boxes, scores = (torch.from_numpy(x).to(dev)
                         for x in candidates(b, k, lo, hi, offset, scene))
        fn = lambda: nms_kernel.greedy_suppress(boxes, scores, 0.45)  # noqa: E731
        iters = BIG_ITERS if k >= BIG_K else ITERS
        traces = [trace_by_kernel(fn, iters) for _ in range(REPEATS)]
        out[label] = {
            "trace": [sum(r["ms"] for r in t.values()) for t in traces],
            "graph": [graph_ms(torch, fn, iters) for _ in range(REPEATS)],
            "kernels": {n: {"ms": [t[n]["ms"] for t in traces if n in t],
                            "launches": [t[n]["launches"] for t in traces if n in t]}
                        for n in KERNELS if any(n in t for t in traces)},
            "calls": iters}
    print("nms_kernel_times", a.tree, json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
