#!/usr/bin/env python
"""K1's one-CTA times on fixed inputs, in one checkout of the repository.

Builds that checkout's kernels and times its greedy-NMS kernel (K <= 1024,
``nms_greedy_kernel``) on seeded synthetic candidates shaped as the main
path's: 16 frames of 300 class-offset candidates with 68-85 valid a frame,
32 frames of 300 with 60-80 valid, and one frame of 1000 all valid. Each
case is timed three times from a torch.profiler trace (the kernel's mean
over 100 launches) and three times from a CUDA graph of 100 launches. It
prints one line, ``nms_kernel_times <tree> <json>``, in milliseconds.

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

# label -> (frames, candidates, fewest valid, most valid)
CASES = {"b16_k300": (16, 300, 68, 85), "b32_k300": (32, 300, 60, 80),
         "b1_k1000": (1, 1000, 1000, 1000)}
ITERS, REPEATS = 100, 3


def candidates(b: int, k: int, lo: int, hi: int, seed: int = 7):
    """Score-sorted, class-offset boxes (B, K, 4) and scores (B, K) with
    lo..hi valid rows a frame."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 560, (b, k, 2))
    wh = rng.uniform(8, 160, (b, k, 2))
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    boxes += (rng.integers(0, 8, (b, k, 1)) * 7680.0).astype(np.float32)
    scores = -np.sort(-rng.uniform(0.05, 1, (b, k)), 1).astype(np.float32)
    for f in range(b):
        scores[f, rng.integers(lo, hi + 1):] = 0.0
    return boxes, scores


def trace_ms(torch, fn) -> float:
    """The kernel's mean duration over the launches a profiler trace of
    ``ITERS`` calls holds."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(ITERS):
            fn()
        torch.cuda.synchronize()
    evts = [e for e in prof.key_averages() if "nms_greedy_kernel" in e.key]
    total = sum(getattr(e, "self_device_time_total", 0.0) for e in evts)
    return total / sum(e.count for e in evts) / 1e3


def graph_ms(torch, fn) -> float:
    """Time per call replayed from a CUDA graph of ``ITERS`` calls."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(ITERS):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(5):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 5 / ITERS


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
    for label, (b, k, lo, hi) in CASES.items():
        boxes, scores = (torch.from_numpy(x).to(dev) for x in candidates(b, k, lo, hi))
        fn = lambda: nms_kernel.greedy_suppress(boxes, scores, 0.45)  # noqa: E731
        out[label] = {"trace": [trace_ms(torch, fn) for _ in range(REPEATS)],
                      "graph": [graph_ms(torch, fn) for _ in range(REPEATS)]}
    print("nms_kernel_times", a.tree, json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
