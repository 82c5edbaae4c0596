#!/usr/bin/env python
"""Capture and summarize a device trace of the packed chunk program on the card.

The port's counterpart of ``tools/trace_chunk.py``: runs ``Pipeline``'s
packed chunk program ``submit_packed_yuv`` (YOLOv8s at 640, 720p
``moving_boxes_frame`` chunks) for ``--iters`` chunks after two warm chunks
under torch.profiler (``profiling/trace_summary.py::start_trace``), then
reads the Chrome trace it wrote and prints the top device ops (kernels,
copies, memsets) by total time: total ms, ms/frame, calls and share.

``--attribute`` is the counterpart of the reference's HLO attribution: the
capture records every op's input shapes, and each of the top kernels is
mapped to the ``aten::`` op (as the Python code called it) and the input
shapes that launched it, through the trace's launch correlation.  For a
convolution or a matrix product it prints the achieved TFLOP/s and GB/s
computed from those shapes (each input read once, the output written once).

The flags are the reference's, plus ``--device`` (the card by default;
``cpu`` captures the CPU lanes only, which hold no device op), the model and
frame size (``--model``, ``--imgsz``, ``--height``, ``--width``) and
``--json`` (the table, every device op's call count and the attribution as
JSON).

    python tools/trace_chunk_torch.py [--chunk 16] [--iters 4] [--out DIR]
        [--weights checkpoints/rich640d/ema_final.npz --num-classes 8] [--attribute]
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
from collections import defaultdict

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

DEFAULT_OUT = os.path.join(ROOT, "build", "traces", "trace_chunk")
# bytes of an element, by the profiler's "Input type" names
_ELEM_BYTES = {"c10::BFloat16": 2, "c10::Half": 2, "float": 4, "double": 8, "int": 4,
               "long int": 8, "short int": 2, "signed char": 1, "unsigned char": 1,
               "bool": 1}
_CONV_OPS = {"aten::conv2d": 6, "aten::convolution": 8, "aten::_convolution": 8}  # -> groups arg


def capture(out_dir: str, chunk: int, iters: int,
            algorithm: str = "bytetrack", gmc: bool = False,
            quant: str = "none", weights: str | None = None,
            quant_scales: str | None = None, num_classes: int = 80,
            transport: str = "packed", topk: str = "exact", device: str = "cuda",
            model: str = "yolov8s", imgsz: int = 640, height: int = 720,
            width: int = 1280, record_shapes: bool = False) -> float:
    """Trace ``iters`` chunks of the packed chunk program into ``out_dir``;
    returns the wall ms per frame submitted."""
    import numpy as np
    import torch

    from rtmodt_tpu_torch.config import load_config
    from rtmodt_tpu_torch.ops.yuv import pack_chunk
    from rtmodt_tpu_torch.profiling.trace_summary import start_trace, stop_trace
    from rtmodt_tpu_torch.runtime.pipeline import Pipeline
    from rtmodt_tpu_torch.utils.synthetic import moving_boxes_frame

    det_over: dict = {"model": model, "input_size": imgsz,
                      "num_classes": num_classes, "topk_impl": topk}
    if quant != "none":
        det_over["quant"] = quant
        if quant_scales:
            det_over["quant_scales"] = quant_scales
    if weights:
        det_over["weights"] = weights
    cfg = load_config(overrides={
        "detection": det_over,
        "tracking": {"algorithm": algorithm,
                     **({"gmc": {"method": "phase"}} if gmc else {})},
        "profiling": {"per_stage": False, "warmup_frames": 0, "log_interval": 0},
        "visualization": {"enabled": False},
        "events": {"enabled": False},
        "parallel": {"chunk_size": chunk, "pipeline_depth": 2,
                     "transport": transport},
    })
    pipe = Pipeline(cfg, device=device)
    h, w = height, width

    # distinct chunks of one continuous scene
    packs = []
    for c in range(iters + 2):
        frames = np.stack([moving_boxes_frame(c * chunk + t, h, w, n_objects=8)[0]
                           for t in range(chunk)])
        packs.append(pack_chunk(frames, imgsz)[0])

    def sync() -> None:
        if pipe.device.type == "cuda":
            torch.cuda.synchronize(pipe.device)

    print("warmup...", file=sys.stderr)
    pipe.submit_packed_yuv(packs[-1], h, w)
    pipe.submit_packed_yuv(packs[-2], h, w)
    sync()

    print(f"tracing {iters} chunks of {chunk}...", file=sys.stderr)
    prof = start_trace(out_dir, pipe.device, record_shapes=record_shapes)
    t0 = time.perf_counter()
    for i in range(iters):
        outs, _ = pipe.submit_packed_yuv(packs[i], h, w)
    outs.visible.cpu()                       # fetch-sync
    wall = time.perf_counter() - t0
    sync()
    stop_trace(prof)
    ms = wall / (iters * chunk) * 1e3
    print(f"wall {wall * 1e3:.1f} ms for {iters * chunk} frames "
          f"({ms:.2f} ms/frame submitted)", file=sys.stderr)
    return ms


def summarize(out_dir: str, iters: int, chunk: int, top: int = 25,
              events: list | None = None) -> list[dict]:
    """Print the top device ops of the latest trace under ``out_dir`` (or of
    ``events``, that trace already read); returns their rows."""
    from rtmodt_tpu_torch.profiling.trace_summary import device_op_times, load_latest_trace

    if events is None:
        events = load_latest_trace(out_dir)
    if not events:
        print("no trace.json.gz found under", out_dir, file=sys.stderr)
        return []
    by_op, n_ev = device_op_times(events)
    if not by_op:
        print("the trace holds no device event (a CPU capture, or no CUPTI)",
              file=sys.stderr)
        return []
    total = sum(by_op.values())
    frames = iters * chunk
    print(f"\ndevice op time over {frames} frames "
          f"(total {total:.1f} ms, {total / frames:.3f} ms/frame):")
    print(f"{'op':60s} {'total_ms':>9s} {'ms/frame':>9s} {'calls':>6s} {'%':>5s}")
    rows = []
    for name, ms in sorted(by_op.items(), key=lambda kv: -kv[1])[:top]:
        pct = 100 * ms / max(total, 1e-9)
        print(f"{name[:60]:60s} {ms:9.2f} {ms / frames:9.4f} {n_ev[name]:6d} {pct:5.1f}")
        rows.append({"op": name, "total_ms": ms, "ms_per_frame": ms / frames,
                     "calls": n_ev[name], "pct": pct})
    return rows


def _launching_ops(events: list) -> tuple[dict, dict]:
    """(launch correlation -> op, External id -> op): for every kernel
    launch on the host and every host op, the outermost ``aten::`` op that
    encloses it on its thread (the op as the Python code called it, e.g.
    ``aten::conv2d`` around ``aten::cudnn_convolution``)."""
    lanes: dict = defaultdict(list)
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in ("cpu_op", "cuda_runtime", "cuda_driver"):
            lanes[(e.get("pid"), e.get("tid"))].append(e)
    by_corr: dict = {}
    by_ext: dict = {}
    for lane in lanes.values():
        lane.sort(key=lambda e: (e["ts"], -e.get("dur", 0)))
        stack: list = []
        for e in lane:
            while stack and stack[-1]["ts"] + stack[-1].get("dur", 0) <= e["ts"]:
                stack.pop()
            outer = next((s for s in stack if s["name"].startswith("aten::")), None)
            args = e.get("args", {})
            if e["cat"] == "cpu_op":
                if outer is None and e["name"].startswith("aten::"):
                    outer = e
                if outer is not None and "External id" in args:
                    by_ext[args["External id"]] = outer
                stack.append(e)
            elif outer is not None and "correlation" in args:
                by_corr[args["correlation"]] = outer
    return by_corr, by_ext


def _concrete(op: dict, i: int):
    try:
        return json.loads(op["args"]["Concrete Inputs"][i])
    except (KeyError, IndexError, TypeError, ValueError):
        return None


def op_work(op: dict) -> tuple[float, float] | None:
    """(floating-point operations, bytes) of one convolution or matrix
    product from its recorded input shapes: each input read once, the
    output written once.  None for any other op, or shapes it cannot read."""
    args = op.get("args", {})
    dims, types = args.get("Input Dims") or [], args.get("Input type") or []
    name = op.get("name", "")

    def size(i: int, shape=None) -> float:
        shape = dims[i] if shape is None else shape
        return math.prod(shape) * _ELEM_BYTES.get(types[i] if i < len(types) else "", 0)

    try:
        if name in _CONV_OPS:
            (n, c, h, w), (o, cg, kh, kw) = dims[0], dims[1]
            stride, pad, dil = (_concrete(op, i) for i in (3, 4, 5))
            if not all(isinstance(v, list) and len(v) == 2 for v in (stride, pad, dil)):
                return None
            ho = (h + 2 * pad[0] - dil[0] * (kh - 1) - 1) // stride[0] + 1
            wo = (w + 2 * pad[1] - dil[1] * (kw - 1) - 1) // stride[1] + 1
            flops = 2.0 * n * o * ho * wo * cg * kh * kw
            nbytes = size(0) + size(1) + (size(2) if len(dims) > 2 and dims[2] else 0)
            return flops, nbytes + size(0, (n, o, ho, wo))
        if name in ("aten::mm", "aten::addmm", "aten::bmm"):
            a = 1 if name == "aten::addmm" else 0
            x, y = dims[a], dims[a + 1]
            out = (*x[:-1], y[-1])
            flops = 2.0 * math.prod(x) * y[-1]
            extra = size(0) if a else 0
            return flops, size(a) + size(a + 1) + extra + size(a, out)
        if name == "aten::linear":
            x, wt = dims[0], dims[1]
            out = (*x[:-1], wt[0])
            flops = 2.0 * math.prod(x) * wt[0]
            bias = size(2) if len(dims) > 2 and dims[2] else 0
            return flops, size(0) + size(1) + bias + size(0, out)
        if name == "aten::matmul" and len(dims[0]) >= 2 and len(dims[1]) >= 2:
            x, y = dims[0], dims[1]
            batch = max(math.prod(x[:-2]), math.prod(y[:-2]))
            out = (batch, x[-2], y[-1])
            flops = 2.0 * batch * x[-2] * x[-1] * y[-1]
            return flops, size(0) + size(1) + size(0, out)
    except (TypeError, ValueError, IndexError):
        return None
    return None


def _signature(op: dict) -> str:
    args = op.get("args", {})
    shapes = "x".join(str(list(d)) for d in (args.get("Input Dims") or []) if d)
    dtype = next((t for t in args.get("Input type") or [] if t in _ELEM_BYTES), "?")
    extra = ""
    if op["name"] in _CONV_OPS:
        extra = (f" stride {_concrete(op, 3)} pad {_concrete(op, 4)} "
                 f"groups {_concrete(op, _CONV_OPS[op['name']])}")
    return f"{op['name']} {shapes}{extra} ({dtype})"


def attribution(events: list, frames: int, top: int = 12) -> list[dict]:
    """The top ``top`` device kernels of ``events``, each with the ops that
    launched it: signature, launches and ms in this kernel, and the op's own
    totals over every kernel its calls launched (calls, ms); for a
    convolution or a matrix product the achieved TFLOP/s and GB/s of the op,
    its operations and bytes over those totals."""
    from rtmodt_tpu_torch.profiling.trace_summary import device_events

    by_corr, by_ext = _launching_ops(events)
    kernels: dict = {}
    op_ms: dict = defaultdict(float)             # signature -> ms in all its kernels
    op_calls: dict = defaultdict(set)            # signature -> the op calls (host events)
    op_of: dict = {}                             # signature -> one call's host event
    for e in device_events(events):
        args = e.get("args", {})
        op = by_corr.get(args.get("correlation"))
        if op is None:
            op = by_ext.get(args.get("External id"))
        sig = _signature(op) if op is not None else "(no host op found)"
        ms = e.get("dur", 0) / 1e3
        k = kernels.setdefault(e.get("name", "?"), {"ms": 0.0, "calls": 0, "ops": {}})
        k["ms"] += ms
        k["calls"] += 1
        row = k["ops"].setdefault(sig, {"ms": 0.0, "calls": 0})
        row["ms"] += ms
        row["calls"] += 1
        op_ms[sig] += ms
        if op is not None:
            op_calls[sig].add(id(op))
            op_of[sig] = op
    out = []
    for name, k in sorted(kernels.items(), key=lambda kv: -kv[1]["ms"])[:top]:
        ops = []
        for sig, r in sorted(k["ops"].items(), key=lambda kv: -kv[1]["ms"]):
            work = op_work(op_of[sig]) if sig in op_of else None
            sec, n = op_ms[sig] / 1e3, len(op_calls[sig])
            ops.append({"op": sig, "launches": r["calls"], "ms": r["ms"],
                        "op_calls": n, "op_ms": op_ms[sig],
                        "tflops": work[0] * n / sec / 1e12 if work and sec else None,
                        "gbps": work[1] * n / sec / 1e9 if work and sec else None})
        out.append({"kernel": name, "ms_per_frame": k["ms"] / frames, "calls": k["calls"],
                    "ops": ops})
    return out


def attribute(out_dir: str, iters: int, chunk: int, top: int = 12,
              events: list | None = None) -> list[dict]:
    """Print ``attribution`` of the latest trace under ``out_dir`` (or of
    ``events``, that trace already read)."""
    from rtmodt_tpu_torch.profiling.trace_summary import load_latest_trace

    if events is None:
        events = load_latest_trace(out_dir)
    rows = attribution(events, iters * chunk, top)
    print("\nattribution (the aten op and input shapes that launched each kernel; the "
          "op's rate over all the kernels of its calls):")
    for r in rows:
        print(f"  {r['kernel'][:90]}  {r['ms_per_frame']:.4f} ms/frame, {r['calls']} calls")
        for o in r["ops"][:4]:
            rate = (f"; the op: {o['op_calls']} calls, {o['op_ms']:.3f} ms, "
                    f"{o['tflops']:.1f} TFLOP/s, {o['gbps']:.0f} GB/s"
                    if o["tflops"] is not None else "")
            print(f"      {o['op'][:150]}: {o['launches']} launches, {o['ms']:.3f} ms{rate}")
        if len(r["ops"]) > 4:
            print(f"      ... {len(r['ops']) - 4} more launching ops")
    return rows


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--chunk", type=int, default=16)
    ap.add_argument("--iters", type=int, default=4)
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--algorithm", default="bytetrack",
                    choices=["bytetrack", "deepsort", "botsort", "ocsort"])
    ap.add_argument("--gmc", action="store_true",
                    help="enable tracking.gmc (phase correlation)")
    ap.add_argument("--quant", default="none", choices=["none", "int8"],
                    help="detection.quant")
    ap.add_argument("--weights", default=None, help="detection.weights (.npz or .pt)")
    ap.add_argument("--quant-scales", default=None,
                    help="frozen activation scales npz (QAT)")
    ap.add_argument("--num-classes", type=int, default=80,
                    help="head class count of the weights (rich* checkpoints: 8)")
    ap.add_argument("--transport", default="packed",
                    choices=["packed", "x6", "x24", "i420", "bgr"],
                    help="parallel.transport")
    ap.add_argument("--topk", default="exact", choices=["exact", "approx"],
                    help="detection.topk_impl (an exact top-k either way here)")
    ap.add_argument("--summarize-only", action="store_true")
    ap.add_argument("--attribute", action="store_true",
                    help="record input shapes and map the top kernels to the aten "
                         "ops that launched them, with TFLOP/s and GB/s")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--model", default="yolov8s")
    ap.add_argument("--imgsz", type=int, default=640)
    ap.add_argument("--height", type=int, default=720)
    ap.add_argument("--width", type=int, default=1280)
    ap.add_argument("--json", default=None, help="write the table and attribution here")
    args = ap.parse_args(argv)
    report: dict = {"frames": args.iters * args.chunk}
    if not args.summarize_only:
        report["wall_ms_per_frame"] = capture(
            args.out, args.chunk, args.iters, args.algorithm, args.gmc, args.quant,
            args.weights, args.quant_scales, args.num_classes, args.transport, args.topk,
            args.device, args.model, args.imgsz, args.height, args.width,
            record_shapes=args.attribute)
    from rtmodt_tpu_torch.profiling.trace_summary import device_op_times, load_latest_trace

    events = load_latest_trace(args.out)
    report["top"] = summarize(args.out, args.iters, args.chunk, events=events)
    report["calls"] = device_op_times(events)[1]
    if args.attribute:
        report["attribution"] = attribute(args.out, args.iters, args.chunk, events=events)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
