"""The control of the correctness comparison: a run whose timed path is
computed in the precision below the configuration's, which the limits of
``perfbench/limits/<cell>.json`` must call not correct.

  * the detector: the architecture module's ``control_config`` and
    ``control_detector`` (``perfbench/archs/<arch>.py``); for YOLOv8 the
    program's own int8 path (``detection.quant: int8``, ``quant/ptq.py``),
    calibrated on eight of the run's camera frames, in place of the bf16
    forward (``int8_config``, ``int8_detector``);
  * the tracker: the reference tracker with its state rounded to bfloat16
    after every step, put in the program's place (its tracks and events
    replace the program's before the comparison).

    python3 perfbench/control.py --workload <cell> --seed <n> --seconds <s>

prints the numbers of the comparison beside the cell's limits, as the last
line one JSON object.  The benchmark's own runs never run it."""

import time

T_START = time.perf_counter()

import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

import numpy as np  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from perfbench import bench, check, manifest  # noqa: E402


def int8_config(cell) -> None:
    cell.config["pipeline"]["detection"]["quant"] = "int8"


def int8_detector(pipe, pool) -> None:
    frames = [pool[p, s] for p in (0, pool.shape[0] // 2) for s in range(min(4, pool.shape[1]))]
    pipe.detector.calibrate(frames)


def bf16_tracker(rec: dict, cfg: dict) -> None:
    """Replace the program's tracks and events by the bf16-state reference
    tracker's, fed the program's detections."""
    tracks, t_chunk = rec["tracks"], rec["chunk"]
    out = {k: np.zeros_like(v) for k, v in tracks.items()}
    events = []
    for j, c, t, o, evs in check.reference_tracks(
            rec["dets"], cfg, tracks["boxes"].shape[3], len(rec["streams"]), t_chunk,
            rec["camera_fps"], bf16_state=True):
        for k in out:
            out[k][c, t, j] = o[k]
        events.extend((j, *e[:6]) for e in evs)
    rec["tracks"], rec["events"] = out, events


def control_hooks(root: str = manifest.ROOT) -> dict:
    """``bench.run``'s hooks of the control: the cell's architecture
    module's detector control, where it has one, and the bf16 tracker."""
    arch = {}

    def cell(c) -> None:
        arch["module"] = manifest.arch_module(c.config, root)
        if hasattr(arch["module"], "control_config"):
            arch["module"].control_config(c)

    def pipeline(pipe, pool) -> None:
        if hasattr(arch["module"], "control_detector"):
            arch["module"].control_detector(pipe, pool)

    return {"cell": cell, "pipeline": pipeline, "record": bf16_tracker}


def main(argv: list[str]) -> int:
    args = bench.parse_args(argv)
    res = bench.run(args, T_START, hooks=control_hooks())
    for k, v in res["checks"].items():
        print(f"control {k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    print(json.dumps({"correct": res["correct"], "checks": res["checks"],
                      "device": res["device"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
