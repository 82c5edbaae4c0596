"""RT-DETR's decoder control: a run whose deformable attention reads value
maps (every ``cross_attn.value_proj`` output) rounded through
float8_e4m3fn, the precision below the configuration's bf16, with the rest
of the forward as the program runs it; the tracker is the control's bf16
reference tracker (``control.py``).  The cell's ``det_score_gap_mean``
limit must call it not correct: it is the one number that sees the decoder
alone (``perfbench/limits/rtdetr-l-640.streams32.json``, PERF.md §2).

    python3 perfbench/control_value_maps.py --workload <cell> --seed <n> --seconds <s>

prints the numbers of the comparison beside the cell's limits, as the last
line one JSON object.  The benchmark's own runs never run it."""

import time

T_START = time.perf_counter()

import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from perfbench import bench, control  # noqa: E402


def value_maps_fp8(pipe, pool) -> None:
    """Round the output of every MSDeformAttn's value projection of the
    program's forward through float8_e4m3fn."""
    import torch

    def fp8(_mod, _inp, out):
        return out.to(torch.float8_e4m3fn).to(out.dtype)

    hooked = [mod.register_forward_hook(fp8)
              for name, mod in pipe.detector.model.named_modules()
              if name.endswith("cross_attn.value_proj")]
    if not hooked:
        raise SystemExit("control_value_maps: the cell's model has no deformable attention")


def main(argv: list[str]) -> int:
    hooks = control.control_hooks()
    hooks["pipeline"] = value_maps_fp8
    res = bench.run(bench.parse_args(argv), T_START, hooks=hooks)
    for k, v in res["checks"].items():
        print(f"control {k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    print(json.dumps({"correct": res["correct"], "checks": res["checks"],
                      "device": res["device"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
