"""The RT-DETR architecture of the benchmark (``perfbench/archs/rtdetr.py``):

  (a) its seeded weights, at the configuration's published widths, load
      into the program's model and into the plain reference alike;
  (b) the work-count module (``msdeform_bound.py``) against a count by hand
      at one shape, and the roofline reader against it on a made-up trace;
  (c) a 3-second CPU run of a small RT-DETR cell (the published model at 256
      px on two 288 x 512 streams, float32) is correct, leaves out
      ``det_overlap_pairs``, and reports the new readers (the device's
      ones none: a CPU run's trace holds no kernel)."""

from __future__ import annotations

import json
import os
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from perfbench import bench, manifest, msdeform_bound
from perfbench.peaks import HBM_BYTES
from perfbench.tests.helpers import tiny_root
from rtmodt_tpu_torch.models import rtdetr

CELL = "rtdetr-l-640.streams32"
CONFIG = os.path.join(manifest.ROOT, "perfbench", "configs", "rtdetr-l-640.json")


@pytest.fixture(autouse=True)
def threads():
    n = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(n)


def test_seeded_weights_load_into_program_and_reference(tmp_path):
    conf = manifest.load_cell(CELL).config
    arch = manifest.arch_module(conf)
    assert not arch.SUPPRESSED
    path = arch.seeded_weights(conf, conf["weights"]["seed"], str(tmp_path / "w"), "cpu")
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    assert {k: v.shape for k, v in flat.items()} == dict(arch.leaves(conf))
    model = rtdetr.build_model(conf["pipeline"]["detection"]["model"], conf["nc"])
    rtdetr.load_state(model, flat)
    plain = arch.load_reference(conf, path, torch.device("cpu"))
    assert set(plain.w) == set(flat)
    assert all(torch.equal(plain.w[k], torch.from_numpy(flat[k])) for k in flat)
    # the decoder's class heads share the encoder's draw
    enc = flat["model.28.enc_score_head.weight"]
    assert all(np.array_equal(flat[f"model.28.dec_score_head.{i}.weight"], enc)
               for i in range(conf["num_decoder_layers"]))
    # the same seed, the same file
    again = arch.seeded_weights(conf, conf["weights"]["seed"], str(tmp_path / "again"), "cpu")
    with np.load(again) as z:
        assert all(np.array_equal(z[k], flat[k]) for k in flat)


def test_work_count_by_hand():
    # one frame, 2 queries, 1 head, levels 2x2 and 1x1 (V = 5), 3 points, 32 channels
    nbytes, ops = msdeform_bound.msdeform_work(1, 5, 2, 1, 2, 3, 32)
    points = 2 * 1 * 2 * 3                       # queries x heads x levels x points
    assert nbytes == 5 * 32 * 2 + points * 2 * 4 + points * 4 + 2 * 32 * 2
    assert ops == 10 * points * 32
    # the cell's launch (256 frames): bound by bytes
    conf = json.load(open(CONFIG))
    t, kind = msdeform_bound.cell_bound_s(conf, 256)
    v = 80 * 80 + 40 * 40 + 20 * 20
    want = (256 * v * 256 * 2 + 256 * 300 * 8 * 3 * 4 * 12 + 256 * 300 * 256 * 2) / HBM_BYTES
    assert kind == "bytes" and t == pytest.approx(want, rel=1e-12)


def test_roofline_reader_on_a_made_up_trace():
    conf = json.load(open(CONFIG))
    bound, _ = msdeform_bound.cell_bound_s(conf, 256)
    run = SimpleNamespace(config=conf, frames_per_chunk=256, traced_frames=256 * 7,
                          trace={"kernel_table": {"msdeform_kernel": {
                              "seconds": 42 * bound * 4.0, "launches": 42}}})
    read = manifest.metric_reader("msdeform_roofline")
    assert read(run) == pytest.approx(25.0)
    assert manifest.metric_reader("msdeform_ms_per_frame")(run) == pytest.approx(
        1e3 * 42 * bound * 4.0 / (256 * 7))
    run.trace = {"kernel_table": {}}
    assert read(run) is None and manifest.metric_reader("msdeform_ms_per_frame")(run) is None


def _rtdetr_root(tmp: str) -> str:
    """``tiny_root`` with a small RT-DETR cell: the published model at 256 px
    in float32 on tiny's streams and zones, under the new cell's limits."""
    root = tiny_root(tmp)
    pb = os.path.join(root, "perfbench")
    with open(CONFIG) as f:
        conf = json.load(f)
    with open(os.path.join(pb, "configs", "tiny.json")) as f:
        tiny = json.load(f)
    conf["camera"] = tiny["camera"]
    conf["pipeline"]["events"]["zones"] = tiny["pipeline"]["events"]["zones"]
    conf["pipeline"]["detection"].update(input_size=256, half=False)
    with open(os.path.join(pb, "configs", "rtdetr-tiny.json"), "w") as f:
        json.dump(conf, f)
    with open(os.path.join(pb, "limits", f"{CELL}.json")) as f:
        limits = json.load(f)
    with open(os.path.join(pb, "limits", "rtdetr.tiny.json"), "w") as f:
        json.dump(limits, f)
    m = manifest.load_manifest(root)
    m["configs"].append({"name": "rtdetr-tiny", "source": m["configs"][-2]["source"],
                         "file": "perfbench/configs/rtdetr-tiny.json", "reduced": ["imgsz"],
                         "why": "RT-DETR-L at 256 px for the CPU"})
    m["workloads"].append({"name": "rtdetr.tiny", "config": "rtdetr-tiny", "traffic": "tiny",
                           "chips": 1, "why": "two small streams on the CPU"})
    for e in m["end_to_end"] + m["per_layer"]:
        if CELL in e.get("workloads", ()):
            e["workloads"].append("rtdetr.tiny")
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(m, f)
    assert manifest.problems(manifest.load_manifest(root), root) == []
    return root


def test_small_cell_runs_correct_on_the_cpu(tmp_path):
    root = _rtdetr_root(str(tmp_path))
    seen = {}
    args = bench.parse_args(["--workload", "rtdetr.tiny", "--seed", "3000000019", "--seconds",
                             "3", "--trace", "1"])
    res = bench.run(args, time.perf_counter(), root, device="cpu",
                    hooks={"run": lambda rr: seen.update(rr=rr)})
    assert res["correct"], res["checks"]
    assert "det_overlap_pairs" not in res["checks"]
    m = res["metrics"]
    assert m["forward_host_ms_per_frame"]["value"] > 0
    assert m["forward_host_ms_per_frame"]["value"] <= m["detect_ms_per_frame"]["value"]
    assert "msdeform_roofline" not in m and "msdeform_ms_per_frame" not in m
    rr = seen["rr"]
    layers = rr.config["num_decoder_layers"]
    chunks = rr.program_counters["msdeform_launches"] // layers
    assert chunks > 0 and rr.program_counters["msdeform_launches"] == chunks * layers
    assert rr.program_counters["msdeform_points"] == chunks * layers * 4 * 300 * 8 * 3 * 4
    arch = manifest.arch_module(rr.config, root)
    assert m["mfu"]["value"] == pytest.approx(
        100.0 * arch.forward_flops(rr.config) * rr.frames_per_s() / 989e12, rel=1e-12)


def test_value_map_control_rounds_only_the_deformable_value_maps():
    from perfbench import control_value_maps

    torch.manual_seed(0)
    model = rtdetr.build_model("rtdetr-l", 80).eval()
    pipe = SimpleNamespace(detector=SimpleNamespace(model=model))
    dec = model.model[-1].decoder.layers
    proj = dec[0].cross_attn.value_proj
    x = torch.randn(1, 7, proj.in_features)
    before = proj(x)
    control_value_maps.value_maps_fp8(pipe, None)
    after = proj(x)
    assert torch.equal(after, before.to(torch.float8_e4m3fn).to(before.dtype))
    assert not torch.equal(after, before)
    hooked = [m for m in model.modules() if m._forward_hooks]
    assert hooked == [layer.cross_attn.value_proj for layer in dec]
    yolo = SimpleNamespace(detector=SimpleNamespace(model=torch.nn.Conv2d(3, 3, 1)))
    with pytest.raises(SystemExit):
        control_value_maps.value_maps_fp8(yolo, None)
