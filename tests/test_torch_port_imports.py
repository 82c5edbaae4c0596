"""Import hygiene, device rules and the smoke script's refusal paths.

The port must import no JAX module, nothing of the JAX package, and neither
cv2 nor yaml on its main path (nor click: the port's entry points parse
their flags with argparse); asked for CUDA where there is none it raises;
``chip_smoke.py`` exits non-zero with no result line where CUDA is absent or
where it stands alone without the package.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch
from tests.test_torch_port_threads import torch_threads  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import json, pkgutil, importlib, sys
import rtmodt_tpu_torch
names = [m.name for m in pkgutil.walk_packages(rtmodt_tpu_torch.__path__, "rtmodt_tpu_torch.")]
for n in names:
    importlib.import_module(n)
importlib.import_module("tools.run_pipeline_torch")
importlib.import_module("tools.compare_trackers_torch")
importlib.import_module("tools.run_inference_torch")
importlib.import_module("tools.verify_parity_torch")
for tool in ("trace_chunk", "benchmark", "bench_latency", "bench_dense", "export_model",
             "make_dataset", "train", "train_embedder", "selftest_e2e"):
    importlib.import_module(f"tools.{tool}_torch")
importlib.import_module("tools.dryrun_multichip_torch")
importlib.import_module("start_torch")
from rtmodt_tpu_torch.config import load_config
load_config()
from rtmodt_tpu_torch.models import weights
fns = [f for f in ("convert_ultralytics_state_dict", "load_ultralytics_pt", "load_params",
                   "save_npz", "_tolerant_torch_load", "_walk_module_state")
       if callable(getattr(weights, f, None))]
bad = sorted(k for k in sys.modules
             if k == "jax" or k.startswith(("jax.", "jaxlib", "flax"))
             or k == "rtmodt_tpu" or k.startswith("rtmodt_tpu."))
print(json.dumps({"modules": names, "bad": bad, "weights_fns": fns,
                  "click": "click" in sys.modules,
                  "cv2": "cv2" in sys.modules, "yaml": "yaml" in sys.modules}))
"""


def _run(args, cwd, **env):
    e = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    e.update(env)
    return subprocess.run([sys.executable, *args], cwd=cwd, capture_output=True, text=True,
                          timeout=240, env=e)


def test_port_imports_no_jax_and_no_reference_package():
    proc = _run(["-c", _PROBE], ROOT)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["bad"] == []
    assert not out["cv2"] and not out["yaml"] and not out["click"]
    for mod in ("rtmodt_tpu_torch.runtime.pipeline", "rtmodt_tpu_torch.ops.nms_kernel",
                "rtmodt_tpu_torch.events.zone_engine", "rtmodt_tpu_torch._build",
                "rtmodt_tpu_torch.ingestion.rtsp_reader",
                "rtmodt_tpu_torch.profiling.latency_profiler",
                "rtmodt_tpu_torch.ops.letterbox", "rtmodt_tpu_torch.detection.detector",
                "rtmodt_tpu_torch.tracking.tracker", "rtmodt_tpu_torch.visualization.renderer",
                "rtmodt_tpu_torch.evaluation.mot_eval", "rtmodt_tpu_torch.utils.synthetic",
                "rtmodt_tpu_torch.ops.gmc", "rtmodt_tpu_torch.ops.roi",
                "rtmodt_tpu_torch.ops.lapjv", "rtmodt_tpu_torch.models.embedder",
                "rtmodt_tpu_torch.tracking.ocsort", "rtmodt_tpu_torch.tracking.deepsort",
                "rtmodt_tpu_torch.tracking.botsort", "rtmodt_tpu_torch.tracking.host_kalman",
                "rtmodt_tpu_torch.tracking.host_bytetrack",
                "rtmodt_tpu_torch.serving.wsgi", "rtmodt_tpu_torch.serving.server",
                "rtmodt_tpu_torch.serving.monitor", "rtmodt_tpu_torch.tracking.postprocess",
                "rtmodt_tpu_torch.evaluation.coco_eval", "rtmodt_tpu_torch.evaluation.metrics",
                "rtmodt_tpu_torch.runtime.state_store", "rtmodt_tpu_torch.ops.polygon",
                "rtmodt_tpu_torch.quant", "rtmodt_tpu_torch.quant.ptq",
                "rtmodt_tpu_torch.ops.int8_conv", "rtmodt_tpu_torch.events.mqtt",
                "rtmodt_tpu_torch.profiling.trace_summary", "rtmodt_tpu_torch.quant.qat",
                "rtmodt_tpu_torch.training.assigner", "rtmodt_tpu_torch.training.loss",
                "rtmodt_tpu_torch.training.train_step", "rtmodt_tpu_torch.training.data",
                "rtmodt_tpu_torch.training.checkpoint", "rtmodt_tpu_torch.training.synth_data",
                "rtmodt_tpu_torch.training.trainer", "rtmodt_tpu_torch.parallel.mesh",
                "rtmodt_tpu_torch.parallel.ranks"):
        assert mod in out["modules"]
    assert len(out["weights_fns"]) == 6        # the .pt route and save_npz, in the port


def test_multistream_and_packer_import_no_jax_cv2_or_yaml():
    probe = ("import json, sys\n"
             "import rtmodt_tpu_torch.parallel.multistream, rtmodt_tpu_torch.ops.framepack\n"
             "print(json.dumps(sorted(k for k in sys.modules if k.split('.')[0] in "
             "('jax', 'jaxlib', 'flax', 'rtmodt_tpu', 'cv2', 'yaml'))))\n")
    proc = _run(["-c", probe], ROOT)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []


def test_multistream_pipeline_raises_without_cuda(monkeypatch):
    from rtmodt_tpu_torch.config import load_config
    from rtmodt_tpu_torch.parallel.multistream import MultiStreamPipeline

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        MultiStreamPipeline(load_config(overrides={"parallel": {"num_streams": 2}}))


def test_cuda_entry_points_raise_without_cuda(monkeypatch):
    from rtmodt_tpu_torch.device import resolve_device
    from rtmodt_tpu_torch.runtime.pipeline import Pipeline

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Pipeline(device="cuda")
    with pytest.raises(RuntimeError):
        resolve_device("cuda:0")
    assert resolve_device("cpu").type == "cpu"


def test_server_builds_its_detector_on_the_card_or_raises(monkeypatch):
    from rtmodt_tpu_torch.serving.server import _DetectorSingleton

    monkeypatch.delenv("RTMODT_WEIGHTS", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    single = _DetectorSingleton()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        single.get()
    assert single.loaded() is None


def test_training_tools_without_the_cpu_flag_need_the_card(monkeypatch, tmp_path):
    from tools.train_embedder_torch import main as train_embedder
    from tools.train_torch import main as train

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text(json.dumps({"model": "yolov8n", "num_classes": 1, "input_size": 64,
                               "batch_size": 2, "parallel": {"num_devices": 0}}))
    with pytest.raises(SystemExit) as exc:
        train(["-c", str(cfg)])
    assert "CUDA is not available" in str(exc.value.code)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_embedder(["--steps", "1", "--out", str(tmp_path / "e.npz")])
    assert not (tmp_path / "e.npz").exists()


@pytest.mark.parametrize("args", [["detect", "--images", "."], ["track", "--video", "x.mp4"]])
def test_run_inference_without_cpu_flag_needs_the_card(monkeypatch, args):
    from tools.run_inference_torch import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        main(args)
    assert "CUDA is not available" in str(exc.value.code)


def test_cli_asked_for_the_card_without_one_exits_nonzero_and_writes_no_events(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the refusal path cannot be shown here")
    log = tmp_path / "events.jsonl"
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text(json.dumps({
        "system": {"device": "cuda", "log_dir": str(tmp_path / "logs")},
        "detection": {"model": "yolov8n", "input_size": 128},
        "events": {"alert": {"log_path": str(log)}}}))
    clip = tmp_path / "clip.mp4"
    clip.write_bytes(b"")
    proc = _run([os.path.join("tools", "run_pipeline_torch.py"), "-c", str(cfg), "-s",
                 str(clip)], ROOT)
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr
    assert not log.exists()


def _no_result(proc) -> bool:
    lines = proc.stdout.strip().splitlines()
    return not any('"ok"' in line or '"kernels"' in line for line in lines)


def test_chip_smoke_refuses_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the refusal path cannot be shown here")
    proc = _run(["chip_smoke.py"], ROOT)
    assert proc.returncode != 0 and _no_result(proc)


def test_chip_smoke_alone_fails_without_the_package(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path / "chip_smoke.py")
    proc = _run(["chip_smoke.py"], str(tmp_path))
    assert proc.returncode != 0 and _no_result(proc)
