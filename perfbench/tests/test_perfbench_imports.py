"""Nothing the harness runs imports JAX or the JAX package, and the plain
reference imports nothing of the program: top-level module names compared
whole (the program's package name begins with the JAX package's)."""

from __future__ import annotations

import json
import subprocess
import sys

from perfbench import manifest

FORBIDDEN = {"jax", "jaxlib", "flax", "rtmodt_tpu"}


def _loaded_top_levels(code: str) -> set[str]:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                          "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
                         cwd=manifest.ROOT, capture_output=True, text=True, timeout=300,
                         env={"PYTHONPATH": manifest.ROOT, "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_and_program_path_load_no_jax():
    mods = _loaded_top_levels(
        "import perfbench.bench, perfbench.check, perfbench.control, perfbench.devtrace\n"
        "import perfbench.reference.yolo, perfbench.reference.pack\n"
        "import perfbench.reference.bytetrack, perfbench.reference.zones\n"
        "import rtmodt_tpu_torch.parallel.multistream, rtmodt_tpu_torch.ops.yuv\n"
        "import rtmodt_tpu_torch.events.zone_engine, rtmodt_tpu_torch._build\n"
        "import rtmodt_tpu_torch.tracking.bytetrack, rtmodt_tpu_torch.config.loader")
    assert "rtmodt_tpu_torch" in mods
    assert not mods & FORBIDDEN


def test_reference_imports_nothing_of_the_program():
    mods = _loaded_top_levels(
        "import perfbench.check, perfbench.scenes, perfbench.flops\n"
        "import perfbench.reference.yolo, perfbench.reference.pack\n"
        "import perfbench.reference.bytetrack, perfbench.reference.zones\n"
        "from perfbench import manifest\n"
        "manifest.arch_module({}).load_reference, manifest.arch_module({}).detect")
    assert "rtmodt_tpu_torch" not in mods
    assert not mods & FORBIDDEN


def test_forbidden_check_compares_whole_names(monkeypatch):
    from perfbench import bench

    monkeypatch.setitem(sys.modules, "rtmodt_tpu_torch_fake_probe", sys)
    assert "rtmodt_tpu" not in bench.forbidden_modules()
    monkeypatch.setitem(sys.modules, "rtmodt_tpu.fake_probe", sys)
    assert bench.forbidden_modules() == ["rtmodt_tpu"]
