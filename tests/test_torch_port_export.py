"""``tools/export_model_torch.py`` against the reference's ``tools/export_model.py``.

The ``npz`` export of the rich640d checkpoint must hold the reference
tool's keys and bit-equal arrays: the folded float32 parameters under
``--no-half``, and under ``--half`` the reference's bf16 values, which the
port writes widened to float32 (the reference's bf16 file is stored as raw
2-byte records that its own loader refuses).  The reference tool has no
class-count flag and builds an 80-class model, so it reads the 8-class
checkpoint here with its ``DetectionConfig`` defaulting to 8 classes.  The
``export`` format's ``.pt2`` reloads and, in float32 on the CPU, gives
``Detector.model``'s heads bit for bit and the JAX forward's within the
model test's 2e-3; ``orbax`` raises.
"""

from __future__ import annotations

import functools
import os

import numpy as np
import pytest
import torch
from click.testing import CliRunner

from tests.test_torch_port_threads import torch_threads  # noqa: F401 (autouse)
from tools.export_model_torch import export, main

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHTS = os.path.join(ROOT, "checkpoints", "rich640d", "ema_final.npz")
IMGSZ = 64


def _as_f32_bits(a: np.ndarray) -> np.ndarray:
    """float32 bit patterns of an array (bf16 raw records widened)."""
    if a.dtype.kind == "V" and a.dtype.itemsize == 2:
        return a.view(np.uint16).astype(np.uint32) << 16
    return a.astype(np.float32).view(np.uint32)


@pytest.mark.parametrize("half", ["--no-half", "--half"])
def test_npz_export_equals_the_reference_tools(half, tmp_path, monkeypatch):
    import rtmodt_tpu.config.loader as jax_loader
    from tools.export_model import main as jax_main

    monkeypatch.setattr(jax_loader, "DetectionConfig",
                        functools.partial(jax_loader.DetectionConfig, num_classes=8))
    want_path, got_path = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    res = CliRunner().invoke(jax_main, ["--weights", WEIGHTS, "--format", "npz", half,
                                        "--out", want_path])
    assert res.exit_code == 0, res.output
    assert main(["--weights", WEIGHTS, "--num-classes", "8", "--format", "npz", half,
                 "--out", got_path, "--device", "cpu"]) == 0
    with np.load(want_path) as want, np.load(got_path) as got:
        assert sorted(got.files) == sorted(want.files)
        assert len(got.files) == 126 and all(k.startswith("params/") for k in got.files)
        for k in want.files:
            assert got[k].dtype == np.float32, k
            np.testing.assert_array_equal(_as_f32_bits(got[k]), _as_f32_bits(want[k]),
                                          err_msg=k)


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """rich640d exported as float32 .pt2 (B = 2, 64 px) and as .npz, with the
    port's Detector that wrote them."""
    from rtmodt_tpu_torch.config.loader import DetectionConfig
    from rtmodt_tpu_torch.detection.detector import Detector

    d = tmp_path_factory.mktemp("export")
    pt2 = export("yolov8s", WEIGHTS, "export", IMGSZ, half=False, batch=2,
                 out=str(d / "m.pt2"), num_classes=8, device="cpu")
    npz = export("yolov8s", WEIGHTS, "npz", IMGSZ, half=False, out=str(d / "m.npz"),
                 num_classes=8, device="cpu")
    det = Detector(DetectionConfig(model="yolov8s", weights=WEIGHTS, input_size=IMGSZ,
                                   half=False, num_classes=8), device="cpu", warmup=False)
    img = np.random.default_rng(4).uniform(0, 1, (2, IMGSZ, IMGSZ, 3)).astype(np.float32)
    return pt2, npz, det, img


def test_export_program_reloads_bit_equal_to_the_module(exported):
    pt2, _, det, img = exported
    loaded = torch.export.load(pt2)
    assert loaded.example_inputs is None          # the archive holds the weights only
    program = loaded.module()
    x = torch.from_numpy(img)
    with torch.no_grad():
        got = program(x)
        want = det.model(x.permute(0, 3, 1, 2).contiguous())
    assert len(got) == 2
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == torch.float32
        assert torch.equal(g, w)


def test_export_program_matches_the_jax_forward(exported):
    import jax.numpy as jnp

    from rtmodt_tpu.models.weights import load_npz as jax_load_npz
    from rtmodt_tpu.models.yolov8 import build_model as jax_build

    pt2, npz, _, img = exported
    # the port's npz loads into the reference's folded model
    model = jax_build("yolov8s", num_classes=8, dtype=jnp.float32, fused=True)
    jb, jc = (np.asarray(t) for t in model.apply(jax_load_npz(npz), jnp.asarray(img),
                                                  train=False))
    with torch.no_grad():
        tb, tc = torch.export.load(pt2).module()(torch.from_numpy(img))
    np.testing.assert_allclose(tb.numpy(), jb, atol=2e-3)
    np.testing.assert_allclose(tc.numpy(), jc, atol=2e-3)


def test_orbax_and_missing_weights_raise(tmp_path):
    with pytest.raises(ValueError, match="JAX checkpoint format"):
        main(["--format", "orbax", "--weights", WEIGHTS, "--num-classes", "8",
              "--out", str(tmp_path / "o"), "--device", "cpu"])
    with pytest.raises(ValueError, match="--seed"):
        main(["--format", "npz", "--out", str(tmp_path / "r.npz"), "--device", "cpu"])
    assert not os.listdir(tmp_path)
