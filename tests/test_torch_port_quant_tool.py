"""``tools/run_inference_torch.py detect --quant int8 --quant-scales`` against
``tools/run_inference.py`` on the CPU.

Both tools run rich640d's ``qat_final.npz`` with its frozen
``qat_act_scales.npz`` at 256 px in float32 over the dense image sequence of
tests/test_torch_port_run_inference.py, the reference's forward op by op
(``jax.disable_jit``, as tests/test_quant.py runs the int8 forward; see
tests/test_torch_port_quant_qat.py for why not the jitted one): the same
predictions, boxes and scores within the int8 bars of
tests/test_torch_port_quant.py (measured here: 6.1e-5 px, 1.8e-7) and every
metric within 0.01 (measured: equal).
"""

from __future__ import annotations

import json

import jax
import numpy as np

from tests.test_torch_port_quant import BOX_TOL, SCORE_TOL
from tests.test_torch_port_quant_qat import INT8
from tests.test_torch_port_run_inference import _run_both, float32, scene  # noqa: F401
from tests.test_torch_port_threads import torch_threads  # noqa: F401 (autouse)


def test_run_inference_detect_int8_matches_the_reference(scene, tmp_path, capsys,  # noqa: F811
                                                         float32):  # noqa: F811
    args = ["detect", "--images", str(scene / "img"), "--gt-json", str(scene / "gt.json"),
            "--num-classes", "8", "--input-size", "256", "--conf", "0.25", "--evaluate",
            "--quant", "int8", "--weights", INT8["weights"],
            "--quant-scales", INT8["quant_scales"]]
    with jax.disable_jit():       # the reference's int8 forward op by op (see above)
        got_m, want_m, port_out, ref_out = _run_both(args, tmp_path, capsys)
    with open(port_out) as f:
        got = json.load(f)
    with open(ref_out) as f:
        want = json.load(f)
    assert len(got) == len(want) > 10
    # a near-tie of two scores may order two predictions of an image either way
    key = lambda p: (p["image_id"], p["category_id"], p["bbox"][0])  # noqa: E731
    got, want = sorted(got, key=key), sorted(want, key=key)
    assert [(p["image_id"], p["category_id"]) for p in got] == \
        [(p["image_id"], p["category_id"]) for p in want]
    np.testing.assert_allclose([p["bbox"] for p in got], [p["bbox"] for p in want],
                               rtol=0, atol=BOX_TOL)
    np.testing.assert_allclose([p["score"] for p in got], [p["score"] for p in want],
                               rtol=0, atol=SCORE_TOL)
    assert set(got_m) == set(want_m) and want_m["mAP"] > 0.3
    for k, v in want_m.items():
        assert abs(got_m[k] - v) <= 0.01, k
