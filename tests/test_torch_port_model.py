"""The port's YOLOv8 (rtmodt_tpu_torch/models) against the JAX model.

``params_from_jax`` carries the Flax variables of ``build_model(...)`` into
the port; the forward in float32 must match ``apply`` below 1e-4 on the box
and class heads (conv summation order differs between XLA and PyTorch by
~1e-6 relative per layer).  The planar-I420 front (``planar_letterbox`` +
full model) is bounded against the reference's packed planar-stem front at
2e-3, the bound ``tests/test_model_transforms.py`` uses: that front folds the
colour conversion into the stem conv and skips the [0, 1] clip.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from rtmodt_tpu.models.weights import fuse_bn as jax_fuse_bn
from rtmodt_tpu.models.yolov8 import build_model as jax_build
from rtmodt_tpu.models.yolov8 import make_anchors as jax_anchors
from rtmodt_tpu_torch.models.weights import is_fused, load_into, load_npz, params_from_jax
from rtmodt_tpu_torch.models.yolov8 import build_model, make_anchors
from tests.test_torch_port_threads import torch_threads  # noqa: F401 (autouse)

ATOL = 1e-4
CKPT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "checkpoints", "rich640d")


def _flat(variables) -> dict[str, np.ndarray]:
    return {k: np.asarray(v) for k, v in
            traverse_util.flatten_dict(variables, sep="/").items()}


@pytest.fixture(scope="module")
def jax_pair():
    """yolov8n (8 classes) variables with non-trivial BN stats + 2 images."""
    model = jax_build("yolov8n", num_classes=8, dtype=jnp.float32)
    variables = model.init(jax.random.PRNGKey(3), jnp.zeros((1, 128, 128, 3)), train=False)
    flat = _flat(variables)
    rng = np.random.default_rng(5)
    for k, v in flat.items():
        if k.endswith("bn/mean"):
            flat[k] = rng.normal(0, 0.2, v.shape).astype(np.float32)
        elif k.endswith("bn/var"):
            flat[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        elif k.endswith("bn/scale"):
            flat[k] = rng.normal(1.0, 0.1, v.shape).astype(np.float32)
        elif k.endswith("bn/bias"):
            flat[k] = rng.normal(0.0, 0.1, v.shape).astype(np.float32)
    img = rng.uniform(0, 1, (2, 128, 128, 3)).astype(np.float32)
    return model, flat, img


def _port_forward(model, img):
    with torch.no_grad():
        b, c = model(torch.from_numpy(img).permute(0, 3, 1, 2).contiguous())
    return b.numpy(), c.numpy()


@pytest.mark.parametrize("fused", [False, True])
def test_forward_matches_jax(jax_pair, fused):
    model, flat, img = jax_pair
    variables = traverse_util.unflatten_dict(flat, sep="/")
    if fused:
        variables = jax_fuse_bn(variables)
        model = jax_build("yolov8n", num_classes=8, dtype=jnp.float32, fused=True)
    jb, jc = (np.asarray(x) for x in model.apply(variables, img, train=False))
    port = build_model("yolov8n", 8, fused=fused).eval()
    load_into(port, _flat(variables))
    tb, tc = _port_forward(port, img)
    assert tb.shape == jb.shape == (2, 336, 64) and tc.shape == jc.shape == (2, 336, 8)
    assert np.max(np.abs(tb - jb)) < ATOL
    assert np.max(np.abs(tc - jc)) < ATOL


def test_port_side_bn_folding_matches_jax_unfused(jax_pair):
    model, flat, img = jax_pair
    jb, jc = (np.asarray(x) for x in
              model.apply(traverse_util.unflatten_dict(flat, sep="/"), img, train=False))
    port = build_model("yolov8n", 8).eval()
    load_into(port, flat)
    tb, tc = _port_forward(port.fuse_bn(), img)
    assert np.max(np.abs(tb - jb)) < ATOL and np.max(np.abs(tc - jc)) < ATOL


def test_params_from_jax_maps_layouts(jax_pair):
    _, flat, _ = jax_pair
    sd = params_from_jax(flat)
    k = flat["params/stem/conv/kernel"]                      # HWIO
    np.testing.assert_array_equal(sd["stem.conv.weight"].numpy(), k.transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(sd["c2f1.m0.cv1.bn.running_var"].numpy(),
                                  flat["batch_stats/c2f1/m0/cv1/bn/var"])
    np.testing.assert_array_equal(sd["head.cls2_2.bias"].numpy(),
                                  flat["params/head/cls2_2/bias"])
    assert len(sd) == len(flat)
    with pytest.raises(KeyError):
        params_from_jax({"opt_state/x/y": np.zeros(1)})


def test_rich640d_checkpoint_loads_shape_checked():
    flat = load_npz(os.path.join(CKPT, "ema_final.npz"))
    assert len(flat) == 297 and not is_fused(flat)
    model = build_model("yolov8s", 8)
    load_into(model, flat)                                    # raises on any mismatch
    np.testing.assert_array_equal(model.head.box1_2.weight.detach().numpy(),
                                  flat["params/head/box1_2/kernel"].transpose(3, 2, 0, 1))
    with pytest.raises(ValueError):
        load_into(build_model("yolov8n", 8), flat)


def test_bn_folded_checkpoint_loads_into_the_pipeline_model():
    """qat_final.npz has BN folded (conv biases, no BN, 126 keys)."""
    from rtmodt_tpu_torch.config import load_config
    from rtmodt_tpu_torch.runtime.pipeline import build_detector

    path = os.path.join(CKPT, "qat_final.npz")
    flat = load_npz(path)
    assert len(flat) == 126 and is_fused(flat)
    cfg = load_config(overrides={"detection": {"num_classes": 8, "weights": path,
                                               "half": False}})
    model = build_detector(cfg, torch.device("cpu"))
    np.testing.assert_array_equal(model.stem.conv.bias.detach().numpy(),
                                  flat["params/stem/conv/bias"])
    cfg.detection.fuse_bn = False
    with pytest.raises(ValueError, match="BN folded"):
        build_detector(cfg, torch.device("cpu"))


def test_make_anchors_matches_jax():
    for size in (128, 640):
        ta, ts = make_anchors(size)
        ja, js = jax_anchors(size)
        np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_planar_front_gap_to_reference_packed_front(jax_pair):
    """Port: planar_letterbox + full forward.  Reference: its packed front
    (pad_planes + planar_stem_apply + skip_stem), as test_model_transforms
    bounds it against the reference's own planar_letterbox path."""
    from rtmodt_tpu.ops.planar_stem import pad_planes, planar_stem_apply
    from rtmodt_tpu.ops.yuv import pack_i420_planar
    from rtmodt_tpu.utils.synthetic import moving_boxes_frame
    from rtmodt_tpu_torch.ops.yuv import planar_letterbox

    model, flat, _ = jax_pair
    variables = traverse_util.unflatten_dict(flat, sep="/")
    S = 160
    frame = moving_boxes_frame(3, 180, 320, 4)[0]
    (y, u, v), meta = pack_i420_planar(frame, S)
    yp, up, vp = pad_planes(jnp.asarray(y)[None], jnp.asarray(u)[None],
                            jnp.asarray(v)[None], S, meta.pad_left, meta.pad_top)
    feats = planar_stem_apply(variables["params"]["stem"], variables["batch_stats"]["stem"],
                              yp, up, vp, dtype=jnp.float32)
    jb, jc = (np.asarray(x) for x in
              model.apply(variables, feats, train=False, skip_stem=True))

    port = build_model("yolov8n", 8).eval()
    load_into(port, flat)
    img = planar_letterbox(torch.from_numpy(y)[None], torch.from_numpy(u)[None],
                           torch.from_numpy(v)[None], S, meta.pad_left, meta.pad_top,
                           dtype=torch.float32)
    with torch.no_grad():
        tb, tc = port(img.permute(0, 3, 1, 2).contiguous())
    np.testing.assert_allclose(tb.numpy(), jb, atol=2e-3)
    np.testing.assert_allclose(tc.numpy(), jc, atol=2e-3)
