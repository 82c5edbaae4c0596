"""The port's quantization-aware fine-tune (``quant/qat.py``) against the JAX
package's on the CPU: the trained rich640d YOLOv8s (8 classes) with BN
folded, at 64 px in float32; the batches of
tests/test_torch_port_train_step.py.

  * the calibration of ``qat_finetune`` against the reference's
    ``collect_act_scales`` (one batch): the same layers, amax within 2e-6
    relative (measured 1.5e-6);
  * one fake-quant step (``make_qat_step`` with ``make_optimizer(
    constant_schedule(lr))``, the step ``qat_finetune`` takes) on the same
    frozen scales, against the reference's jitted one: its loss and
    gradient norm, and the parameters after it;
  * ``qat_finetune`` of a model whose train-mode compute dtype is bf16
    (``Trainer.qat`` on a bf16 run) trains in float32: bit-equal to the
    float32 model's run.

A fake-quant forward rounds every activation to one of 255 levels, so at
the ulp scale the rounding is chaotic: frozen scales 1e-6 relative apart
move the loss by 5.0e-4 and the parameters after the step by 8.2e-3 of a
step on average.  On the same scales the two packages agree far closer,
and each bar sits between their reading and the known-wrong run's, the
port's step with the fake-quant left out (``FakeQuantModel`` on no
scales).
Measured here, sound / without fake-quant [bar]: loss 9.6e-8 / 1.4e-2
relative [1e-5], its parts 2.5e-7 / 2.7e-2 at worst [2e-5], gradient norm
1.7e-6 / 5.9e-2 [1e-4]; after Adam's first step (about lr * sign(g) per
entry) the parameters are 3.7e-7 / 9.5e-2 of a step apart on average
[1e-4], 0 / 10.6 % of the entries more than a tenth of a step [0.1 %],
3.6e-2 / 2.0 steps at worst [half a step].
"""

from __future__ import annotations

import copy
import importlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import traverse_util

from rtmodt_tpu.models.yolov8 import build_model as jax_build
from rtmodt_tpu.quant import ptq as jax_ptq
from rtmodt_tpu_torch.models.weights import load_into, load_npz, save_npz
from rtmodt_tpu_torch.models.yolov8 import build_model
from rtmodt_tpu_torch.quant.qat import FakeQuantModel, make_qat_step, qat_finetune
from rtmodt_tpu_torch.training import train_step as pts
from tests.test_torch_port_threads import torch_threads  # noqa: F401 (autouse)
from tests.test_torch_port_train_step import S, jax_batch, jts, port_batch, synth_batch

jax_qat = importlib.import_module("rtmodt_tpu.quant.qat")
WEIGHTS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "checkpoints", "rich640d", "ema_final.npz")
NC = 8
LR = 1e-3


def fused_pair(tmp_dir):
    """(the port's fused float32 model, the reference's fused params) of the
    trained rich640d weights: QAT fine-tunes a trained model, and a
    random one leaves whole layers with gradients below Adam's eps, where
    the first update follows the gradients' rounding."""
    fused = build_model("yolov8s", NC)
    load_into(fused, load_npz(WEIGHTS))
    fused = fused.eval().fuse_bn()
    path = str(tmp_dir / "fused.npz")
    save_npz(fused, path)
    with np.load(path) as z:
        tree = traverse_util.unflatten_dict({tuple(k.split("/")): jnp.asarray(z[k])
                                             for k in z.files})
    return fused, tree["params"]


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    fused, params = fused_pair(tmp_path_factory.mktemp("qat"))
    model = jax_build("yolov8s", NC, dtype=jnp.float32, fused=True)
    batches = [synth_batch(seed=i, nc=NC) for i in range(2)]
    # the reference's qat_finetune at steps=1 and calib_batches=1, unrolled to
    # read the step's metrics: calibrate on the first batch, then step on it
    jb = [jax_batch(b) for b in batches]
    scales = jax_ptq.collect_act_scales(model, {"params": params},
                                        [jb[0].images.astype(jnp.float32) / 255.0])
    tx = jts.make_optimizer(optax.constant_schedule(LR))
    step = jax_qat.make_qat_step(jax_qat.FakeQuantModel(model, scales), tx, S)
    new_params, _, metrics = step(jax.tree.map(jnp.array, params), tx.init(params), jb[0])
    return {"fused": fused, "batches": batches, "scales": scales,
            "metrics": {k: float(v) for k, v in metrics.items()},
            "new_params": {k: np.asarray(v) for k, v in
                           traverse_util.flatten_dict(new_params, sep="/").items()}}


def port_named(sd: dict, key: str) -> np.ndarray:
    """The port's tensor of a reference key, in the reference's layout."""
    parts = key.split("/")
    got = sd[".".join(parts[:-1] + [{"kernel": "weight", "bias": "bias"}[parts[-1]]])].numpy()
    return got.transpose(2, 3, 1, 0) if got.ndim == 4 else got


def test_qat_finetune_calibrates_as_the_reference(ref):
    before = ref["fused"].c2f1.cv1.conv.weight.detach().clone()
    model, scales = qat_finetune(ref["fused"], iter(port_batch(b) for b in ref["batches"]),
                                 S, steps=1, lr=LR, calib_batches=1, log_every=0)
    assert sorted(scales) == sorted(ref["scales"]) and "stem" in scales
    for k, v in scales.items():
        np.testing.assert_allclose(v, ref["scales"][k], rtol=2e-6, err_msg=k)
    # one step was taken, on a copy: the input model is left as it was
    assert not torch.equal(model.c2f1.cv1.conv.weight.detach(), before)
    assert torch.equal(ref["fused"].c2f1.cv1.conv.weight.detach(), before)


def test_qat_finetune_runs_in_float32_whatever_the_train_dtype(ref):
    """A bf16 training config hands QAT a model whose train-mode compute
    dtype is bf16 (``Trainer.qat`` folds the bf16 run's model); the
    fine-tune still runs in float32, as the reference builds its QAT model,
    so it gives the float32 model's result bit for bit."""
    runs = []
    for dtype in (torch.float32, torch.bfloat16):
        fused = copy.deepcopy(ref["fused"])
        fused.dtype = dtype
        model, scales = qat_finetune(fused, iter(port_batch(b) for b in ref["batches"]), S,
                                     steps=2, lr=LR, calib_batches=1, log_every=0)
        runs.append((model.state_dict(), scales))
    (sd32, sc32), (sd16, sc16) = runs
    assert sc16 == sc32
    assert sd16.keys() == sd32.keys()
    assert all(torch.equal(sd16[k], sd32[k]) for k in sd32)


def test_one_fake_quant_step_on_the_same_scales(ref):
    fq = FakeQuantModel(ref["fused"], ref["scales"])
    tx = pts.make_optimizer(pts.constant_schedule(LR))
    metrics = make_qat_step(fq, tx, S)(tx.init(dict(fq.model.named_parameters())),
                                       port_batch(ref["batches"][0]))
    want = ref["metrics"]
    np.testing.assert_allclose(float(metrics["loss"]), want["loss"], rtol=1e-5)
    for key in ("box_loss", "cls_loss", "dfl_loss"):
        np.testing.assert_allclose(float(metrics[key]), want[key], rtol=2e-5, err_msg=key)
    np.testing.assert_allclose(float(metrics["grad_norm"]), want["grad_norm"], rtol=1e-4)
    sd = fq.model.state_dict()
    gaps = np.concatenate([np.abs(port_named(sd, k) - v).ravel()
                           for k, v in ref["new_params"].items()])
    assert gaps.size == sum(p.numel() for p in fq.parameters())
    assert gaps.max() <= 0.5 * LR
    assert gaps.mean() <= 1e-4 * LR
    assert (gaps > 0.1 * LR).mean() <= 1e-3
