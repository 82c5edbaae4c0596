"""The port's YOLOv8 train mode, loss gradients, optimizer and train step
against the JAX package's, on the CPU in float32 (yolov8n, 4 classes, 64 px,
B = 2, M = 4, the batch of tests/test_training.py's ``synth_batch`` with
uint8 images), from the same variables (the port's from-scratch init, read
into the reference through ``save_npz``).

Each result is also held to the port's own float64 run of the same batch:
BN's batch statistics ``E[x^2] - E[x]^2`` cancel, and XLA's CPU reductions
sum in an order that leaves the reference's float32 ~5x further from the
float64 run than the port's.  Measured here (against the reference /
against float64; bars in brackets): train-mode heads 4.6e-4 / 8.9e-5 [2e-3
/ 2e-4; the reference is 4.3e-4 from float64], BN running statistics after
the forward 3.3e-6 / 6.4e-7 [1e-5 / 1e-6]; loss parts 1.1e-5 / 1.2e-5
relative at worst (dfl, box) [2e-4 / 5e-5], num_fg equal; gradients 7.2e-4 /
1.4e-4 of each tensor's max |g| at worst, both in
``neck_bu5.m0.cv1.conv.weight`` [1.5e-3 / 3e-4; the reference is 6.4e-4
from float64 in ``down1.bn.weight``].

The BN running variance (flax's biased fast variance, momentum 0.97) has a
test that torch's stock ``BatchNorm2d`` fails; the optimizer's are in
tests/test_torch_port_train_optim.py.
"""

from __future__ import annotations

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import traverse_util

from rtmodt_tpu.models.yolov8 import build_model as jax_build
from rtmodt_tpu.training.loss import yolo_loss as jax_yolo_loss
from rtmodt_tpu_torch.models.weights import load_into, save_npz
from rtmodt_tpu_torch.models.yolov8 import build_model, init_params
from rtmodt_tpu_torch.training import train_step as pts
from rtmodt_tpu_torch.training.loss import yolo_loss
from rtmodt_tpu_torch.training.trainer import ema_decay_at, ema_update
from tests.test_torch_port_threads import torch_threads  # noqa: F401 (autouse)

jts = importlib.import_module("rtmodt_tpu.training.train_step")

S, B, M, NC = 64, 2, 4, 4


def synth_batch(seed=0, b=B, m=M, s=S, nc=NC):
    """tests/test_training.py's batch, with uint8 images."""
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (b, s, s, 3), dtype=np.uint8)
    boxes = np.zeros((b, m, 4), np.float32)
    labels = np.zeros((b, m), np.int32)
    mask = np.zeros((b, m), bool)
    for i in range(b):
        for j in range(rng.integers(1, m + 1)):
            x1, y1 = rng.uniform(0, s - 20, 2)
            w, h = rng.uniform(8, 20, 2)
            boxes[i, j] = (x1, y1, min(x1 + w, s), min(y1 + h, s))
            labels[i, j] = rng.integers(0, nc)
            mask[i, j] = True
    return images, boxes, labels, mask


def jax_batch(arrs):
    return jts.Batch(*(jnp.asarray(a) for a in arrs))


def port_batch(arrs):
    return pts.Batch(*(torch.from_numpy(np.array(a)) for a in arrs))


def flat(tree) -> dict[str, np.ndarray]:
    return {k: np.asarray(v) for k, v in traverse_util.flatten_dict(tree, sep="/").items()}


def seeded_variables(tmp_dir) -> dict:
    """Flax variables of the port's from-scratch init (seed 0), through
    ``save_npz``: the same weights in both packages without compiling the
    reference's ``init``."""
    path = str(tmp_dir / "init.npz")
    save_npz(init_params(build_model("yolov8n", NC), torch.Generator().manual_seed(0)), path)
    with np.load(path) as z:
        tree = traverse_util.unflatten_dict({tuple(k.split("/")): jnp.asarray(z[k])
                                             for k in z.files})
    return {"params": tree["params"], "batch_stats": tree["batch_stats"]}


def port_model(variables):
    m = build_model("yolov8n", NC)
    load_into(m, flat(variables))
    return m


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """Every JAX reference of this module, computed once."""
    model = jax_build("yolov8n", NC, dtype=jnp.float32)
    variables = seeded_variables(tmp_path_factory.mktemp("init"))
    # non-trivial running statistics, so the momentum update is visible
    rng = np.random.default_rng(3)
    variables = {"params": variables["params"], "batch_stats": jax.tree.map(
        lambda v: jnp.asarray(rng.uniform(0.5, 1.5, v.shape).astype(np.float32)),
        variables["batch_stats"])}
    arrs = synth_batch()
    batch = jax_batch(arrs)
    images = batch.images.astype(jnp.float32) / 255.0

    def loss_fn(params):
        (bd, cl), mut = model.apply({"params": params, "batch_stats": variables["batch_stats"]},
                                    images, train=True, mutable=["batch_stats"])
        lb = jax_yolo_loss(bd, cl, batch.gt_boxes, batch.gt_labels, batch.gt_mask, S)
        return lb.total, (lb, bd, cl, mut["batch_stats"])

    (_, (lb, bd, cl, stats)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"])
    return {"variables": variables, "lb": lb, "heads": (np.asarray(bd), np.asarray(cl)),
            "stats": flat(stats), "grads": flat(grads),
            "f64": port_forward_loss_grads(variables, torch.float64)}


def port_forward_loss_grads(variables, dtype):
    """The port's train-mode heads, loss and gradients on the module's
    batch, the model and inputs in ``dtype``."""
    m = port_model(variables).to(dtype)
    m.dtype = dtype
    m.train()
    imgs, boxes, labels, mask = synth_batch()
    bd, cl = m(pts.to_model_input(torch.from_numpy(imgs)).to(dtype))
    lb = yolo_loss(bd, cl, torch.from_numpy(boxes).to(dtype), torch.from_numpy(labels),
                   torch.from_numpy(mask), S)
    params = dict(m.named_parameters())
    grads = torch.autograd.grad(lb.total, list(params.values()))
    return {"model": m, "heads": (bd.detach().double().numpy(), cl.detach().double().numpy()),
            "lb": {k: float(getattr(lb, k).detach()) for k in ("total", "box", "cls", "dfl")},
            "num_fg": int(lb.num_fg),
            "grads": {k: g.double().numpy() for k, g in zip(params, grads)}}


def jax_grads_by_port_name(ref) -> dict[str, np.ndarray]:
    """The reference's gradients under the port's names, OIHW."""
    leaf = {"kernel": "weight", "bias": "bias", "scale": "weight"}
    out = {}
    for key, g in ref["grads"].items():
        parts = key.split("/")
        name = ".".join(parts[:-1] + [leaf[parts[-1]]])
        out[name] = g.transpose(3, 2, 0, 1) if g.ndim == 4 else g
    return out


def test_train_mode_forward_and_bn_running_stats(ref):
    """Heads near the reference's and nearer the port's float64 run than the
    reference is; BN running statistics after the forward."""
    m = port_model(ref["variables"]).train()
    x = pts.to_model_input(torch.from_numpy(synth_batch()[0]))
    with torch.no_grad():
        bd, cl = m(x)
    for got, want, exact in zip((bd, cl), ref["heads"], ref["f64"]["heads"]):
        got = got.double().numpy()
        assert np.abs(got - want).max() <= 2e-3
        assert np.abs(got - exact).max() <= 2e-4
        assert np.abs(got - exact).max() <= np.abs(want - exact).max()
    sd = m.state_dict()
    exact_sd = ref["f64"]["model"].state_dict()
    for key, want in ref["stats"].items():
        path = key.split("/")
        name = ".".join(path[:-2] + ["bn", "running_mean" if path[-1] == "mean" else "running_var"])
        np.testing.assert_allclose(sd[name].numpy(), want, rtol=0, atol=1e-5, err_msg=key)
        np.testing.assert_allclose(sd[name].numpy(), exact_sd[name].numpy(), rtol=0, atol=1e-6,
                                   err_msg=key)


def test_torch_batchnorm_running_var_is_not_the_references(ref):
    """torch's BatchNorm2d (momentum 0.03 = flax's 0.97) updates the running
    variance with the unbiased batch variance, ``n / (n - 1)`` times flax's
    biased one: at B = 2 on a 2x2 map, 8/7.  The port's train-mode ConvBN
    takes flax's; the stock module misses it by far more than the bar."""
    m = port_model(ref["variables"]).train()
    cb = m.head.box2_0                      # a ConvBN on the 2x2 level at 64 px
    cb.bn.reset_running_stats()
    x = torch.rand(B, cb.conv.in_channels, 2, 2, generator=torch.Generator().manual_seed(1)) * 8
    with torch.no_grad():
        y = cb.conv(x)
        cb(x)
        mu = y.mean(dim=(0, 2, 3))
        biased = torch.clamp((y * y).mean(dim=(0, 2, 3)) - mu * mu, min=0.0)
        flax_var = 0.97 * torch.ones_like(biased) + (1.0 - 0.97) * biased
        stock = torch.nn.BatchNorm2d(y.shape[1], eps=1e-3, momentum=0.03).train()
        stock(y)
    np.testing.assert_allclose(cb.bn.running_var.numpy(), flax_var.numpy(), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose((stock.running_var - 0.97).numpy(),
                               (8 / 7 * (flax_var - 0.97)).numpy(), rtol=1e-4)
    assert float((stock.running_var - flax_var).abs().max()) > 100 * 1e-6


def test_loss_parts_and_gradients(ref):
    """Loss parts, num_fg, and each gradient against the reference's and the
    port's float64 run, relative to the tensor's max |g|."""
    got = port_forward_loss_grads(ref["variables"], torch.float32)
    exact = ref["f64"]
    for part in ("total", "box", "cls", "dfl"):
        want = float(getattr(ref["lb"], part))
        np.testing.assert_allclose(got["lb"][part], want, rtol=2e-4, err_msg=part)
        np.testing.assert_allclose(got["lb"][part], exact["lb"][part], rtol=5e-5, err_msg=part)
    assert got["num_fg"] == int(ref["lb"].num_fg) == exact["num_fg"] > 0
    want_g = jax_grads_by_port_name(ref)
    assert sorted(want_g) == sorted(got["grads"])
    worst_ref = worst_exact = (0.0, "")
    for name, g in got["grads"].items():
        scale = max(float(np.abs(exact["grads"][name]).max()), 1e-12)
        worst_ref = max(worst_ref, (float(np.abs(g - want_g[name]).max()) / scale, name))
        worst_exact = max(worst_exact, (float(np.abs(g - exact["grads"][name]).max()) / scale,
                                        name))
    assert worst_ref[0] <= 1.5e-3, f"against the reference: {worst_ref}"
    assert worst_exact[0] <= 3e-4, f"against float64: {worst_exact}"
