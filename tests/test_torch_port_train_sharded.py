"""The port's data-parallel train step (``make_sharded_train_step`` over
CPU ranks of ``parallel/mesh.py``) against the JAX package's
``make_sharded_train_step`` on a mesh of the same size (the conftest's
virtual CPU devices), and against the port's one-process step at the global
batch; yolov8n, 4 classes, 64 px, global B = 4 (tests/test_training.py's
batches with uint8 images), float32.

The JAX step runs with an optax transformation whose state keeps the
gradients (and whose update is zero), so one compiled step per mesh gives
the reference's all-reduced gradients, loss parts, ``num_fg``, gradient
norm and BN running statistics (the mesh of 4 is in
tests/test_torch_port_train_sharded4.py: each JAX step compiles in ~18 s).  The bars are those of the single-device
test (tests/test_torch_port_train_step.py): loss parts 2e-4 relative,
num_fg equal, BN running statistics 1e-5, each gradient 1.5e-3 of its
tensor's max |g|; the global gradient norm 1.5e-3 relative.

Against the port's one-process step at B = 4 (two AdamW steps, lr 1e-3
after a zero first update), which differs only in the order of float32
sums: metrics 2e-5 relative, parameters 1e-4 absolute (bars about four times
the gaps measured here), BN running statistics 1e-6.  Every rank's
parameters and BN statistics are bit-identical.  A global batch the mesh
does not divide is refused.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rtmodt_tpu.models.yolov8 import build_model as jax_build
from rtmodt_tpu.parallel.mesh import create_mesh as jax_create_mesh
from rtmodt_tpu.parallel.mesh import replicate as jax_replicate
from rtmodt_tpu_torch.parallel import mesh as M
from rtmodt_tpu_torch.parallel.ranks import train_steps
from rtmodt_tpu_torch.training import train_step as pts
from tests.test_torch_port_threads import torch_threads  # noqa: F401 (autouse)
from tests.test_torch_port_train_step import (NC, S, flat, jax_batch, jax_grads_by_port_name,
                                              jts, port_batch, port_model, seeded_variables,
                                              synth_batch)

B = 4
OPT = {"lr0": 1e-3, "lrf": 0.01, "total": 8, "warmup": 1}


def grad_capture() -> optax.GradientTransformation:
    """Zero updates; the state after an update is that update's gradients."""
    return optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g))


@pytest.fixture(scope="module")
def variables(tmp_path_factory):
    return seeded_variables(tmp_path_factory.mktemp("init"))


def jax_sharded_reference(variables, n: int) -> dict:
    """One step of the JAX sharded step on a mesh of n virtual devices."""
    model = jax_build("yolov8n", NC, dtype=jnp.float32)
    tx = grad_capture()
    mesh = jax_create_mesh(n)
    # a copy: the step donates its state, which may alias the arrays
    copy = jax.tree.map(lambda x: jnp.array(x, copy=True), variables)
    state = jax_replicate(jts.create_train_state(model, tx, S, None, init_variables=copy), mesh)
    step, put = jts.make_sharded_train_step(model, tx, S, mesh)
    new, m = step(state, put(jax_batch(synth_batch(seed=0, b=B))))
    return {"metrics": {k: float(v) for k, v in m.items()},
            "grads": jax_grads_by_port_name({"grads": flat(new.opt_state)}),
            "stats": flat(new.batch_stats)}


def spec(variables, optimizer, steps=1) -> dict:
    return {"model": "yolov8n", "num_classes": NC, "input_size": S,
            "state": port_model(variables).state_dict(), "optimizer": optimizer,
            "batches": [synth_batch(seed=i, b=B) for i in range(steps)]}


def assert_ranks_identical(out):
    for r in out[1:]:
        for k, v in out[0]["state"].items():
            assert torch.equal(r["state"][k], v), k


def check_against_reference(variables, want: dict, n: int) -> None:
    """The port's step on n CPU ranks against the JAX step on n devices."""
    out = M.spawn(train_steps, M.create_mesh(devices=["cpu"] * n), spec(variables, None),
                  timeout=240)
    assert_ranks_identical(out)
    got = out[0]["metrics"][0]
    for k in ("loss", "box_loss", "cls_loss", "dfl_loss"):
        np.testing.assert_allclose(got[k], want["metrics"][k], rtol=2e-4, err_msg=k)
    assert int(got["num_fg"]) == int(want["metrics"]["num_fg"]) > 0
    np.testing.assert_allclose(got["grad_norm"], want["metrics"]["grad_norm"], rtol=1.5e-3)
    for r in out:
        grads = r["grads"][0]
        assert sorted(grads) == sorted(want["grads"])
        worst = max((float(np.abs(g.double().numpy() - want["grads"][k]).max())
                     / max(float(np.abs(want["grads"][k]).max()), 1e-12), k)
                    for k, g in grads.items())
        assert worst[0] <= 1.5e-3, f"rank {r['rank']}: {worst}"
    sd = out[0]["state"]
    for key, v in want["stats"].items():
        path = key.split("/")
        name = ".".join(path[:-2] + ["bn", "running_mean" if path[-1] == "mean" else "running_var"])
        np.testing.assert_allclose(sd[name].numpy(), v, rtol=0, atol=1e-5, err_msg=key)


def test_sharded_step_matches_the_references_on_a_mesh_of_2(variables):
    check_against_reference(variables, jax_sharded_reference(variables, 2), 2)


def test_sharded_step_matches_the_one_process_step(variables):
    out = M.spawn(train_steps, M.create_mesh(devices=["cpu"] * 2), spec(variables, OPT, 2),
                  timeout=240)
    assert_ranks_identical(out)
    m = port_model(variables)
    tx = pts.make_optimizer(pts.make_schedule(OPT["lr0"], OPT["lrf"], OPT["total"],
                                              OPT["warmup"]))
    state = pts.TrainState(m, tx.init(dict(m.named_parameters())))
    for i in range(2):
        state, want = pts.train_step(state, port_batch(synth_batch(seed=i, b=B)), tx=tx,
                                     input_size=S)
        got = out[0]["metrics"][i]
        for k, v in want.items():
            np.testing.assert_allclose(got[k], float(v), rtol=2e-5, err_msg=f"{k} @ {i}")
    for k, v in m.state_dict().items():
        got = out[0]["state"][k]
        if k.endswith("num_batches_tracked"):
            continue
        tol = 1e-6 if "running" in k else 1e-4
        np.testing.assert_allclose(got.numpy(), v.numpy(), rtol=0, atol=tol, err_msg=k)


def test_a_batch_the_mesh_does_not_divide_is_refused(tmp_path):
    mesh = M.Mesh((torch.device("cpu"),) * 2, distributed=True)   # rank 0 of 2, as in spawn
    m = port_model(seeded_variables(tmp_path))
    tx = pts.make_optimizer(pts.make_schedule(1e-3, 0.01, 8, 1))
    _, put_batch = pts.make_sharded_train_step(m, tx, S, mesh)
    with pytest.raises(ValueError, match="does not split over a mesh of 2"):
        put_batch(port_batch(synth_batch(seed=0, b=3)))
    with pytest.raises(RuntimeError, match="trains in 2 ranks"):
        pts.make_sharded_train_step(m, tx, S, M.Mesh(mesh.devices))
