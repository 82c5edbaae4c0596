"""The port's optimizer, schedule, clipping, EMA, init and five end-to-end
train steps against the JAX package's, on the CPU in float32 (yolov8n, 4
classes, 64 px, B = 2, M = 4; the batches of
tests/test_torch_port_train_step.py).

Measured here (bars in brackets): the optimizer fed optax's own gradients
for 6 updates across the warmup boundary (clipped at every one): params 2.4e-7
apart at worst, one float32 ulp of values near 3 [1e-7 + 2.4e-7 |p|, two
ulp], lr equal at every update (0 at the first, as optax); five end-to-end
steps from the same variables at training.yaml's lr0 and lrf: total loss
6.2e-6 relative at worst [1e-4], box / cls / dfl 2.3e-4 / 6.2e-6 / 2.2e-4
[1e-3], grad_norm 2.2e-4 [5e-3] (the reference's float32 BN statistics
carry ~5x the port's rounding, tests/test_torch_port_train_step.py),
num_fg equal; EMA [1e-7].

The first update at lr = 0 and optax's clipping rule each have a test that
the torch stock piece (``optim.AdamW``, ``clip_grad_norm_``) fails.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rtmodt_tpu.models.yolov8 import build_model as jax_build
from rtmodt_tpu_torch.models.yolov8 import build_model, init_params
from rtmodt_tpu_torch.training import train_step as pts
from rtmodt_tpu_torch.training.trainer import ema_decay_at, ema_update
from tests.test_torch_port_threads import torch_threads  # noqa: F401 (autouse)
from tests.test_torch_port_train_step import (NC, S, jax_batch, jts, port_batch, port_model,
                                              seeded_variables, synth_batch)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """Five steps of the reference's jitted train_step: training.yaml's lr0
    0.001 and lrf 0.01, warmup 2 of 8 steps."""
    model = jax_build("yolov8n", NC, dtype=jnp.float32)
    variables = seeded_variables(tmp_path_factory.mktemp("init"))
    tx = jts.make_optimizer(jts.make_schedule(0.001, 0.01, 8, 2))
    state = jts.create_train_state(model, tx, S, None, init_variables=variables)
    step = jax.jit(lambda st, bt: jts.train_step(st, bt, model=model, tx=tx, input_size=S))
    losses = []
    for i in range(5):
        state, m = step(state, jax_batch(synth_batch(seed=i)))
        losses.append({k: float(v) for k, v in m.items()})
    return {"variables": variables, "steps": losses}


def test_five_end_to_end_steps(ref):
    m = port_model(ref["variables"])
    tx = pts.make_optimizer(pts.make_schedule(0.001, 0.01, 8, 2))
    state = pts.TrainState(m, tx.init(dict(m.named_parameters())))
    for i, want in enumerate(ref["steps"]):
        state, got = pts.train_step(state, port_batch(synth_batch(seed=i)), tx=tx, input_size=S)
        np.testing.assert_allclose(float(got["loss"]), want["loss"], rtol=1e-4, err_msg=f"@ {i}")
        for k in ("box_loss", "cls_loss", "dfl_loss"):
            np.testing.assert_allclose(float(got[k]), want[k], rtol=1e-3, err_msg=f"{k} @ {i}")
        np.testing.assert_allclose(float(got["grad_norm"]), want["grad_norm"], rtol=5e-3,
                                   err_msg=f"grad_norm @ {i}")
        assert int(got["num_fg"]) == int(want["num_fg"])
    assert state.step == 5


def _optax_and_port(n_steps: int, warmup: int, seed: int = 0, clip: float = 10.0):
    rng = np.random.default_rng(seed)
    shapes = {"a/kernel": (3, 3, 4, 8), "a/bias": (8,), "b/scale": (8,), "c/kernel": (8, 5)}
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (rng.normal(size=s) * 4).astype(np.float32) for k, s in shapes.items()}
             for _ in range(n_steps)]
    sched = jts.make_schedule(0.01, 0.05, 12, warmup)
    tx = jts.make_optimizer(sched, clip_norm=clip)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    st = tx.init(jp)
    port_sched = pts.make_schedule(0.01, 0.05, 12, warmup)
    ptx = pts.make_optimizer(port_sched, clip_norm=clip)
    pp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    pst = ptx.init(pp)
    out = []
    for i, g in enumerate(grads):
        upd, st = tx.update({k: jnp.asarray(v) for k, v in g.items()}, st, jp)
        jp = optax.apply_updates(jp, upd)
        _, lr = ptx.update({k: torch.from_numpy(v) for k, v in g.items()}, pst, pp)
        out.append((i, float(sched(i)), lr, {k: np.asarray(v) for k, v in jp.items()},
                    {k: v.numpy().copy() for k, v in pp.items()}))
    return params, out


def test_optimizer_matches_optax_across_the_warmup_boundary():
    params, out = _optax_and_port(6, warmup=3)
    assert out[0][2] == 0.0          # lr = 0 on the first update, as optax
    for k, v in out[0][4].items():    # so the first update leaves every tensor as it was
        np.testing.assert_array_equal(v, params[k])
    for i, want_lr, lr, jp, pp in out:
        assert lr == want_lr, (i, lr, want_lr)
        for k in jp:
            # the last bit may differ: XLA sums the global norm in another order
            np.testing.assert_allclose(pp[k], jp[k], rtol=2.4e-7, atol=1e-7, err_msg=f"{k} @ {i}")


def test_torch_adamw_moves_on_the_first_update():
    """torch.optim.AdamW at the schedule's peak changes the parameters on the
    first step; the reference's (and the port's) first step uses lr = 0."""
    p = torch.nn.Parameter(torch.ones(4, 4))
    p.grad = torch.ones(4, 4)
    torch.optim.AdamW([p], lr=0.01, betas=(0.937, 0.999), weight_decay=0.0005).step()
    assert not torch.equal(p.detach(), torch.ones(4, 4))


def test_clipping_is_optax_rule_not_clip_grad_norm():
    """Above the limit optax scales by ``max_norm / norm``; torch's
    ``clip_grad_norm_`` by ``max_norm / (norm + 1e-6)``, visible at a small
    limit."""
    g = np.random.default_rng(1).normal(size=(16,)).astype(np.float32) * 2e-3
    max_norm = 1e-3
    upd, _ = optax.clip_by_global_norm(max_norm).update({"g": jnp.asarray(g)}, None)
    want = np.asarray(upd["g"])
    got = pts.clip_by_global_norm({"g": torch.from_numpy(g)}, max_norm)[0]["g"].numpy()
    np.testing.assert_allclose(got, want, rtol=2e-7, atol=0)
    stock = torch.from_numpy(g.copy()).requires_grad_()
    stock.grad = torch.from_numpy(g.copy())
    torch.nn.utils.clip_grad_norm_([stock], max_norm)
    assert float(np.abs(stock.grad.numpy() - want).max()) > 1e-7 * float(np.abs(want).max())


def test_ema_matches_the_references_update():
    rng = np.random.default_rng(2)
    e0 = {"w": rng.normal(size=(64,)).astype(np.float32)}
    ps = [{"w": rng.normal(size=(64,)).astype(np.float32)} for _ in range(3)]
    ema_fn = jax.jit(lambda e, p, d: jax.tree.map(lambda a, b: d * a + (1.0 - d) * b, e, p))
    je = {k: jnp.asarray(v) for k, v in e0.items()}
    pe = {k: torch.from_numpy(v.copy()) for k, v in e0.items()}
    for t, p in enumerate(ps):
        d = 0.9999 * (1.0 - np.exp(-(t + 1) / 2000.0))
        je = ema_fn(je, {k: jnp.asarray(v) for k, v in p.items()}, d)
        ema_update(pe, {k: torch.from_numpy(v) for k, v in p.items()}, ema_decay_at(0.9999, t))
    np.testing.assert_allclose(pe["w"].numpy(), np.asarray(je["w"]), rtol=0, atol=1e-7)


def test_from_scratch_init_has_flax_distributions():
    m = init_params(build_model("yolov8s", 8), torch.Generator().manual_seed(0))
    w = m.c2f3.m0.cv1.conv.weight.detach()
    fan_in = w[0].numel()
    std = 1.0 / np.sqrt(fan_in)
    assert abs(float(w.std()) / std - 1.0) < 0.02                 # variance 1 / fan_in
    assert float(w.abs().max()) <= 2.0 * std / 0.87962566103423978 + 1e-6  # truncated at 2 sigma
    assert float(m.head.cls0_2.bias.detach().abs().max()) == 0.0
    bn = m.c2f3.m0.cv1.bn
    assert torch.equal(bn.weight, torch.ones_like(bn.weight))
    assert torch.equal(bn.running_var, torch.ones_like(bn.running_var))
    again = init_params(build_model("yolov8s", 8), torch.Generator().manual_seed(0))
    assert torch.equal(again.c2f3.m0.cv1.conv.weight, w)
