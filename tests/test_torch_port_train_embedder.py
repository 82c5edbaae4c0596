"""``tools/train_embedder_torch.py`` against ``tools/train_embedder.py`` on the
CPU: the batch samplers draw the reference's identities and views, the
supervised NT-Xent loss and its gradient match the reference's formula, and
one training step of the appearance embedder (``adamw(cosine_decay(lr,
steps, 0.05), weight_decay=1e-4)``) from the same weights lands on the
reference's parameters; the weights it writes load through
``init_embedder`` and the reference's loader.

Bars (measured in brackets): samplers and patches equal; the loss and its
gradient within 1e-6; the step's loss within 1e-5 relative, the parameters
after it within a tenth of a step at each entry [1.4e-3 to 1.9e-2 of a step
at worst, one entry in a few 1e5, over runs] and 1e-3 of a step on average;
the written weights' embeddings within 1e-5 of the reference's.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import traverse_util

from rtmodt_tpu.models.embedder import AppearanceEmbedder as JaxEmbedder
from rtmodt_tpu.models.embedder import init_embedder as jax_init_embedder
from rtmodt_tpu_torch.models.embedder import AppearanceEmbedder, _seeded_init, init_embedder
from rtmodt_tpu_torch.models.weights import embedder_to_jax
from rtmodt_tpu_torch.training.train_step import AdamW, cosine_decay_schedule
from tests.test_torch_port_threads import torch_threads  # noqa: F401 (autouse)
from tools import train_embedder as ref_tool
from tools import train_embedder_torch as tool

HW, TEMP, LR, STEPS = (64, 32), 0.07, 1e-3, 100


def jax_ntxent(z, labels, temp=TEMP):
    """The reference tool's loss (a closure in its ``main``), verbatim."""
    sim = z @ z.T / temp
    b = z.shape[0]
    eye = jnp.eye(b, dtype=bool)
    pos = (labels[:, None] == labels[None, :]) & ~eye
    logits = jnp.where(eye, -1e9, sim)
    log_prob = logits - jax.nn.logsumexp(logits, axis=1, keepdims=True)
    return -jnp.sum(jnp.where(pos, log_prob, 0.0)) / jnp.maximum(jnp.sum(pos), 1)


def test_samplers_draw_the_references_batches():
    shapes, colors = tool.identity_attrs(256, 0)
    ref_shapes, ref_colors = ref_tool.identity_attrs(256, 0)
    np.testing.assert_array_equal(shapes, ref_shapes)
    np.testing.assert_array_equal(colors, ref_colors)
    a, b = np.random.default_rng(4), np.random.default_rng(4)
    for _ in range(3):
        np.testing.assert_array_equal(tool.hard_batch(a, shapes, colors, 16),
                                      ref_tool.hard_batch(b, shapes, colors, 16))
    ids, views = np.repeat(np.arange(4), 2), np.arange(8) * 7919
    np.testing.assert_array_equal(tool.batch_views(ids, views, HW, 0, degrade_p=0.5),
                                  ref_tool.batch_views(ids, views, HW, 0, degrade_p=0.5))


def test_ntxent_and_its_gradient():
    rng = np.random.default_rng(0)
    z = rng.normal(size=(16, 32)).astype(np.float32)
    z /= np.linalg.norm(z, axis=1, keepdims=True)
    labels = np.repeat(np.arange(4), 4)
    want, want_g = jax.value_and_grad(jax_ntxent)(jnp.asarray(z), jnp.asarray(labels))
    tz = torch.from_numpy(z).requires_grad_()
    got = tool.ntxent(tz, torch.from_numpy(labels), TEMP)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6)
    np.testing.assert_allclose(tz.grad.numpy(), np.asarray(want_g), rtol=0, atol=1e-6)


@pytest.fixture(scope="module")
def one_step():
    model = AppearanceEmbedder()
    _seeded_init(model, 3)
    flat = embedder_to_jax(model)
    params = traverse_util.unflatten_dict({tuple(k.split("/")): jnp.asarray(v)
                                           for k, v in flat.items()})
    shapes, colors = tool.identity_attrs(128, 0)
    ids = np.repeat(tool.hard_batch(np.random.default_rng(1), shapes, colors, 8), 2)
    patches = tool.batch_views(ids, np.arange(16) * 104729, HW, 0)
    jm = JaxEmbedder()
    tx = optax.adamw(optax.cosine_decay_schedule(LR, STEPS, 0.05), weight_decay=1e-4)

    def loss_fn(p):
        return jax_ntxent(jm.apply(p, jnp.asarray(patches)), jnp.asarray(ids))

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    upd, _ = tx.update(grads, tx.init(params), params)
    new = optax.apply_updates(params, upd)
    return model, patches, ids, float(loss), {k: np.asarray(v) for k, v in
                                              traverse_util.flatten_dict(new, sep="/").items()}


def test_one_training_step(one_step):
    model, patches, ids, want_loss, want = one_step
    ptx = AdamW(cosine_decay_schedule(LR, STEPS, 0.05), weight_decay=1e-4, clip_norm=None,
                b1=0.9, b2=0.999, mask=None)
    params = dict(model.named_parameters())
    state = ptx.init(params)
    loss = tool.ntxent(model(torch.from_numpy(patches)), torch.from_numpy(ids), TEMP)
    grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
    _, lr = ptx.update(grads, state, params)
    assert lr == pytest.approx(LR)
    np.testing.assert_allclose(float(loss.detach()), want_loss, rtol=1e-5)
    got = embedder_to_jax(model)
    assert sorted(got) == sorted(want)
    # Adam's first update is lr * g / (|g| + eps): an entry whose gradient is
    # near eps follows the gradient's last bits
    gaps = np.concatenate([np.abs(got[k] - v).ravel() for k, v in want.items()])
    assert gaps.max() <= 0.1 * LR and gaps.mean() <= 1e-3 * LR


def test_written_weights_load_in_both_packages(one_step, tmp_path):
    model = one_step[0]
    path = str(tmp_path / "emb.npz")
    np.savez(path, **embedder_to_jax(model))
    back = init_embedder(HW, weights_path=path)
    for k, v in model.state_dict().items():
        assert torch.equal(back.state_dict()[k], v)
    jm, jp = jax_init_embedder(HW, weights_path=path)
    x = one_step[1][:4]
    with torch.no_grad():
        mine = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(np.asarray(jm.apply(jp, jnp.asarray(x))), mine, rtol=0, atol=1e-5)
