"""The YOLOv8 training step on one card: AdamW + warmup/cosine schedule,
compute in the model's dtype, float32 parameters and moments (port of
``rtmodt_tpu/training/train_step.py``).

The optimizer is optax's ``chain(clip_by_global_norm(clip_norm),
adamw(schedule, b1=0.937, b2=0.999, weight_decay, mask=ndim > 1))`` written
out, because torch's own pieces differ from it:

  * the schedule is evaluated at the update count *before* it is
    incremented, so the linear warmup from 0 gives lr = 0 on the first
    update; the cosine part starts at the warmup boundary;
  * clipping scales by ``max_norm / norm`` only when the global norm is
    above the limit (``clip_grad_norm_`` adds 1e-6 and always scales);
  * Adam's eps is added outside the square root; weight decay is decoupled,
    ``lr * wd * p``, and applies only to tensors with ``ndim > 1`` (the conv
    kernels, the head's final 1x1 convs included);
  * no loss scaling under bf16, as in the reference.

Parameters live in the model (``TrainState.model``); the step updates them
in place.

``make_sharded_train_step`` is the data-parallel step over a mesh
(``parallel/mesh.py``; the reference's ``jit`` with the batch sharded on
``data`` and the state replicated), run in every rank of ``mesh.spawn``:
each rank takes its slice of the global batch, the BatchNorm statistics and
the loss's ``score_sum`` are the global batch's, and the gradients of the
rank parts of the loss are all-reduced with SUM (the global loss is the sum
of the parts; DDP's mean would be off by N) in one flat bucket that also
carries the metrics.  Clipping by the global norm and AdamW then run
identically on every rank, so the parameters stay bit-identical.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, NamedTuple

import numpy as np
import torch
from torch import nn

import torch.distributed as dist

from rtmodt_tpu_torch.models.yolov8 import global_batch_stats
from rtmodt_tpu_torch.parallel.mesh import Mesh, shard_batch
from rtmodt_tpu_torch.training.loss import yolo_loss

Schedule = Callable[[int], float]
_F32 = np.float32


class Batch(NamedTuple):
    images: torch.Tensor     # (B, S, S, 3) uint8 or float in [0, 1], RGB
    gt_boxes: torch.Tensor   # (B, M, 4) xyxy input pixels
    gt_labels: torch.Tensor  # (B, M) int32
    gt_mask: torch.Tensor    # (B, M) bool

    def to(self, device: torch.device | str) -> "Batch":
        return Batch(*(torch.as_tensor(x).to(device, non_blocking=True) for x in self))


# -- schedules: optax's, in its float32 arithmetic ------------------------------

def constant_schedule(value: float) -> Schedule:
    return lambda count: float(_F32(value))


def linear_schedule(init_value: float, end_value: float, transition_steps: int) -> Schedule:
    """optax ``linear_schedule``: ``(init - end) * (1 - c / T) + end``."""
    def schedule(count: int) -> float:
        c = min(max(int(count), 0), transition_steps)
        frac = _F32(1.0) - _F32(c) / _F32(transition_steps)
        return float((_F32(init_value) - _F32(end_value)) * frac + _F32(end_value))
    return schedule


def cosine_decay_schedule(init_value: float, decay_steps: int, alpha: float = 0.0) -> Schedule:
    """optax ``cosine_decay_schedule``: ``init * ((1 - alpha) * 0.5 * (1 +
    cos(pi * c / T)) + alpha)``, ``c`` capped at ``T``."""
    def schedule(count: int) -> float:
        c = _F32(min(int(count), decay_steps))
        cos = _F32(math.cos(float(_F32(_F32(math.pi) * c) / _F32(decay_steps))))
        decayed = _F32(1.0 - alpha) * (_F32(0.5) * (_F32(1.0) + cos)) + _F32(alpha)
        return float(_F32(init_value) * decayed)
    return schedule


def join_schedules(schedules: list[Schedule], boundaries: list[int]) -> Schedule:
    def schedule(count: int) -> float:
        out = schedules[0](count)
        for boundary, s in zip(boundaries, schedules[1:]):
            if count >= boundary:
                out = s(count - boundary)
        return out
    return schedule


def make_schedule(lr0: float, lrf: float, total_steps: int, warmup_steps: int) -> Schedule:
    """Linear warmup from 0 then cosine decay to lr0 * lrf (the reference's)."""
    warmup = linear_schedule(0.0, lr0, max(warmup_steps, 1))
    cosine = cosine_decay_schedule(lr0, max(total_steps - warmup_steps, 1), alpha=lrf)
    return join_schedules([warmup, cosine], [max(warmup_steps, 1)])


# -- the optimizer ---------------------------------------------------------------

@dataclass
class OptState:
    count: int
    mu: dict[str, torch.Tensor]
    nu: dict[str, torch.Tensor]


def decay_mask(p: torch.Tensor) -> bool:
    """The reference's mask: weight decay for tensors with ``ndim > 1``."""
    return p.ndim > 1


@dataclass
class AdamW:
    """optax ``chain(clip_by_global_norm(clip_norm), adamw(...))`` over a
    dict of named float32 tensors.  ``clip_norm=None`` leaves out the clip;
    ``mask=None`` decays every tensor (optax's default)."""

    schedule: Schedule
    weight_decay: float = 0.0005
    clip_norm: float | None = 10.0
    b1: float = 0.937
    b2: float = 0.999
    eps: float = 1e-8
    mask: Callable[[torch.Tensor], bool] | None = field(default=decay_mask)

    def init(self, params: dict[str, torch.Tensor]) -> OptState:
        return OptState(0, {k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()},
                        {k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()})

    @torch.no_grad()
    def update(self, grads: dict[str, torch.Tensor], state: OptState,
               params: dict[str, torch.Tensor]) -> tuple[torch.Tensor, float]:
        """Apply one update to ``params`` in place and advance ``state``.
        Returns (the global norm of ``grads`` before clipping, the lr used)."""
        if self.clip_norm is None:
            g_norm = global_norm(grads.values())
        else:
            grads, g_norm = clip_by_global_norm(grads, self.clip_norm)
        lr = self.schedule(state.count)
        count = state.count + 1
        c1 = float(_F32(1.0) - _f32_pow(self.b1, count))
        c2 = float(_F32(1.0) - _f32_pow(self.b2, count))
        for k, p in params.items():
            g = grads[k].float()
            mu = (1.0 - self.b1) * g + self.b1 * state.mu[k]
            nu = (1.0 - self.b2) * (g * g) + self.b2 * state.nu[k]
            state.mu[k], state.nu[k] = mu, nu
            u = (mu / c1) / (torch.sqrt(nu / c2) + self.eps)
            if self.weight_decay and (self.mask is None or self.mask(p)):
                u = u + self.weight_decay * p
            p.add_(-lr * u)
        state.count = count
        return g_norm, lr


def _f32_pow(base: float, n: int) -> np.float32:
    """``base ** n`` in float32 by repeated squaring.  optax takes Adam's
    bias correction ``1 - b ** count`` in float32, where ``1 - 0.999 **
    count`` cancels: an ulp of the power is ~3e-5 of the correction at
    small counts, so the power is rounded as float32 arithmetic rounds it
    (XLA's float32 power gives the same bits for b = 0.999 up to 3000)."""
    x, acc = _F32(base), _F32(1.0)
    while n:
        if n & 1:
            acc = _F32(acc * x)
        x = _F32(x * x)
        n >>= 1
    return acc


def global_norm(tensors) -> torch.Tensor:
    """optax ``global_norm``: sqrt of the sum of every tensor's sum of squares."""
    return torch.sqrt(torch.stack([torch.sum(t.float() * t.float()) for t in tensors]).sum())


def clip_by_global_norm(grads: dict[str, torch.Tensor], max_norm: float
                        ) -> tuple[dict[str, torch.Tensor], torch.Tensor]:
    """optax's rule: ``g / norm * max_norm`` where the global norm is at or
    above ``max_norm``, ``g`` as it is below.  Returns (grads, norm)."""
    g_norm = global_norm(grads.values())
    trigger = g_norm < max_norm
    return {k: torch.where(trigger, g, g / g_norm * max_norm) for k, g in grads.items()}, g_norm


def make_optimizer(schedule: Schedule, weight_decay: float = 0.0005,
                   clip_norm: float = 10.0) -> AdamW:
    return AdamW(schedule, weight_decay, clip_norm)


# -- the train state and step ------------------------------------------------------

@dataclass
class TrainState:
    """The model (parameters and BN running statistics), the optimizer's
    state and the step count."""

    model: nn.Module
    opt_state: OptState
    step: int = 0

    def params(self) -> dict[str, torch.Tensor]:
        return dict(self.model.named_parameters())


def create_train_state(model: nn.Module, tx: AdamW,
                       generator: torch.Generator | None = None,
                       init_variables: dict | None = None) -> TrainState:
    """``init_variables`` is a flat reference checkpoint (``params/...``,
    ``batch_stats/...``) carried across by ``params_from_jax``; without it
    the model gets the from-scratch init from ``generator`` (seed 0)."""
    from rtmodt_tpu_torch.models.weights import load_into
    from rtmodt_tpu_torch.models.yolov8 import init_params

    if init_variables is None:
        init_params(model, generator or torch.Generator().manual_seed(0))
    else:
        load_into(model, init_variables)
    return TrainState(model, tx.init(dict(model.named_parameters())), 0)


def to_model_input(images: torch.Tensor) -> torch.Tensor:
    """(B, S, S, 3) uint8 or float -> float (B, 3, S, S) in [0, 1], divided
    on the images' device as the reference's step does."""
    if images.dtype == torch.uint8:
        images = images.float() / 255.0
    return images.permute(0, 3, 1, 2)


def train_step(state: TrainState, batch: Batch, *, tx: AdamW, input_size: int,
               box_gain: float = 7.5, cls_gain: float = 0.5, dfl_gain: float = 1.5,
               mesh: Mesh | None = None) -> tuple[TrainState, dict[str, torch.Tensor]]:
    """One forward + loss + backward + update on the model's device.  The
    metrics stay on the device (read them when logging).  With a
    distributed ``mesh``, ``batch`` is this rank's slice of the global batch
    and the step is the data-parallel one (``make_sharded_train_step``); the
    metrics are then the global batch's."""
    sync = mesh is not None and mesh.distributed
    model = state.model
    model.train()
    params = state.params()
    with global_batch_stats(model, mesh.world if sync else 0):
        box_dist, cls_logits = model(to_model_input(batch.images))
        lb = yolo_loss(box_dist, cls_logits, batch.gt_boxes, batch.gt_labels, batch.gt_mask,
                       input_size, box_gain, cls_gain, dfl_gain, distributed=sync)
        grads = torch.autograd.grad(lb.total, list(params.values()))
    parts = (lb.total.detach(), lb.box.detach(), lb.cls.detach(), lb.dfl.detach(), lb.num_fg)
    if sync:
        grads, parts = _all_reduce_bucket(grads, parts)
    g_norm, lr = tx.update(dict(zip(params, grads)), state.opt_state, params)
    state.step += 1
    metrics = {"loss": parts[0], "box_loss": parts[1], "cls_loss": parts[2],
               "dfl_loss": parts[3], "num_fg": parts[4], "grad_norm": g_norm, "lr": lr}
    return state, metrics


_ALIGN = 128   # bucket offsets in elements: 512 bytes, as a fresh allocation is aligned


def _all_reduce_bucket(grads: tuple[torch.Tensor, ...], parts: tuple[torch.Tensor, ...]
                       ) -> tuple[list[torch.Tensor], tuple[torch.Tensor, ...]]:
    """SUM the gradients and the metric parts (loss, box, cls, dfl, num_fg)
    over the ranks in one flat float32 all-reduce; returns views of it.
    Each view has its gradient's strides (a channels_last conv kernel's
    gradient stays channels_last) and starts where a fresh tensor would be
    aligned: the global norm's sums follow the memory order and split their
    work by the address, so they round as on the plain step's gradients."""
    offsets, at = [], 0
    for g in grads:
        offsets.append(at)
        at += -(-g.numel() // _ALIGN) * _ALIGN
    flat = torch.zeros(at + len(parts), dtype=torch.float32, device=grads[0].device)
    out = []
    for g, o in zip(grads, offsets):
        dense = g.is_contiguous() or (g.dim() == 4 and g.is_contiguous(
            memory_format=torch.channels_last))
        v = (flat.as_strided(g.shape, g.stride(), o) if dense
             else flat[o:o + g.numel()].view(g.shape))
        v.copy_(g)
        out.append(v)
    flat[at:] = torch.stack([p.float() for p in parts])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM)
    red = flat[at:]
    return out, (red[0], red[1], red[2], red[3], red[4].to(parts[4].dtype))


def make_sharded_train_step(model: nn.Module, tx: AdamW, input_size: int, mesh: Mesh,
                            **gains) -> tuple[Callable, Callable]:
    """The data-parallel step over ``mesh`` (the reference's contract:
    ``(step_fn, put_batch)``).  ``put_batch(global_batch)`` is this rank's
    slice on its device (a batch the mesh does not divide raises);
    ``step_fn(state, slice) -> (state, metrics)``.  ``model`` is the one in
    the ``TrainState`` the step is given.  A mesh of several devices runs in
    the ranks of ``mesh.spawn``; a one-process mesh is the plain step."""
    if mesh.world > 1 and not mesh.distributed:
        raise RuntimeError(f"a mesh of {mesh.world} devices trains in {mesh.world} ranks: "
                           "build the step inside the target of parallel.mesh.spawn")
    del model   # the step's model is the state's, as the reference's is its params'

    def step_fn(state: TrainState, batch: Batch) -> tuple[TrainState, dict[str, torch.Tensor]]:
        return train_step(state, batch, tx=tx, input_size=input_size, mesh=mesh, **gains)

    def put_batch(batch: Batch) -> Batch:
        return shard_batch(Batch(*(torch.as_tensor(x) for x in batch)), mesh)

    return step_fn, put_batch
