"""Quantization-aware fine-tuning (QAT) for the int8 deployment path (port
of ``rtmodt_tpu/quant/qat.py``).

Flow (fold, then fine-tune):
  1. fold BatchNorm into the convs (``YOLOv8.fuse_bn``) so training sees the
     deployed graph;
  2. calibrate per-layer activation scales once (``ptq.collect_act_scales``)
     and freeze them;
  3. fine-tune with fake-quant convs: weights re-quantized per output channel
     from their live values at every step, activations on the frozen
     scales, both passing gradients straight through (``x + (q(x) -
     x).detach()``), in float32;
  4. deploy by feeding the same frozen scales to ``ptq.quantize_convs``
     (``detection.quant: int8`` with ``quant_scales``).

The reference rewrites each fused ``ConvBN`` with a Flax method
interceptor; here ``FakeQuantModel`` swaps them for ``FakeQuantConvBN``
modules that share the conv's parameters, so the optimizer sees the same
named tensors as the fused model.
"""

from __future__ import annotations

import copy
import itertools
from typing import Iterable

import torch
import torch.nn.functional as F
from torch import nn

from rtmodt_tpu_torch.models.yolov8 import ConvBN
from rtmodt_tpu_torch.utils.logging import logger


def fake_quant(x: torch.Tensor, scale: torch.Tensor | float) -> torch.Tensor:
    """Symmetric int8 fake-quant with straight-through gradients."""
    q = torch.clamp(torch.round(x / scale), -127, 127) * scale
    return x + (q - x).detach()


class FakeQuantConvBN(nn.Module):
    """A fused ``ConvBN`` with fake-quantized input and weights, float32."""

    def __init__(self, m: ConvBN, ascale: float):
        super().__init__()
        self.conv = m.conv          # shared: the parameters stay the fused model's
        self.ascale = ascale

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = x.dtype
        w = self.conv.weight.float()
        wmax = torch.amax(torch.abs(w), dim=(1, 2, 3))              # (cout,)
        wscale = torch.clamp(wmax, min=1e-8) / 127.0
        xq = fake_quant(x.float(), torch.tensor(self.ascale, dtype=torch.float32,
                                                device=x.device))
        wq = fake_quant(w, wscale[:, None, None, None])
        y = F.conv2d(xq, wq, None, self.conv.stride, self.conv.padding)
        return F.silu(y + self.conv.bias.float()[:, None, None]).to(dt)


class FakeQuantModel(nn.Module):
    """A copy of the fused float32 ``model`` whose fused ConvBNs named in
    ``act_scales`` (``{path: amax}`` of ``ptq.collect_act_scales``) run
    fake-quantized; paths in ``skip`` (the stem, as PTQ deploys it) or absent
    from ``act_scales`` stay floating point.  The copy trains in float32
    whatever ``model``'s train-mode compute dtype (a bf16 run's model)."""

    def __init__(self, model: nn.Module, act_scales: dict[str, float],
                 skip: tuple[str, ...] = ("stem",)):
        super().__init__()
        self.model = copy.deepcopy(model)
        self.model.dtype = torch.float32        # the train-mode compute dtype
        frozen = {p: max(a, 1e-8) / 127.0 for p, a in act_scales.items() if p not in skip}
        for name, m in list(self.model.named_modules()):
            path = name.replace(".", "/")
            if isinstance(m, ConvBN) and m.bn is None and path in frozen:
                *parent, leaf = name.split(".")
                owner = self.model.get_submodule(".".join(parent)) if parent else self.model
                setattr(owner, leaf, FakeQuantConvBN(m, frozen[path]))

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        return self.model(x)

    def fused_model(self, like: nn.Module) -> nn.Module:
        """A plain fused model of ``like``'s build holding these parameters."""
        out = copy.deepcopy(like)
        out.load_state_dict(self.model.state_dict())
        return out


def make_qat_step(fq_model: FakeQuantModel, tx, input_size: int, box_gain: float = 7.5,
                  cls_gain: float = 0.5, dfl_gain: float = 1.5):
    """(opt_state, batch) -> metrics: one fake-quant step on the fused graph
    (no BatchNorm state: it was folded before QAT); the parameters of
    ``fq_model`` update in place."""
    from rtmodt_tpu_torch.training.loss import yolo_loss
    from rtmodt_tpu_torch.training.train_step import to_model_input

    def step(opt_state, batch) -> dict[str, torch.Tensor]:
        fq_model.train()
        box_dist, cls_logits = fq_model(to_model_input(batch.images))
        lb = yolo_loss(box_dist, cls_logits, batch.gt_boxes, batch.gt_labels, batch.gt_mask,
                       input_size, box_gain, cls_gain, dfl_gain)
        params = dict(fq_model.model.named_parameters())
        grads = dict(zip(params, torch.autograd.grad(lb.total, list(params.values()))))
        g_norm, _ = tx.update(grads, opt_state, params)
        return {"loss": lb.total.detach(), "box_loss": lb.box.detach(),
                "cls_loss": lb.cls.detach(), "dfl_loss": lb.dfl.detach(), "grad_norm": g_norm}

    return step


def qat_finetune(model_fused: nn.Module, batches: Iterable, input_size: int,
                 steps: int | None = None, lr: float = 1e-5, calib_batches: int = 2,
                 skip: tuple[str, ...] = ("stem",), log_every: int = 20
                 ) -> tuple[nn.Module, dict[str, float]]:
    """Calibrate -> fake-quant fine-tune -> (the fine-tuned fused model, the
    frozen activation scales), ready for ``ptq.quantize_with_scales``.

    ``model_fused`` is the BN-folded float32 model on its device and is left
    as it is; ``batches`` yields ``train_step.Batch`` on that device, and its
    first ``calib_batches`` also serve as calibration data."""
    from rtmodt_tpu_torch.quant.ptq import collect_act_scales
    from rtmodt_tpu_torch.training.train_step import (constant_schedule, make_optimizer,
                                                      to_model_input)

    batches = iter(batches)
    cached = [next(batches) for _ in range(calib_batches)]
    model_fused.eval()
    scales = collect_act_scales(model_fused, [to_model_input(b.images).permute(0, 2, 3, 1)
                                              for b in cached])
    fq = FakeQuantModel(model_fused, scales, skip=skip)
    # the reference's masked decay: plain adamw would decay the folded
    # biases and drift the operating point the frozen scales assume
    tx = make_optimizer(constant_schedule(lr))
    opt_state = tx.init(dict(fq.model.named_parameters()))
    step_fn = make_qat_step(fq, tx, input_size)
    n = 0
    for batch in itertools.chain(cached, batches):
        if steps is not None and n >= steps:
            break
        metrics = step_fn(opt_state, batch)
        if log_every and n % log_every == 0:
            logger.info(f"qat step {n}: loss={float(metrics['loss']):.4f}")
        n += 1
    n_q = len([p for p in scales if p not in skip])
    logger.info(f"QAT fine-tune done: {n} steps, {n_q} quantized layers (skip={list(skip)})")
    return fq.fused_model(model_fused), scales
