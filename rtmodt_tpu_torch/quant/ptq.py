"""Post-training int8 quantization of the detector.

The port's counterpart of ``rtmodt_tpu/quant/ptq.py``, in PyTorch's idiom: a
module swap instead of a Flax method interceptor.  Every *fused* ``ConvBN``
(conv + bias + SiLU, the whole YOLOv8 body) except the stem becomes a
``QuantizedConvBN`` that computes, in the reference's order:

    xq  = clip(round(x * (1 / a_scale)), -127, 127)     int8, x in the model dtype
    y   = conv(xq, w_q)                                 int8 x int8 -> int32
    out = silu(y * (w_scale * a_scale) + b)             in the model dtype

with per-output-channel int8 weights (``w_scale = max|w| / 127``) and one
activation scale per layer (``a_scale = amax / 127``, amax the largest |input|
seen in calibration, or a frozen scale from QAT).  The stem and the head's two
plain 1x1 projections stay floating point, as in the reference.  The int8
conv is ``ops/int8_conv.py`` (im2col + ``torch._int_mm``).

Layer paths are the reference's Flax paths (``c2f1/cv1``): the port's module
names with ``.`` as ``/``.
"""

from __future__ import annotations

import copy
from typing import Iterable, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from rtmodt_tpu_torch.models.yolov8 import ConvBN
from rtmodt_tpu_torch.ops.int8_conv import int8_conv2d
from rtmodt_tpu_torch.utils.logging import logger


class QuantConv(NamedTuple):
    qkernel: torch.Tensor   # (kh, kw, cin, cout) int8, the reference's HWIO layout
    wscale: torch.Tensor    # (cout,) f32 per-output-channel weight scale
    ascale: torch.Tensor    # () f32 activation (input) scale
    bias: torch.Tensor      # (cout,) f32


def _fused_convbns(model: nn.Module) -> list[tuple[str, ConvBN]]:
    """(reference path, module) of every fused ConvBN of ``model``."""
    return [(name.replace(".", "/"), m) for name, m in model.named_modules()
            if isinstance(m, ConvBN) and m.bn is None]


@torch.no_grad()
def collect_act_scales(model: nn.Module, batches: Iterable[torch.Tensor]) -> dict[str, float]:
    """Max-abs calibration: run ``model`` over ``batches`` (letterboxed,
    normalized NHWC inputs, as the reference takes them) and record, per
    fused ConvBN, the largest |input| seen (in float32).  Returns {path:
    amax}."""
    amax: dict[str, float] = {}
    hooks = []
    for path, m in _fused_convbns(model):
        def hook(_m, args, path=path):
            a = float(args[0].float().abs().max())
            amax[path] = max(amax.get(path, 0.0), a)
        hooks.append(m.register_forward_pre_hook(hook))
    try:
        for batch in batches:
            model(batch.permute(0, 3, 1, 2))
    finally:
        for h in hooks:
            h.remove()
    return amax


@torch.no_grad()
def quantize_convs(model: nn.Module, act_scales: dict[str, float],
                   skip: tuple[str, ...] = ("stem",)) -> dict[str, QuantConv]:
    """Per-output-channel int8 weights of every fused ConvBN of the float32
    ``model``, in the reference's numpy arithmetic.  Paths in ``skip`` or
    missing from ``act_scales`` stay floating point."""
    out: dict[str, QuantConv] = {}
    for path, m in _fused_convbns(model):
        if path in skip or path not in act_scales:
            continue
        k = m.conv.weight.detach().float().cpu().numpy().transpose(2, 3, 1, 0)  # HWIO
        b = m.conv.bias.detach().float().cpu().numpy()
        wmax = np.max(np.abs(k), axis=(0, 1, 2))
        wscale = np.maximum(wmax, 1e-8) / 127.0
        qk = np.clip(np.round(k / wscale), -127, 127).astype(np.int8)
        ascale = max(act_scales[path], 1e-8) / 127.0
        out[path] = QuantConv(torch.from_numpy(np.ascontiguousarray(qk)),
                              torch.from_numpy(wscale.astype(np.float32)),
                              torch.tensor(ascale, dtype=torch.float32),
                              torch.from_numpy(b.astype(np.float32)))
    return out


class QuantizedConvBN(nn.Module):
    """The int8 stand-in of a fused ``ConvBN``.  Its float buffers hold the
    reference's float32 quantities (``1 / a_scale``, ``w_scale * a_scale``,
    the bias) and follow the model's dtype, so a bf16 model casts them as
    the reference casts them to its compute dtype."""

    def __init__(self, q: QuantConv, kernel: int, stride: int):
        super().__init__()
        kh, kw, cin, cout = q.qkernel.shape
        self.kernel, self.stride = kernel, stride
        self.register_buffer("qweight", q.qkernel.reshape(kh * kw * cin, cout).contiguous())
        self.register_buffer("inv_a", 1.0 / q.ascale.float())
        self.register_buffer("out_scale", q.wscale.float() * q.ascale.float())
        self.register_buffer("bias", q.bias.float().clone())

    def quantize_input(self, x: torch.Tensor) -> torch.Tensor:
        """The layer's input in the model dtype -> int8."""
        return torch.clamp(torch.round(x * self.inv_a.to(x.dtype)), -127, 127).to(torch.int8)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = x.dtype
        y = int8_conv2d(self.quantize_input(x), self.qweight, self.kernel, self.stride)
        y = y.to(dt) * self.out_scale.to(dt)[:, None, None] + self.bias.to(dt)[:, None, None]
        return F.silu(y)


def apply_quant(model: nn.Module, qtree: dict[str, QuantConv]) -> nn.Module:
    """Swap every ConvBN named in ``qtree`` for its ``QuantizedConvBN`` in
    place (the int8 buffers on the ConvBN's device); returns ``model``."""
    for path, q in qtree.items():
        *parent, leaf = path.split("/")
        owner = model.get_submodule(".".join(parent)) if parent else model
        m = getattr(owner, leaf)
        dev = m.conv.weight.device
        setattr(owner, leaf, QuantizedConvBN(q, m.conv.kernel_size[0], m.conv.stride[0]).to(dev))
    return model


def quantize_model(model: nn.Module, calib_batches: Iterable[torch.Tensor],
                   skip: tuple[str, ...] = ("stem",),
                   dtype: torch.dtype = torch.float32) -> nn.Module:
    """Calibrate and quantize in one call.  ``model`` is the fused float32
    build and is left as it is; ``dtype`` is the deployed compute dtype (the
    reference's Flax ``dtype``): calibration runs in it, the weights quantize
    from the float32 ones, and the returned copy is cast to it."""
    calib = model if dtype == torch.float32 else copy.deepcopy(model).to(dtype)
    scales = collect_act_scales(calib, calib_batches)
    del calib
    qtree = quantize_convs(model, scales, skip=skip)
    n_w = sum(int(q.qkernel.numel()) for q in qtree.values())
    logger.info(f"int8 PTQ: quantized {len(qtree)} conv layers ({n_w / 1e6:.1f}M weights), "
                f"skipped {list(skip)}")
    return apply_quant(copy.deepcopy(model), qtree).to(dtype)


def load_act_scales(path: str) -> dict[str, float]:
    """Frozen activation scales of a ``qat_act_scales.npz`` (keys are layer
    paths with ``|`` for ``/``)."""
    with np.load(path) as z:
        return {k.replace("|", "/"): float(z[k]) for k in z.files}


def quantize_with_scales(model: nn.Module, scales: dict[str, float],
                         dtype: torch.dtype = torch.float32) -> nn.Module:
    """int8 with frozen (QAT) activation scales, no calibration pass: a
    quantized copy of the fused float32 ``model``, cast to ``dtype``."""
    qtree = quantize_convs(model, scales)
    logger.info(f"int8 with {len(qtree)} frozen QAT scales")
    return apply_quant(copy.deepcopy(model), qtree).to(dtype)
