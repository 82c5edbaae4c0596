"""Appearance embedder for DeepSORT and BoT-SORT (port of
``rtmodt_tpu/models/embedder.py``).

(D, h, w, 3) RGB patches in [0, 255] -> (D, embed_dim) unit vectors:
x / 255 - 0.5, three stages of (3x3 stride-2 conv, SiLU, 3x3 conv, SiLU) at
widths 32 / 64 / 128, global mean pool, a dense projection, L2 norm.

The convolutions pad as flax's ``"SAME"`` does: ``ceil(in / stride)``
outputs with the total padding split low-first, so a stride-2 conv on an
even side pads 0 before and 1 after (``padding=1`` would pad 1 on both sides
and shift every feature map by a pixel).

The forward runs in float32 with cuDNN's TF32 turned off for its duration,
as the reference computes in full float32.

Weights: the reference's flat flax ``.npz`` (``checkpoints/embedder.npz``,
14 arrays) through ``models/weights.py::embedder_params_from_jax``, or a
seeded init (``init_embedder(..., weights_path="")``), which is the port's
own and does not reproduce flax's random init.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F


def _same_pad(size: int, k: int, stride: int) -> tuple[int, int]:
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


class AppearanceEmbedder(nn.Module):
    """(D, h, w, 3) patches -> (D, embed_dim) L2-normalised embeddings."""

    def __init__(self, embed_dim: int = 128, width: int = 32):
        super().__init__()
        self.embed_dim, self.width = embed_dim, width
        cin = 3
        for mult in (1, 2, 4):
            c = width * mult
            setattr(self, f"down{mult}", nn.Conv2d(cin, c, 3, stride=2))
            setattr(self, f"mix{mult}", nn.Conv2d(c, c, 3))
            cin = c
        self.proj = nn.Linear(cin, embed_dim)

    @staticmethod
    def _conv(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
        s = conv.stride[0]
        ph = _same_pad(x.shape[-2], 3, s)
        pw = _same_pad(x.shape[-1], 3, s)
        return conv(F.pad(x, (pw[0], pw[1], ph[0], ph[1])))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cuda = x.is_cuda
        if cuda:
            prev = torch.backends.cudnn.allow_tf32
            torch.backends.cudnn.allow_tf32 = False
        try:
            x = x.float() / 255.0 - 0.5
            x = x.permute(0, 3, 1, 2)
            for mult in (1, 2, 4):
                x = F.silu(self._conv(getattr(self, f"down{mult}"), x))
                x = F.silu(self._conv(getattr(self, f"mix{mult}"), x))
            x = x.mean(dim=(2, 3))
            x = self.proj(x)
            return x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + 1e-8)
        finally:
            if cuda:
                torch.backends.cudnn.allow_tf32 = prev


def _seeded_init(model: AppearanceEmbedder, seed: int = 0) -> None:
    """Deterministic init (LeCun normal kernels, zero biases, as flax's
    default scheme; the draws are torch's, not flax's)."""
    gen = torch.Generator().manual_seed(seed)
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            fan_in = m.weight[0].numel()
            with torch.no_grad():
                m.weight.copy_(torch.randn(m.weight.shape, generator=gen) / math.sqrt(fan_in))
                m.bias.zero_()


def init_embedder(crop_hw: tuple[int, int], embed_dim: int = 128, weights_path: str = "",
                  width: int = 32, device: str | torch.device = "cpu") -> AppearanceEmbedder:
    """The embedder in eval mode on ``device``: ``weights_path`` loads a flat
    flax ``.npz`` (missing keys or shapes raise); empty means seeded init."""
    from rtmodt_tpu_torch.models.weights import embedder_params_from_jax

    del crop_hw   # the network is size-agnostic; kept for the reference's signature
    model = AppearanceEmbedder(embed_dim, width)
    if weights_path:
        with np.load(weights_path, allow_pickle=False) as z:
            flat = {k: z[k] for k in z.files}
        sd = embedder_params_from_jax(flat)
        own = model.state_dict()
        missing = sorted(set(own) - set(sd))
        if missing:
            raise ValueError(f"embedder weights {weights_path} missing keys: {missing}")
        bad = [k for k in own if tuple(sd[k].shape) != tuple(own[k].shape)]
        if bad:
            raise ValueError(f"embedder weights {weights_path} shape mismatch for {bad[:3]} "
                             "(checkpoint was trained with a different embed_dim/width)")
        model.load_state_dict({k: sd[k] for k in own})
    else:
        _seeded_init(model)
    return model.eval().to(device)
