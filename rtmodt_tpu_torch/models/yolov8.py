"""YOLOv8 detection model family (n/s/m/l/x) in PyTorch.

Port of ``rtmodt_tpu/models/yolov8.py``: CSP backbone with C2f blocks, SPPF,
PAN neck, decoupled anchor-free head with DFL box regression.  Module names
follow the reference's Flax names (``stem``, ``c2f1.m0.cv1``, ``head.box0_2``
...), so ``models.weights.params_from_jax`` is a mechanical key map.

Layout: the modules take NCHW tensors (run them channels_last on the card);
the head returns ``(box_dist (N, A, 4*REG_MAX), cls_logits (N, A, nc))`` with
anchors in the reference's NHWC row-major order (level, row, column).

Eval mode (``model.eval()``) is the inference forward: stock ``BatchNorm2d``
on the running statistics, in the module's dtype.  Train mode is the
reference's ``train=True`` forward, flax's ``BatchNorm`` written out rather
than torch's:

  * the input is cast to the model's ``dtype`` (the reference's compute
    dtype; parameters stay float32 and are cast per conv);
  * batch statistics in float32 with flax's fast variance
    ``max(E[x^2] - E[x]^2, 0)``, which is also the *biased* variance the
    running statistic takes (``BatchNorm2d`` would take the unbiased one);
  * running statistics ``ra = 0.97 * ra + 0.03 * batch``, eps 1e-3;
  * the BN output and the SiLU in float32, then cast to the compute dtype;
  * inside ``global_batch_stats(model, world)`` (a rank of a data-parallel
    step) the batch statistics are the global batch's, as XLA computes
    them under ``jit`` over the sharded batch: each rank's ``(mean, mean of
    squares)`` in one differentiable all-reduce per layer, over slices of
    equal size.

``init_params`` is the reference's from-scratch init with flax's
distributions (truncated-normal LeCun kernels, zero biases, identity BN);
the draws are torch's from an explicit generator, not flax's.
"""

from __future__ import annotations

import contextlib
import math
from typing import Iterator, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from rtmodt_tpu_torch.parallel.mesh import all_reduce_sum

# depth_multiple, width_multiple, ratio (last-stage channel ratio)
YOLOV8_VARIANTS: dict[str, tuple[float, float, float]] = {
    "yolov8n": (0.34, 0.25, 2.0),
    "yolov8s": (0.34, 0.50, 2.0),
    "yolov8m": (0.67, 0.75, 1.5),
    "yolov8l": (1.00, 1.00, 1.0),
    "yolov8x": (1.00, 1.25, 1.0),
}

REG_MAX = 16
STRIDES = (8, 16, 32)
BN_EPS = 1e-3
BN_MOMENTUM = 0.97


def _make_divisible(x: float, divisor: int = 8) -> int:
    return max(divisor, int(math.ceil(x / divisor) * divisor)) if x > 0 else 0


def _scale_channels(c: int, width: float) -> int:
    return _make_divisible(c * width, 8)


def _depth(n: int, depth: float) -> int:
    return max(1, round(n * depth))


class ConvBN(nn.Module):
    """Conv2d + BatchNorm (eps 1e-3) + SiLU; ``fused=True`` is the
    BN-folded form (conv bias, no BN)."""

    def __init__(self, c_in: int, c_out: int, kernel: int = 1, stride: int = 1,
                 fused: bool = False):
        super().__init__()
        self.conv = nn.Conv2d(c_in, c_out, kernel, stride, kernel // 2, bias=fused)
        self.bn = None if fused else nn.BatchNorm2d(c_out, eps=BN_EPS)
        self.sync_ranks = 0   # > 0: train-mode statistics over that many ranks' slices

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            return self._train_forward(x)
        x = self.conv(x)
        if self.bn is not None:
            x = self.bn(x)
        return F.silu(x)

    def _train_forward(self, x: torch.Tensor) -> torch.Tensor:
        """flax's ``ConvBN(train=True)``: the conv in ``x``'s dtype, then BN
        on the batch statistics and the SiLU in float32, cast back."""
        dt = x.dtype
        y = conv_cast(self.conv, x)
        if self.bn is None:
            return F.silu(y)
        bn = self.bn
        yf = y.float()
        # (mean, mean of squares) as one tensor: one all-reduce per layer
        stats = torch.stack([yf.mean(dim=(0, 2, 3)), (yf * yf).mean(dim=(0, 2, 3))])
        if self.sync_ranks:
            stats = all_reduce_sum(stats) / self.sync_ranks
        mean = stats[0]
        var = torch.clamp(stats[1] - mean * mean, min=0.0)
        with torch.no_grad():
            bn.running_mean.copy_(BN_MOMENTUM * bn.running_mean + (1.0 - BN_MOMENTUM) * mean)
            bn.running_var.copy_(BN_MOMENTUM * bn.running_var + (1.0 - BN_MOMENTUM) * var)
        mul = torch.rsqrt(var + BN_EPS) * bn.weight.float()
        out = (yf - mean[:, None, None]) * mul[:, None, None] + bn.bias.float()[:, None, None]
        return F.silu(out).to(dt)

    @torch.no_grad()
    def fuse_bn(self) -> None:
        """Fold BN into the conv, in float32 as the reference's
        ``models/weights.py::fuse_bn`` does: ``k' = k * scale / sqrt(var +
        eps)``, ``b' = bias - mean * scale / sqrt(var + eps)``.  The square
        root is taken in float64 and rounded once, which is the correctly
        rounded float32 root numpy computes; torch's vectorized float32 root
        on the CPU is off by an ulp on rare inputs."""
        if self.bn is None:
            return
        bn, conv = self.bn, self.conv
        root = torch.sqrt((bn.running_var.float() + BN_EPS).double()).float()
        factor = bn.weight.float() / root
        fused = nn.Conv2d(conv.in_channels, conv.out_channels, conv.kernel_size,
                          conv.stride, conv.padding, bias=True,
                          device=conv.weight.device, dtype=conv.weight.dtype)
        fused.weight.copy_(conv.weight.float() * factor[:, None, None, None])
        fused.bias.copy_(bn.bias.float() - bn.running_mean.float() * factor)
        self.conv, self.bn = fused, None


@contextlib.contextmanager
def global_batch_stats(model: nn.Module, world: int) -> Iterator[None]:
    """Train-mode BatchNorm over the global batch of ``world`` ranks (each
    holding an equal slice) while the block runs; ``world`` 0 leaves the
    model as it is.  Every rank must run the same forward and backward: each
    ConvBN makes one all-reduce on each."""
    convs = [m for m in model.modules() if isinstance(m, ConvBN)]
    for m in convs:
        m.sync_ranks = world
    try:
        yield
    finally:
        for m in convs:
            m.sync_ranks = 0


def conv_cast(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """``conv`` with its parameters cast to ``x``'s dtype (flax's ``Conv``
    with float32 params and a lower compute dtype)."""
    dt = x.dtype
    w = conv.weight if conv.weight.dtype == dt else conv.weight.to(dt)
    b = conv.bias
    if b is not None and b.dtype != dt:
        b = b.to(dt)
    return F.conv2d(x, w, b, conv.stride, conv.padding)


class Bottleneck(nn.Module):
    def __init__(self, c: int, shortcut: bool = True, fused: bool = False):
        super().__init__()
        self.cv1 = ConvBN(c, c, 3, fused=fused)
        self.cv2 = ConvBN(c, c, 3, fused=fused)
        self.shortcut = shortcut

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.cv2(self.cv1(x))
        return x + y if self.shortcut else y


class C2f(nn.Module):
    """Cross-stage-partial block with n bottlenecks and dense split concat."""

    def __init__(self, c_in: int, c_out: int, n: int = 1, shortcut: bool = False,
                 fused: bool = False):
        super().__init__()
        self.hidden = int(c_out * 0.5)
        self.cv1 = ConvBN(c_in, 2 * self.hidden, 1, fused=fused)
        self.n = n
        for i in range(n):
            setattr(self, f"m{i}", Bottleneck(self.hidden, shortcut, fused=fused))
        self.cv2 = ConvBN((2 + n) * self.hidden, c_out, 1, fused=fused)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        parts = list(self.cv1(x).split(self.hidden, dim=1))
        for i in range(self.n):
            parts.append(getattr(self, f"m{i}")(parts[-1]))
        return self.cv2(torch.cat(parts, dim=1))


class SPPF(nn.Module):
    """Spatial pyramid pooling (fast): 3 chained stride-1 max-pools, concat."""

    def __init__(self, c_in: int, c_out: int, pool: int = 5, fused: bool = False):
        super().__init__()
        hidden = c_out // 2
        self.cv1 = ConvBN(c_in, hidden, 1, fused=fused)
        self.cv2 = ConvBN(4 * hidden, c_out, 1, fused=fused)
        self.pool = pool

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.cv1(x)
        p = self.pool
        y1 = F.max_pool2d(x, p, 1, p // 2)
        y2 = F.max_pool2d(y1, p, 1, p // 2)
        y3 = F.max_pool2d(y2, p, 1, p // 2)
        return self.cv2(torch.cat([x, y1, y2, y3], dim=1))


class DetectHead(nn.Module):
    """Decoupled anchor-free head: per-level box (4*REG_MAX) and cls (nc)."""

    def __init__(self, num_classes: int, channels: Sequence[int], fused: bool = False):
        super().__init__()
        self.num_classes = num_classes
        c2 = max(16, channels[0] // 4, 4 * REG_MAX)
        c3 = max(channels[0], min(num_classes, 100))
        for i, c in enumerate(channels):
            setattr(self, f"box{i}_0", ConvBN(c, c2, 3, fused=fused))
            setattr(self, f"box{i}_1", ConvBN(c2, c2, 3, fused=fused))
            setattr(self, f"box{i}_2", nn.Conv2d(c2, 4 * REG_MAX, 1))
            setattr(self, f"cls{i}_0", ConvBN(c, c3, 3, fused=fused))
            setattr(self, f"cls{i}_1", ConvBN(c3, c3, 3, fused=fused))
            setattr(self, f"cls{i}_2", nn.Conv2d(c3, num_classes, 1))
        self.levels = len(channels)

    def forward(self, feats: Sequence[torch.Tensor]) -> tuple[torch.Tensor, torch.Tensor]:
        box_out, cls_out = [], []
        last = conv_cast if self.training else (lambda conv, x: conv(x))
        for i, f in enumerate(feats):
            b = last(getattr(self, f"box{i}_2"), getattr(self, f"box{i}_1")(
                getattr(self, f"box{i}_0")(f)))
            c = last(getattr(self, f"cls{i}_2"), getattr(self, f"cls{i}_1")(
                getattr(self, f"cls{i}_0")(f)))
            n = f.shape[0]
            # NCHW -> NHWC before the reshape: the reference's anchor order
            box_out.append(b.permute(0, 2, 3, 1).reshape(n, -1, 4 * REG_MAX))
            cls_out.append(c.permute(0, 2, 3, 1).reshape(n, -1, self.num_classes))
        return torch.cat(box_out, dim=1), torch.cat(cls_out, dim=1)


class YOLOv8(nn.Module):
    """Backbone -> PAN neck -> decoupled head; raw (box_dist, cls_logits)."""

    def __init__(self, num_classes: int = 80, depth: float = 0.34, width: float = 0.50,
                 ratio: float = 2.0, fused: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype     # the train-mode compute dtype
        ch = lambda c: _scale_channels(c, width)  # noqa: E731
        c5 = _make_divisible(512 * width * ratio, 8)
        d = lambda n: _depth(n, depth)  # noqa: E731
        self.num_classes = num_classes
        self.stem = ConvBN(3, ch(64), 3, 2, fused)
        self.down1 = ConvBN(ch(64), ch(128), 3, 2, fused)
        self.c2f1 = C2f(ch(128), ch(128), d(3), True, fused)
        self.down2 = ConvBN(ch(128), ch(256), 3, 2, fused)
        self.c2f2 = C2f(ch(256), ch(256), d(6), True, fused)
        self.down3 = ConvBN(ch(256), ch(512), 3, 2, fused)
        self.c2f3 = C2f(ch(512), ch(512), d(6), True, fused)
        self.down4 = ConvBN(ch(512), c5, 3, 2, fused)
        self.c2f4 = C2f(c5, c5, d(3), True, fused)
        self.sppf = SPPF(c5, c5, 5, fused)
        self.neck_td4 = C2f(c5 + ch(512), ch(512), d(3), False, fused)
        self.neck_td3 = C2f(ch(512) + ch(256), ch(256), d(3), False, fused)
        self.neck_dn3 = ConvBN(ch(256), ch(256), 3, 2, fused)
        self.neck_bu4 = C2f(ch(256) + ch(512), ch(512), d(3), False, fused)
        self.neck_dn4 = ConvBN(ch(512), ch(512), 3, 2, fused)
        self.neck_bu5 = C2f(ch(512) + c5, c5, d(3), False, fused)
        self.head = DetectHead(num_classes, (ch(256), ch(512), c5), fused)

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """``x`` (N, 3, S, S) RGB in [0, 1] -> (box_dist, cls_logits)."""
        if self.training:
            x = x.to(self.dtype)
        x = self.c2f1(self.down1(self.stem(x)))
        p3 = self.c2f2(self.down2(x))
        p4 = self.c2f3(self.down3(p3))
        p5 = self.sppf(self.c2f4(self.down4(p4)))
        up = lambda t: F.interpolate(t, scale_factor=2.0, mode="nearest")  # noqa: E731
        n4 = self.neck_td4(torch.cat([up(p5), p4], dim=1))
        n3 = self.neck_td3(torch.cat([up(n4), p3], dim=1))
        n4b = self.neck_bu4(torch.cat([self.neck_dn3(n3), n4], dim=1))
        n5 = self.neck_bu5(torch.cat([self.neck_dn4(n4b), p5], dim=1))
        return self.head([n3, n4b, n5])

    def fuse_bn(self) -> "YOLOv8":
        """Fold every BatchNorm into its conv (inference only); returns self."""
        for m in self.modules():
            if isinstance(m, ConvBN):
                m.fuse_bn()
        return self


def build_model(variant: str = "yolov8s", num_classes: int = 80,
                fused: bool = False, dtype: torch.dtype = torch.float32) -> YOLOv8:
    """``dtype`` is the train-mode compute dtype; parameters are float32."""
    if variant not in YOLOV8_VARIANTS:
        raise KeyError(f"unknown model '{variant}'; choose from {sorted(YOLOV8_VARIANTS)}")
    depth, width, ratio = YOLOV8_VARIANTS[variant]
    return YOLOv8(num_classes, depth, width, ratio, fused, dtype)


# flax's truncated_normal draws from [-2, 2] and rescales by this stddev of
# the unit normal truncated there, so the kernel's variance is 1 / fan_in
_TRUNC_STD = 0.87962566103423978


@torch.no_grad()
def init_params(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """flax's default init of the reference's model: conv kernels
    ``lecun_normal`` (a truncated normal of variance 1 / fan_in), biases 0,
    BN scale 1, bias 0, mean 0, variance 1.  The draws come from
    ``generator`` in module order; they are torch's, not flax's."""
    for m in model.modules():
        if isinstance(m, nn.Conv2d):
            std = 1.0 / math.sqrt(m.weight[0].numel()) / _TRUNC_STD
            w = torch.empty(m.weight.shape, dtype=torch.float32)
            nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)
            m.weight.copy_(w)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.BatchNorm2d):
            m.reset_parameters()
            m.reset_running_stats()
    return model


def make_anchors(input_size: int, strides: Sequence[int] = STRIDES,
                 offset: float = 0.5, device: str | torch.device = "cpu"
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Anchor centers (A, 2) in input pixels and per-anchor stride (A, 1)."""
    pts, strs = [], []
    for s in strides:
        n = input_size // s
        xs = torch.arange(n, dtype=torch.float32, device=device) + offset
        gy, gx = torch.meshgrid(xs, xs, indexing="ij")
        pts.append(torch.stack([gx.reshape(-1), gy.reshape(-1)], dim=-1) * s)
        strs.append(torch.full((n * n, 1), float(s), dtype=torch.float32, device=device))
    return torch.cat(pts, dim=0), torch.cat(strs, dim=0)


def decode_predictions(box_dist: torch.Tensor, cls_logits: torch.Tensor, input_size: int
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """The full-grid DFL decode: xyxy boxes (N, A, 4) in input pixels and
    sigmoid scores (N, A, nc), in float32.  Each of l/t/r/b is the
    expectation of a softmax over REG_MAX bins times the anchor's stride."""
    n, a, _ = box_dist.shape
    anchors, strides = make_anchors(input_size, device=box_dist.device)
    dist = box_dist.float().reshape(n, a, 4, REG_MAX)
    bins = torch.arange(REG_MAX, dtype=torch.float32, device=box_dist.device)
    ltrb = torch.sum(torch.softmax(dist, dim=-1) * bins, dim=-1) * strides[None]
    boxes = torch.cat([anchors[None] - ltrb[..., :2], anchors[None] + ltrb[..., 2:]], dim=-1)
    return boxes, torch.sigmoid(cls_logits.float())
