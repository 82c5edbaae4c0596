"""RT-DETR-L in PyTorch: HGNetv2, AIFI, a CCFM neck and a deformable decoder.

Zhao et al., "DETRs Beat YOLOs on Real-time Object Detection" (arXiv:2304.08069),
as Ultralytics publishes it: ``cfg/models/rt-detr/rtdetr-l.yaml`` with the
modules of ``nn/modules/block.py`` (HGStem, HGBlock, LightConv, RepC3,
RepConv), ``conv.py`` (Conv, DWConv), ``transformer.py`` (AIFI,
MSDeformAttn, the deformable decoder) and ``head.py`` (RTDETRDecoder).  The
29 layers of the yaml are ``self.model[0..28]`` and every parameter keeps
Ultralytics' state-dict name (``model.28.decoder.layers.0.cross_attn.
value_proj.weight`` ...), so an Ultralytics checkpoint loads as it is
(``load_state``).  BN eps is 1e-3 (Ultralytics' ``initialize_weights``).

The forward (eval mode only: the denoising queries are training-only; their
class embedding is kept so the state dict matches):

  * backbone: HGStem at stride 4, four HGNetv2 stages with depthwise
    stride-2 convs between them (P3 512, P4 1024, P5 2048 channels);
  * encoder: ``input_proj`` 1x1 convs to the neck width, AIFI (one post-norm
    transformer layer over P5's tokens, 2-D sin-cos positions added to q and
    k), the CCFM top-down and bottom-up paths of RepC3 blocks; then the
    decoder's per-level 1x1 conv + BN, flattened to one token sequence, the
    anchors in logit space (outside (0.01, 0.99) masked: features zeroed,
    anchor +inf; also, given the letterbox's content box, anchors whose
    centre lies outside (0.01, 0.99) of the content), ``enc_output``, the
    class scores and the top
    ``num_queries`` anchors by their best class logit, whose ``enc_bbox_head``
    plus anchor, through a sigmoid, are the reference boxes;
  * decoder: per layer, self-attention with ``q = k = x + query_pos_head(ref)``,
    norm, multi-scale deformable cross-attention (``ops/msdeform.py``), norm,
    FFN, norm, then ``ref = sigmoid(bbox_head_i(x) + logit(ref))``; the last
    layer's ``score_head`` gives the logits.

``forward`` returns ``(boxes (B, Q, 4) cxcywh in [0, 1], logits (B, Q, nc))``,
both float32; ``detections`` is the output step that replaces NMS for this
model (Ultralytics' ``RTDETRPredictor`` rule cut to fixed shapes).

Precision: the modules run in their parameters' dtype (bf16 under
``detection.half``); reference boxes, anchors, sampling locations, the
attention weights' softmax and the encoder's class scores (whose top-k picks
the queries) are float32, since a bf16 location would be off by up to 1/256
of the image and bf16 scores tie.

Host spans (``profiling/spans.py``): ``backbone``, ``encoder`` (AIFI, CCFM,
query selection) and ``decoder`` (the layers; ``Detector.postprocess``
opens a second one around the output step).  Nothing here reads the card.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from rtmodt_tpu_torch.ops.msdeform import msdeform_attn
from rtmodt_tpu_torch.ops.nms import NMSResult
from rtmodt_tpu_torch.profiling.spans import span

BN_EPS = 1e-3
LN_EPS = 1e-5
NUM_LAYERS = 29          # rtdetr-l.yaml: backbone 0-9, head 10-28


@dataclass(frozen=True)
class RTDETRSpec:
    """The widths and depths of ``rtdetr-l.yaml`` and ``RTDETRDecoder``; the
    layer list is fixed, so another spec narrows it without changing its
    shape (the tests' small build)."""

    stem: tuple[int, int] = (32, 48)                  # HGStem cm, c2
    # HGBlock (cm, c2, k, lightconv, shortcut) of layers 1, 3, 5, 6, 7, 9
    blocks: tuple[tuple[int, int, int, bool, bool], ...] = (
        (48, 128, 3, False, False), (96, 512, 3, False, False),
        (192, 1024, 5, True, False), (192, 1024, 5, True, True),
        (192, 1024, 5, True, True), (384, 2048, 5, True, False))
    block_convs: int = 6            # the yaml's repeats: convs of an HGBlock
    neck: int = 256                 # input_proj, AIFI, CCFM width
    aifi_ffn: int = 1024
    aifi_heads: int = 8
    repc3: int = 3                  # RepConvs of a RepC3
    hidden_dim: int = 256
    num_queries: int = 300
    num_heads: int = 8
    num_points: int = 4
    num_decoder_layers: int = 6
    dim_feedforward: int = 1024


RTDETR_VARIANTS: dict[str, RTDETRSpec] = {"rtdetr-l": RTDETRSpec()}


# -- convolutions -------------------------------------------------------------

def _act(name: str | None, x: torch.Tensor) -> torch.Tensor:
    if name == "relu":
        return F.relu(x)
    if name == "silu":
        return F.silu(x)
    return x


class Conv(nn.Module):
    """Ultralytics' ``Conv``: conv (no bias) -> BatchNorm -> activation
    (``"silu"``, ``"relu"`` or None); after ``fuse_bn`` a conv with a bias."""

    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1, p: int | None = None,
                 g: int = 1, act: str | None = "silu"):
        super().__init__()
        self.conv = nn.Conv2d(c1, c2, k, s, k // 2 if p is None else p, groups=g, bias=False)
        self.bn = nn.BatchNorm2d(c2, eps=BN_EPS)
        self.act = act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(x)
        if self.bn is not None:
            x = self.bn(x)
        return _act(self.act, x)

    @torch.no_grad()
    def fuse_bn(self) -> None:
        if self.bn is not None:
            self.conv = fold_bn(self.conv, self.bn)
            self.bn = None


@torch.no_grad()
def fold_bn(conv: nn.Conv2d, bn: nn.BatchNorm2d) -> nn.Conv2d:
    """``conv`` followed by ``bn`` (running statistics) as one conv with a
    bias: ``k' = k * g / sqrt(var + eps)``, ``b' = beta - mean * g / sqrt(var
    + eps)``, the root taken in float64 and rounded once."""
    root = torch.sqrt((bn.running_var.double() + bn.eps)).float()
    factor = bn.weight.float() / root
    fused = nn.Conv2d(conv.in_channels, conv.out_channels, conv.kernel_size, conv.stride,
                      conv.padding, groups=conv.groups, bias=True,
                      device=conv.weight.device, dtype=conv.weight.dtype)
    fused.weight.copy_(conv.weight.float() * factor[:, None, None, None])
    fused.bias.copy_(bn.bias.float() - bn.running_mean.float() * factor)
    return fused


def DWConv(c1: int, c2: int, k: int = 1, s: int = 1, act: str | None = "silu") -> Conv:
    """Ultralytics' ``DWConv``: a ``Conv`` grouped by gcd(c1, c2)."""
    return Conv(c1, c2, k, s, g=math.gcd(c1, c2), act=act)


class HGStem(nn.Module):
    """HGNetv2's stem (stride 4): a 3x3 stride-2 conv, then a 2x2 conv pair
    (each after a right/bottom zero pad) beside a 2x2 stride-1 max-pool,
    concatenated, a 3x3 stride-2 conv and a 1x1; ReLU throughout."""

    def __init__(self, c1: int, cm: int, c2: int):
        super().__init__()
        self.stem1 = Conv(c1, cm, 3, 2, act="relu")
        self.stem2a = Conv(cm, cm // 2, 2, 1, 0, act="relu")
        self.stem2b = Conv(cm // 2, cm, 2, 1, 0, act="relu")
        self.stem3 = Conv(cm * 2, cm, 3, 2, act="relu")
        self.stem4 = Conv(cm, c2, 1, 1, act="relu")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.pad(self.stem1(x), [0, 1, 0, 1])
        x2 = self.stem2b(F.pad(self.stem2a(x), [0, 1, 0, 1]))
        x1 = F.max_pool2d(x, 2, 1, 0, ceil_mode=True)
        return self.stem4(self.stem3(torch.cat([x1, x2], dim=1)))


class LightConv(nn.Module):
    """A 1x1 conv without activation, then a depthwise kxk with ReLU."""

    def __init__(self, c1: int, c2: int, k: int):
        super().__init__()
        self.conv1 = Conv(c1, c2, 1, act=None)
        self.conv2 = DWConv(c2, c2, k, act="relu")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv2(self.conv1(x))


class HGBlock(nn.Module):
    """n convs (or LightConvs) in a chain; the input and every output
    concatenated, a 1x1 squeeze to c2/2 and a 1x1 excite to c2 (ReLU); the
    input added back when ``shortcut`` and c1 == c2."""

    def __init__(self, c1: int, cm: int, c2: int, k: int, n: int, light: bool,
                 shortcut: bool):
        super().__init__()
        self.m = nn.ModuleList(LightConv(c1 if i == 0 else cm, cm, k) if light
                               else Conv(c1 if i == 0 else cm, cm, k, act="relu")
                               for i in range(n))
        self.sc = Conv(c1 + n * cm, c2 // 2, 1, 1, act="relu")
        self.ec = Conv(c2 // 2, c2, 1, 1, act="relu")
        self.add = shortcut and c1 == c2

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = [x]
        for m in self.m:
            y.append(m(y[-1]))
        y = self.ec(self.sc(torch.cat(y, dim=1)))
        return y + x if self.add else y


class RepConv(nn.Module):
    """SiLU(3x3 conv + BN  +  1x1 conv + BN), no identity branch."""

    def __init__(self, c1: int, c2: int):
        super().__init__()
        self.conv1 = Conv(c1, c2, 3, 1, 1, act=None)
        self.conv2 = Conv(c1, c2, 1, 1, 0, act=None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.silu(self.conv1(x) + self.conv2(x))


class RepC3(nn.Module):
    """cv1 -> n RepConvs, plus cv2; hidden width c2 (e = 1, so no cv3)."""

    def __init__(self, c1: int, c2: int, n: int):
        super().__init__()
        self.cv1 = Conv(c1, c2, 1, 1)
        self.cv2 = Conv(c1, c2, 1, 1)
        self.m = nn.Sequential(*(RepConv(c2, c2) for _ in range(n)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.m(self.cv1(x)) + self.cv2(x)


# -- attention ------------------------------------------------------------------

class Attention(nn.Module):
    """Multi-head attention with ``nn.MultiheadAttention``'s parameter names
    (``in_proj_weight``, ``in_proj_bias``, ``out_proj``), batch first, written
    out: the logits in the module's dtype, their softmax in float32."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * dim, dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * dim))
        self.out_proj = nn.Linear(dim, dim)

    def forward(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        b, n, d = q.shape
        h = self.heads
        wq, wk, wv = self.in_proj_weight.chunk(3)
        bq, bk, bv = self.in_proj_bias.chunk(3)

        def heads(x, w, bias):
            return F.linear(x, w, bias).view(b, -1, h, d // h).transpose(1, 2)

        qh, kh, vh = heads(q, wq, bq), heads(k, wk, bk), heads(v, wv, bv)
        logits = (qh * (d // h) ** -0.5) @ kh.transpose(-1, -2)
        attn = torch.softmax(logits, dim=-1, dtype=torch.float32).to(vh.dtype)
        return self.out_proj((attn @ vh).transpose(1, 2).reshape(b, n, d))


@functools.lru_cache(maxsize=8)
def sincos_2d(w: int, h: int, dim: int, device: torch.device,
              temperature: float = 10000.0) -> torch.Tensor:
    """AIFI's positions (1, w*h, dim) float32, as Ultralytics builds them
    (its meshgrid is indexed (w, h), so a token's first half takes its
    row's index on a square map)."""
    gw, gh = torch.meshgrid(torch.arange(w, dtype=torch.float32),
                            torch.arange(h, dtype=torch.float32), indexing="ij")
    pos_dim = dim // 4
    omega = 1.0 / temperature ** (torch.arange(pos_dim, dtype=torch.float32) / pos_dim)
    out_w = gw.flatten()[:, None] @ omega[None]
    out_h = gh.flatten()[:, None] @ omega[None]
    return torch.cat([out_w.sin(), out_w.cos(), out_h.sin(), out_h.cos()], 1)[None].to(device)


class AIFI(nn.Module):
    """One post-norm transformer encoder layer over a map's tokens (GELU
    FFN), positions added to q and k (in float32, then rounded to the
    module's dtype)."""

    def __init__(self, c1: int, cm: int, heads: int):
        super().__init__()
        self.ma = Attention(c1, heads)
        self.fc1 = nn.Linear(c1, cm)
        self.fc2 = nn.Linear(cm, c1)
        self.norm1 = nn.LayerNorm(c1, eps=LN_EPS)
        self.norm2 = nn.LayerNorm(c1, eps=LN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        src = x.flatten(2).transpose(1, 2)
        qk = (src.float() + sincos_2d(w, h, c, x.device)).to(src.dtype)
        src = self.norm1(src + self.ma(qk, qk, src))
        src = self.norm2(src + self.fc2(F.gelu(self.fc1(src))))
        return src.transpose(1, 2).reshape(b, c, h, w)


class MLP(nn.Module):
    """Linear layers with ReLU between them (Ultralytics' ``MLP``)."""

    def __init__(self, c_in: int, hidden: int, c_out: int, n: int):
        super().__init__()
        dims = [c_in] + [hidden] * (n - 1) + [c_out]
        self.layers = nn.ModuleList(nn.Linear(a, b) for a, b in zip(dims[:-1], dims[1:]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = F.relu(x)
        return x


class MSDeformAttn(nn.Module):
    """Multi-scale deformable attention: each query samples ``points`` points
    per head and level around its reference box (``ref.xy + offset / points
    * ref.wh * 0.5``) from the value maps, weighted by a softmax over levels
    x points per head."""

    def __init__(self, dim: int, levels: int, heads: int, points: int):
        super().__init__()
        self.levels, self.heads, self.points = levels, heads, points
        self.sampling_offsets = nn.Linear(dim, heads * levels * points * 2)
        self.attention_weights = nn.Linear(dim, heads * levels * points)
        self.value_proj = nn.Linear(dim, dim)
        self.output_proj = nn.Linear(dim, dim)

    def forward(self, query: torch.Tensor, ref: torch.Tensor, value: torch.Tensor,
                shapes: tuple[tuple[int, int], ...]) -> torch.Tensor:
        """``query`` (B, Q, D), ``ref`` (B, Q, 4) float32 cxcywh, ``value``
        (B, V, D) the flattened maps of ``shapes`` -> (B, Q, D)."""
        b, q, d = query.shape
        h, nl, p = self.heads, self.levels, self.points
        v = self.value_proj(value).view(b, value.shape[1], h, d // h)
        off = self.sampling_offsets(query).float().view(b, q, h, nl, p, 2)
        w = self.attention_weights(query).float().view(b, q, h, nl * p)
        w = torch.softmax(w, dim=-1).view(b, q, h, nl, p)
        r = ref[:, :, None, None, None]
        loc = r[..., :2] + off / p * r[..., 2:] * 0.5
        return self.output_proj(msdeform_attn(v, shapes, loc, w))


class DecoderLayer(nn.Module):
    """Ultralytics' ``DeformableTransformerDecoderLayer`` (post-norm, ReLU FFN)."""

    def __init__(self, dim: int, heads: int, ffn: int, levels: int, points: int):
        super().__init__()
        self.self_attn = Attention(dim, heads)
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.cross_attn = MSDeformAttn(dim, levels, heads, points)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.linear1 = nn.Linear(dim, ffn)
        self.linear2 = nn.Linear(ffn, dim)
        self.norm3 = nn.LayerNorm(dim, eps=LN_EPS)

    def forward(self, x: torch.Tensor, ref: torch.Tensor, value: torch.Tensor,
                shapes: tuple[tuple[int, int], ...], pos: torch.Tensor) -> torch.Tensor:
        qk = x + pos
        x = self.norm1(x + self.self_attn(qk, qk, x))
        x = self.norm2(x + self.cross_attn(x + pos, ref, value, shapes))
        return self.norm3(x + self.linear2(F.relu(self.linear1(x))))


def inverse_sigmoid(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    x = x.clamp(0.0, 1.0)
    return torch.log(x.clamp(min=eps) / (1.0 - x).clamp(min=eps))


@functools.lru_cache(maxsize=8)
def anchors_logit(shapes: tuple[tuple[int, int], ...], device: torch.device,
                  content: tuple[float, float, float, float] = (0.0, 0.0, 1.0, 1.0),
                  grid_size: float = 0.05, eps: float = 1e-2
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """(anchors (V, 4) in logit space, +inf where not valid; valid (V, 1)
    float32 0/1): ``((grid + 0.5) / wh, grid_size * 2^level)`` per level,
    valid inside (eps, 1 - eps) and with its centre inside (eps, 1 - eps) of
    the ``content`` box (x0, y0, x1, y1) of the input.  Ultralytics' rule is
    the first (its input is all content, stretched); a letterboxed input's
    padding holds no image, so its anchors are masked as the image's border
    ones are."""
    out = []
    for i, (h, w) in enumerate(shapes):
        gy, gx = torch.meshgrid(torch.arange(h, dtype=torch.float32),
                                torch.arange(w, dtype=torch.float32), indexing="ij")
        xy = (torch.stack([gx, gy], -1) + 0.5) / torch.tensor([w, h], dtype=torch.float32)
        wh = torch.full_like(xy, grid_size * 2.0 ** i)
        out.append(torch.cat([xy, wh], -1).view(h * w, 4))
    a = torch.cat(out)
    x0, y0, x1, y1 = content
    rel = (a[:, :2] - torch.tensor([x0, y0])) / torch.tensor([x1 - x0, y1 - y0])
    valid = (((a > eps) & (a < 1 - eps)).all(-1, keepdim=True)
             & ((rel > eps) & (rel < 1 - eps)).all(-1, keepdim=True))
    a = torch.log(a / (1 - a)).masked_fill(~valid, float("inf"))
    return a.to(device), valid.float().to(device)


class RTDETRDecoder(nn.Module):
    """Ultralytics' ``RTDETRDecoder`` at inference: input projection, query
    selection (``select``), the deformable decoder (``decode``)."""

    def __init__(self, nc: int, ch: tuple[int, ...], s: RTDETRSpec):
        super().__init__()
        hd = s.hidden_dim
        self.num_queries = s.num_queries
        self.input_proj = nn.ModuleList(
            nn.Sequential(nn.Conv2d(c, hd, 1, bias=False), nn.BatchNorm2d(hd, eps=BN_EPS))
            for c in ch)
        self.decoder = nn.Module()       # Ultralytics' name: decoder.layers
        self.decoder.layers = nn.ModuleList(
            DecoderLayer(hd, s.num_heads, s.dim_feedforward, len(ch), s.num_points)
            for _ in range(s.num_decoder_layers))
        self.denoising_class_embed = nn.Embedding(nc, hd)     # training only
        self.query_pos_head = MLP(4, 2 * hd, hd, 2)
        self.enc_output = nn.Sequential(nn.Linear(hd, hd), nn.LayerNorm(hd, eps=LN_EPS))
        self.enc_score_head = nn.Linear(hd, nc)
        self.enc_bbox_head = MLP(hd, hd, 4, 3)
        self.dec_score_head = nn.ModuleList(nn.Linear(hd, nc)
                                            for _ in range(s.num_decoder_layers))
        self.dec_bbox_head = nn.ModuleList(MLP(hd, hd, 4, 3)
                                           for _ in range(s.num_decoder_layers))

    @torch.no_grad()
    def fuse_bn(self) -> None:
        for seq in self.input_proj:
            if isinstance(seq[1], nn.BatchNorm2d):
                seq[0], seq[1] = fold_bn(seq[0], seq[1]), nn.Identity()

    def select(self, feats: list[torch.Tensor], content: tuple[float, ...],
               keep: dict | None = None):
        """The projected levels -> (value (B, V, D), shapes, queries (B, Q, D),
        reference boxes (B, Q, 4) float32 in [0, 1])."""
        maps = [p(f) for p, f in zip(self.input_proj, feats)]
        shapes = tuple((int(m.shape[2]), int(m.shape[3])) for m in maps)
        value = torch.cat([m.flatten(2).transpose(1, 2) for m in maps], dim=1)
        anchors, valid = anchors_logit(shapes, value.device, content)
        features = self.enc_output(value * valid.to(value.dtype))
        w = self.enc_score_head
        scores = F.linear(features.float(), w.weight.float(), w.bias.float())
        idx = torch.topk(scores.max(-1).values, self.num_queries, dim=1).indices
        top = torch.gather(features, 1, idx[..., None].expand(-1, -1, features.shape[-1]))
        ref = (self.enc_bbox_head(top).float() + anchors[idx]).sigmoid()
        if keep is not None:
            keep.update(enc_scores=scores, topk=idx)
        return value, shapes, top, ref

    def decode(self, x: torch.Tensor, ref: torch.Tensor, value: torch.Tensor,
               shapes: tuple[tuple[int, int], ...], keep: dict | None = None
               ) -> tuple[torch.Tensor, torch.Tensor]:
        """The decoder layers -> (boxes (B, Q, 4) float32 cxcywh in [0, 1],
        logits (B, Q, nc) float32) of the last layer."""
        layers = self.decoder.layers
        for i, layer in enumerate(layers):
            x = layer(x, ref, value, shapes, self.query_pos_head(ref.to(x.dtype)))
            ref = torch.sigmoid(self.dec_bbox_head[i](x).float() + inverse_sigmoid(ref))
            if keep is not None:
                keep.setdefault("layers", []).append(
                    (ref, self.dec_score_head[i](x).float()))
        return ref, self.dec_score_head[len(layers) - 1](x).float()


class RTDETR(nn.Module):
    """The 29 layers of ``rtdetr-l.yaml`` as ``self.model``."""

    def __init__(self, num_classes: int = 80, spec: RTDETRSpec = RTDETRSpec()):
        super().__init__()
        s = spec
        self.spec, self.num_classes = s, num_classes
        n, w = s.block_convs, s.neck
        b = s.blocks
        layers: list[nn.Module] = [HGStem(3, *s.stem)]
        c = s.stem[1]
        for i, (cm, c2, k, light, shortcut) in enumerate(b):
            if i in (1, 2, 5):           # layers 2, 4, 8: the stride-2 depthwise convs
                layers.append(DWConv(c, c, 3, 2, act=None))
            layers.append(HGBlock(c, cm, c2, k, n, light, shortcut))
            c = c2
        p3, p4, p5 = b[1][1], b[4][1], b[5][1]
        layers += [Conv(p5, w, 1, 1, act=None),                     # 10 input_proj.2
                   AIFI(w, s.aifi_ffn, s.aifi_heads),               # 11
                   Conv(w, w, 1, 1),                                # 12 Y5
                   nn.Identity(),                                   # 13 upsample
                   Conv(p4, w, 1, 1, act=None),                     # 14 input_proj.1
                   nn.Identity(),                                   # 15 concat
                   RepC3(2 * w, w, s.repc3),                        # 16
                   Conv(w, w, 1, 1),                                # 17 Y4
                   nn.Identity(),                                   # 18 upsample
                   Conv(p3, w, 1, 1, act=None),                     # 19 input_proj.0
                   nn.Identity(),                                   # 20 concat
                   RepC3(2 * w, w, s.repc3),                        # 21 X3
                   Conv(w, w, 3, 2),                                # 22
                   nn.Identity(),                                   # 23 concat
                   RepC3(2 * w, w, s.repc3),                        # 24 F4
                   Conv(w, w, 3, 2),                                # 25
                   nn.Identity(),                                   # 26 concat
                   RepC3(2 * w, w, s.repc3),                        # 27 F5
                   RTDETRDecoder(num_classes, (w, w, w), s)]        # 28
        assert len(layers) == NUM_LAYERS
        self.model = nn.ModuleList(layers)

    def forward(self, x: torch.Tensor, keep: dict | None = None,
                content: tuple[float, float, float, float] = (0.0, 0.0, 1.0, 1.0)
                ) -> tuple[torch.Tensor, torch.Tensor]:
        """``x`` (N, 3, S, S) RGB in [0, 1] -> (boxes (N, Q, 4) cxcywh in
        [0, 1], logits (N, Q, nc)), float32; queries are picked among the
        anchors inside ``content`` (x0, y0, x1, y1 of the input, the letterbox's
        content box; ``content_box``).  ``keep`` (a dict) receives the
        encoder's scores over every anchor (``enc_scores``), the selected
        anchors (``topk``) and each decoder layer's (boxes, logits)."""
        m = self.model
        with span("backbone"):
            x = m[1](m[0](x))
            p3 = m[3](m[2](x))
            p4 = m[7](m[6](m[5](m[4](p3))))
            p5 = m[9](m[8](p4))
        with span("encoder"):
            y12 = m[12](m[11](m[10](p5)))
            y17 = m[17](m[16](torch.cat([_up(y12), m[14](p4)], dim=1)))
            x3 = m[21](torch.cat([_up(y17), m[19](p3)], dim=1))
            f4 = m[24](torch.cat([m[22](x3), y17], dim=1))
            f5 = m[27](torch.cat([m[25](f4), y12], dim=1))
            value, shapes, queries, ref = m[28].select([x3, f4, f5], content, keep)
        with span("decoder"):
            return m[28].decode(queries, ref, value, shapes, keep)

    def fuse_bn(self) -> "RTDETR":
        """Fold every BatchNorm into its conv (inference only); returns self."""
        for mod in self.modules():
            if isinstance(mod, (Conv, RTDETRDecoder)):
                mod.fuse_bn()
        return self


def content_box(pad_left: int, pad_top: int, width: int, height: int, size: int
                ) -> tuple[float, float, float, float]:
    """A letterbox's content box (x0, y0, x1, y1) as fractions of the
    ``size`` input."""
    return (pad_left / size, pad_top / size, (pad_left + width) / size,
            (pad_top + height) / size)


def _up(x: torch.Tensor) -> torch.Tensor:
    return F.interpolate(x, scale_factor=2.0, mode="nearest")


def build_model(variant: str = "rtdetr-l", num_classes: int = 80) -> RTDETR:
    if variant not in RTDETR_VARIANTS:
        raise KeyError(f"unknown model '{variant}'; choose from {sorted(RTDETR_VARIANTS)}")
    return RTDETR(num_classes, RTDETR_VARIANTS[variant])


def bias_init_with_prob(p: float) -> float:
    return float(-math.log((1 - p) / p))


@torch.no_grad()
def init_random_(model: RTDETR, generator: torch.Generator) -> RTDETR:
    """Random weights from ``generator`` in module order (detections are
    meaningless): He-normal convs, identity BN and LayerNorm, normal linear
    weights of variance 1 / fan-in with zero biases, Ultralytics' sampling
    offset grid and class-score bias (``bias_init_with_prob(0.01)``)."""
    def normal(shape, std):
        return torch.randn(shape, generator=generator) * std

    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if p.ndim == 4:
            p.copy_(normal(p.shape, math.sqrt(2.0 / p[0].numel())))
        elif p.ndim == 2:
            p.copy_(normal(p.shape, 1.0 / math.sqrt(p.shape[1])))
        elif leaf == "weight":           # BN and LayerNorm scales
            p.fill_(1.0)
        else:
            p.zero_()
    for mod in model.modules():
        if isinstance(mod, nn.BatchNorm2d):
            mod.reset_running_stats()
        elif isinstance(mod, MSDeformAttn):
            mod.sampling_offsets.bias.copy_(offset_grid(mod.heads, mod.levels, mod.points))
    dec = model.model[NUM_LAYERS - 1]
    for head in [dec.enc_score_head, *dec.dec_score_head]:
        head.bias.fill_(bias_init_with_prob(0.01))
    return model


def offset_grid(heads: int, levels: int, points: int) -> torch.Tensor:
    """Ultralytics' initial sampling offsets: head h points along angle 2 pi
    h / heads, point i at i + 1 times a unit square's edge; flat (heads *
    levels * points * 2,)."""
    t = torch.arange(heads, dtype=torch.float32) * (2.0 * math.pi / heads)
    g = torch.stack([t.cos(), t.sin()], -1)
    g = (g / g.abs().max(-1, keepdim=True).values).view(heads, 1, 1, 2)
    g = g.repeat(1, levels, points, 1)
    g = g * torch.arange(1, points + 1, dtype=torch.float32).view(1, 1, points, 1)
    return g.flatten()


def load_state(model: RTDETR, state: dict) -> None:
    """Load an Ultralytics-named state dict (numpy arrays or tensors) into an
    unfused ``model``: every parameter and BN buffer must be there with its
    shape (``num_batches_tracked`` is optional), and no other key."""
    own = model.state_dict()
    sd = {k: torch.as_tensor(v).float() for k, v in state.items()
          if not k.endswith("num_batches_tracked")}
    missing = [k for k in own if k not in sd and not k.endswith("num_batches_tracked")]
    extra = [k for k in sd if k not in own]
    if missing or extra:
        raise ValueError(f"weight tree mismatch: missing={missing[:5]} extra={extra[:5]} "
                         f"({len(missing)} missing / {len(extra)} extra)")
    for k, v in sd.items():
        if tuple(v.shape) != tuple(own[k].shape):
            raise ValueError(f"shape mismatch at {k}: {tuple(v.shape)} vs {tuple(own[k].shape)}")
    model.load_state_dict(sd, strict=False)


def detections(boxes: torch.Tensor, logits: torch.Tensor, input_size: int,
               conf_thresh: float, max_det: int,
               class_mask: torch.Tensor | None = None) -> NMSResult:
    """The output step (no NMS; fixed shapes, nothing read back): per query
    the best class probability and its index, kept where it is above
    ``conf_thresh`` and (with ``class_mask``) its class is asked for; the top
    ``max_det`` kept queries by score (ties in query order), padded; boxes
    cxcywh x ``input_size`` -> xyxy in model-input pixels."""
    score, cls = torch.sigmoid(logits.float()).max(dim=-1)
    keep = score > conf_thresh
    if class_mask is not None:
        keep &= class_mask[cls]
    b, q = score.shape
    m = min(max_det, q)
    top, sel = torch.sort(torch.where(keep, score, -1.0), dim=1, descending=True, stable=True)
    top, sel = top[:, :m], sel[:, :m]
    valid = top > 0.0
    cxcywh = torch.gather(boxes.float(), 1, sel[..., None].expand(-1, -1, 4)) * input_size
    xyxy = torch.cat([cxcywh[..., :2] - 0.5 * cxcywh[..., 2:],
                      cxcywh[..., :2] + 0.5 * cxcywh[..., 2:]], dim=-1)
    out_boxes = torch.where(valid[..., None], xyxy, 0.0)
    out_scores = torch.where(valid, top, 0.0)
    out_classes = torch.where(valid, torch.gather(cls, 1, sel), -1).to(torch.int32)
    if m < max_det:
        pad = max_det - m
        out_boxes = torch.cat([out_boxes, out_boxes.new_zeros((b, pad, 4))], dim=1)
        out_scores = torch.cat([out_scores, out_scores.new_zeros((b, pad))], dim=1)
        out_classes = torch.cat([out_classes, out_classes.new_full((b, pad), -1)], dim=1)
        valid = torch.cat([valid, valid.new_zeros((b, pad))], dim=1)
    return NMSResult(out_boxes, out_scores, out_classes, valid,
                     valid.sum(dim=1).to(torch.int32))
