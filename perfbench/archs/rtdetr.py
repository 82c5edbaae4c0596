"""RT-DETR-L (Zhao et al., arXiv:2304.08069; Ultralytics
``cfg/models/rt-detr/rtdetr-l.yaml``), the architecture of configurations
with ``"arch": "rtdetr"``.

The harness's interface (``perfbench/manifest.py::arch_module``): the
operation count of one forward from the configuration's widths, the plain
reference of ``perfbench/reference/rtdetr.py``, no suppression guarantee (the
detector has no NMS), seeded weights in Ultralytics' state-dict layout, and a
control that rounds the output of every convolution and linear layer of the
program's forward through float8_e4m3fn, the precision below the
configuration's bf16.

The layer list is the yaml's (29 layers); the configuration file names the
widths and depths the yaml and ``RTDETRDecoder`` fix: ``stem`` (HGStem cm,
c2), ``blocks`` (each HGBlock's cm, c2, k, lightconv, shortcut),
``block_convs``, ``neck``, ``aifi_ffn``, ``aifi_heads``, ``repc3``,
``hidden_dim``, ``num_queries``, ``num_heads``, ``num_levels``,
``num_points``, ``num_decoder_layers``, ``dim_feedforward``, ``nc``."""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from perfbench.reference import pack
from perfbench.reference import rtdetr as ref

SUPPRESSED = False
DW_AFTER = (1, 2, 5)      # the yaml's stride-2 depthwise convs precede these HGBlocks

# Seeded weights.  The class-score heads get a gain over the variance-keeping
# linear init: LayerNorm leaves their inputs at unit scale, so their logits
# spread by HEAD_GAIN around the prior bias (bias_init_with_prob(0.01) =
# -4.595), and some queries a frame clear the 0.35 gate (logit -0.62).  The
# decoder's six class heads share the encoder's draw, as training aligns
# them (the encoder's scores pick the queries the decoder is to score
# high): a query that clears the gate then ranks well inside the top 300 of
# the encoder, and bf16's reordering of the near-tied anchors at the top
# 300's edge (flat backgrounds give runs of near-equal scores) rarely
# changes a detection.  The box heads' last layers get BOX_GAIN (Ultralytics
# zeroes them, which would pin every box to its anchor whatever the
# features).
HEAD_GAIN = 1.55
BOX_GAIN = 0.1
PRIOR_BIAS = -math.log((1 - 0.01) / 0.01)


detect = ref.detect


def load_reference(conf: dict, weights_path: str, device: torch.device) -> ref.PlainRTDETR:
    size = conf["pipeline"]["detection"]["input_size"]
    geo = pack.geometry(conf["camera"]["height"], conf["camera"]["width"], size)
    content = (geo.pad_left / size, geo.pad_top / size, (geo.pad_left + geo.cw) / size,
               (geo.pad_top + geo.ch) / size)
    return ref.PlainRTDETR(weights_path, device, conf["num_heads"], conf["aifi_heads"],
                           conf["num_queries"], content)


# -- the layers, from the configuration's widths ----------------------------------

def layers(conf: dict, imgsz: int) -> list[tuple]:
    """Every layer with parameters, in state-dict order:

      ("conv", prefix, c_in, c_out, k, groups, output side, act) - ``prefix
        .conv.weight`` and its BatchNorm ``prefix.bn`` (``prefix.0.weight`` and
        ``prefix.1`` for a decoder input projection); ``act``: a ReLU or SiLU
        follows it;
      ("linear", prefix, d_in, d_out, rows a frame);
      ("norm", prefix, d);
      ("attn", prefix, d, tokens a frame) - ``in_proj_*`` and ``out_proj``;
      ("embed", prefix, n, d);
      ("sample", prefix, queries, heads, levels, points, head dim) - the
        deformable gather (no parameters)."""
    out: list[tuple] = []
    s = imgsz

    def conv(prefix, c1, c2, k, side, groups=1, act=True):
        out.append(("conv", prefix, c1, c2, k, groups, side, act))

    cm, c_stem = conf["stem"]
    conv("model.0.stem1", 3, cm, 3, s // 2)
    conv("model.0.stem2a", cm, cm // 2, 2, s // 2)
    conv("model.0.stem2b", cm // 2, cm, 2, s // 2)
    conv("model.0.stem3", 2 * cm, cm, 3, s // 4)
    conv("model.0.stem4", cm, c_stem, 1, s // 4)
    c, side, idx = c_stem, s // 4, 1
    for i, (bm, c2, k, light, _) in enumerate(conf["blocks"]):
        if i in DW_AFTER:
            side //= 2
            conv(f"model.{idx}", c, c, 3, side, groups=c, act=False)
            idx += 1
        p = f"model.{idx}"
        for j in range(conf["block_convs"]):
            cin = c if j == 0 else bm
            if light:
                conv(f"{p}.m.{j}.conv1", cin, bm, 1, side, act=False)
                conv(f"{p}.m.{j}.conv2", bm, bm, k, side, groups=bm)
            else:
                conv(f"{p}.m.{j}", cin, bm, k, side)
        conv(f"{p}.sc", c + conf["block_convs"] * bm, c2 // 2, 1, side)
        conv(f"{p}.ec", c2 // 2, c2, 1, side)
        c, idx = c2, idx + 1
    blocks = conf["blocks"]
    p3, p4, p5 = blocks[1][1], blocks[4][1], blocks[5][1]
    w = conf["neck"]
    s8, s16, s32 = s // 8, s // 16, s // 32
    t5 = s32 * s32

    def repc3(i, side):
        conv(f"model.{i}.cv1", 2 * w, w, 1, side)
        conv(f"model.{i}.cv2", 2 * w, w, 1, side)
        for j in range(conf["repc3"]):
            # RepConv: SiLU of the two branches' sum
            conv(f"model.{i}.m.{j}.conv1", w, w, 3, side, act=False)
            conv(f"model.{i}.m.{j}.conv2", w, w, 1, side, act=False)

    conv("model.10", p5, w, 1, s32, act=False)
    out.append(("attn", "model.11.ma", w, t5))
    out.append(("linear", "model.11.fc1", w, conf["aifi_ffn"], t5))
    out.append(("linear", "model.11.fc2", conf["aifi_ffn"], w, t5))
    out.append(("norm", "model.11.norm1", w))
    out.append(("norm", "model.11.norm2", w))
    conv("model.12", w, w, 1, s32)
    conv("model.14", p4, w, 1, s16, act=False)
    repc3(16, s16)
    conv("model.17", w, w, 1, s16)
    conv("model.19", p3, w, 1, s8, act=False)
    repc3(21, s8)
    conv("model.22", w, w, 3, s16)
    repc3(24, s16)
    conv("model.25", w, w, 3, s32)
    repc3(27, s32)

    d = "model.28"
    hd, q, nc = conf["hidden_dim"], conf["num_queries"], conf["nc"]
    nh, nl, npt = conf["num_heads"], conf["num_levels"], conf["num_points"]
    v = s8 * s8 + s16 * s16 + t5
    for i, sd in enumerate((s8, s16, s32)):
        conv(f"{d}.input_proj.{i}", w, hd, 1, sd, act=False)

    def mlp(prefix, dims, rows):
        for j, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
            out.append(("linear", f"{prefix}.layers.{j}", a, b, rows))

    for i in range(conf["num_decoder_layers"]):
        p = f"{d}.decoder.layers.{i}"
        out.append(("attn", f"{p}.self_attn", hd, q))
        out.append(("norm", f"{p}.norm1", hd))
        out.append(("linear", f"{p}.cross_attn.sampling_offsets", hd, nh * nl * npt * 2, q))
        out.append(("linear", f"{p}.cross_attn.attention_weights", hd, nh * nl * npt, q))
        out.append(("linear", f"{p}.cross_attn.value_proj", hd, hd, v))
        out.append(("linear", f"{p}.cross_attn.output_proj", hd, hd, q))
        out.append(("sample", f"{p}.cross_attn", q, nh, nl, npt, hd // nh))
        out.append(("norm", f"{p}.norm2", hd))
        out.append(("linear", f"{p}.linear1", hd, conf["dim_feedforward"], q))
        out.append(("linear", f"{p}.linear2", conf["dim_feedforward"], hd, q))
        out.append(("norm", f"{p}.norm3", hd))
    out.append(("embed", f"{d}.denoising_class_embed", nc, hd))
    mlp(f"{d}.query_pos_head", (4, 2 * hd, hd), q * conf["num_decoder_layers"])
    out.append(("linear", f"{d}.enc_output.0", hd, hd, v))
    out.append(("norm", f"{d}.enc_output.1", hd))
    out.append(("linear", f"{d}.enc_score_head", hd, nc, v))
    mlp(f"{d}.enc_bbox_head", (hd, hd, hd, 4), q)
    last = conf["num_decoder_layers"] - 1
    for i in range(conf["num_decoder_layers"]):
        # inference evaluates only the last layer's class scores
        out.append(("linear", f"{d}.dec_score_head.{i}", hd, nc, q if i == last else 0))
    for i in range(conf["num_decoder_layers"]):
        mlp(f"{d}.dec_bbox_head.{i}", (hd, hd, hd, 4), q)
    return out


def init_leaves(conf: dict) -> list[tuple[str, tuple[int, ...], str]]:
    """(key, shape, init) of every array of the Ultralytics-named state dict
    (BatchNorm unfolded, no ``num_batches_tracked``); ``init`` names the
    array's draw in ``seeded_weights``."""
    out = []
    for layer in layers(conf, 640):        # shapes do not depend on the input size
        kind, p = layer[0], layer[1]
        if kind == "conv":
            _, _, c1, c2, k, g, _, act = layer
            dec = ".input_proj." in p
            out.append((f"{p}.0.weight" if dec else f"{p}.conv.weight", (c2, c1 // g, k, k),
                        "he" if act else "conv"))
            bn = f"{p}.1" if dec else f"{p}.bn"
            out += [(f"{bn}.weight", (c2,), "bn_scale"), (f"{bn}.bias", (c2,), "bn_shift"),
                    (f"{bn}.running_mean", (c2,), "bn_shift"),
                    (f"{bn}.running_var", (c2,), "bn_scale")]
        elif kind == "linear":
            d_in, d_out = layer[2], layer[3]
            if ".dec_score_head." in p or p.endswith(".enc_score_head"):
                w, b = "head", "prior"
            elif "bbox_head" in p and p.endswith(".layers.2"):
                w, b = "box_last", "zero"
            elif p.endswith(".sampling_offsets"):
                w, b = "linear", "offsets"
            else:
                w, b = "linear", "zero"
            out += [(f"{p}.weight", (d_out, d_in), w), (f"{p}.bias", (d_out,), b)]
        elif kind == "norm":
            out += [(f"{p}.weight", (layer[2],), "one"), (f"{p}.bias", (layer[2],), "zero")]
        elif kind == "attn":
            dim = layer[2]
            out += [(f"{p}.in_proj_weight", (3 * dim, dim), "linear"),
                    (f"{p}.in_proj_bias", (3 * dim,), "zero"),
                    (f"{p}.out_proj.weight", (dim, dim), "linear"),
                    (f"{p}.out_proj.bias", (dim,), "zero")]
        elif kind == "embed":
            out.append((f"{p}.weight", (layer[2], layer[3]), "linear"))
    return out


def leaves(conf: dict) -> list[tuple[str, tuple[int, ...]]]:
    """(key, shape) of every array of the Ultralytics-named state dict."""
    return [(k, s) for k, s, _ in init_leaves(conf)]


def forward_flops(conf: dict) -> float:
    """Operations of one frame's inference forward (2 per multiply-add):
    every convolution (depthwise and grouped ones by their groups), every
    linear layer over the rows it runs on (the encoder's heads over all
    anchors, one class head in the decoder), both attentions' two matmuls,
    and the deformable sampling (four corner products and the weighted sum,
    10 operations a point and channel, as ``msdeform_bound.py`` counts).
    Norms, activations, softmax, pooling and resampling are not counted, as
    ``flops.py`` does not count them for YOLOv8.  At the configuration's
    ``detection.input_size``."""
    total = 0.0
    for layer in layers(conf, conf["pipeline"]["detection"]["input_size"]):
        kind = layer[0]
        if kind == "conv":
            _, _, c1, c2, k, g, side, _ = layer
            total += 2.0 * side * side * c2 * (c1 // g) * k * k
        elif kind == "linear":
            total += 2.0 * layer[4] * layer[2] * layer[3]
        elif kind == "attn":
            dim, t = layer[2], layer[3]
            total += 2.0 * t * dim * dim * 4 + 2.0 * 2 * t * t * dim
        elif kind == "sample":
            _, _, q, nh, nl, npt, dh = layer
            total += 10.0 * q * nh * nl * npt * dh
    return total


# -- seeded weights ----------------------------------------------------------------

def seeded_weights(conf: dict, seed: int, stem: str, device: str) -> str:
    """Weights drawn from ``seed`` in one call on ``device``, written as
    ``<stem>.npz`` under Ultralytics' names; returns its path.  Ultralytics'
    init where it draws at random: He-normal conv kernels (gain sqrt(2)
    where a ReLU or SiLU follows, 1 where none does), BatchNorm near
    identity (scale and variance 1 + 0.1|z|, shift and mean 0.1 z),
    LayerNorm at unit scale, linear weights of variance 1 / fan-in with zero
    biases, its sampling-offset grid as the offsets' bias, class-score
    biases at ``PRIOR_BIAS``; the class heads at ``HEAD_GAIN`` (the decoder's
    a copy of the encoder's) and the box heads' last layers at ``BOX_GAIN``
    times the linear init."""
    shape = init_leaves(conf)
    sizes = [int(np.prod(s)) for _, s, _ in shape]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    flat = torch.randn(sum(sizes), generator=gen, device=device, dtype=torch.float32)
    grid = offset_grid(conf["num_heads"], conf["num_levels"], conf["num_points"])
    gains = {"linear": 1.0, "head": HEAD_GAIN, "box_last": BOX_GAIN}
    out = {}
    for (key, s, init), x in zip(shape, flat.split(sizes)):
        x = x.reshape(s).cpu()
        if init in ("he", "conv"):
            x = x * math.sqrt((2.0 if init == "he" else 1.0) / (s[1] * s[2] * s[3]))
        elif init in gains:
            x = x * (gains[init] / math.sqrt(s[1]))
        elif init == "bn_scale":
            x = 1.0 + 0.1 * x.abs()
        elif init == "bn_shift":
            x = 0.1 * x
        elif init == "offsets":
            x = grid
        else:
            x = torch.full(s, {"one": 1.0, "zero": 0.0, "prior": PRIOR_BIAS}[init])
        out[key] = x.numpy()
    enc = out["model.28.enc_score_head.weight"]
    for i in range(conf["num_decoder_layers"]):
        out[f"model.28.dec_score_head.{i}.weight"] = enc
    path = stem + ".npz"
    np.savez(path, **out)
    return path if os.path.isabs(path) else os.path.abspath(path)


def offset_grid(heads: int, levels: int, points: int) -> torch.Tensor:
    """Ultralytics' ``MSDeformAttn._reset_parameters`` sampling-offset bias."""
    t = torch.arange(heads, dtype=torch.float32) * (2.0 * math.pi / heads)
    g = torch.stack([t.cos(), t.sin()], -1)
    g = (g / g.abs().max(-1, keepdim=True)[0]).view(heads, 1, 1, 2).repeat(1, levels, points, 1)
    for i in range(points):
        g[:, :, i, :] *= i + 1
    return g.flatten()


# -- the control --------------------------------------------------------------------

def control_detector(pipe, pool) -> None:
    """Round the output of every convolution and linear layer of the
    program's forward through float8_e4m3fn (the value maps the deformable
    sampling reads among them).  The value maps alone are too weak a
    control: the bilinear weights average 48 samples a head, which shrinks
    their rounding below what bf16 elsewhere in the forward moves."""
    def fp8(_mod, _inp, out):
        return out.to(torch.float8_e4m3fn).to(out.dtype)

    for mod in pipe.detector.model.modules():
        if isinstance(mod, (torch.nn.Conv2d, torch.nn.Linear)):
            mod.register_forward_hook(fp8)
