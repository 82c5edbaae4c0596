"""Multi-scale deformable attention's sampling (``ops/msdeform.py``): the plain
version against a direct loop over points, and the CUDA kernel G2
(``csrc/msdeform_kernel.cu``) against the plain version on the card.

* CPU: ``msdeform_plain`` (``grid_sample`` per level) against a float64 loop
  that applies the bilinear rule point by point (``x = loc_x * w - 0.5``,
  corners outside a level count zero), on small shapes with locations
  inside, on the edge of and outside every level; the wrapper's CPU route,
  its counters and its refusals.
* ``cuda``: the kernel against the plain version at the decoder's shapes
  (B 2 and 16, 300 queries, 8 heads, levels 80x80 / 40x40 / 20x20, 4
  points, 32 channels a head), bf16 value maps with float32 locations and
  weights: within one bf16 rounding of the output (both sum in float32 in
  other orders, then round to bf16), and float32 value maps within 1e-5;
  locations outside every level give zero.

This file imports neither JAX nor the JAX package: on the card, ``python -m
pytest --noconftest -m cuda tests/test_torch_port_msdeform.py``.  Without a
card the kernel tests skip (a CUDA kernel has no CPU mode).
"""

from __future__ import annotations

import itertools

import numpy as np
import pytest
import torch

from rtmodt_tpu_torch.ops import msdeform
from rtmodt_tpu_torch.ops.msdeform import msdeform_attn, msdeform_plain
from rtmodt_tpu_torch.profiling import spans

SMALL_SHAPES = ((3, 5), (2, 2), (1, 3))
DECODER_SHAPES = ((80, 80), (40, 40), (20, 20))


def case(b: int, q: int, h: int, d: int, shapes, p: int, seed: int, lo: float = -0.3,
         hi: float = 1.3, dtype=torch.float32):
    """(value (B, V, H, D), locations (B, Q, H, L, P, 2), weights (B, Q, H, L,
    P)) with locations uniform in [lo, hi] of each level."""
    g = torch.Generator().manual_seed(seed)
    v = sum(a * c for a, c in shapes)
    value = torch.randn(b, v, h, d, generator=g).to(dtype)
    loc = lo + (hi - lo) * torch.rand(b, q, h, len(shapes), p, 2, generator=g)
    w = torch.softmax(torch.randn(b, q, h, len(shapes) * p, generator=g), -1)
    return value, loc, w.view(b, q, h, len(shapes), p)


def direct(value, shapes, loc, w) -> np.ndarray:
    """The bilinear rule point by point in float64."""
    value, loc, w = (t.double().numpy() for t in (value, loc, w))
    b, _, h, d = value.shape
    q, nl, p = loc.shape[1], loc.shape[3], loc.shape[4]
    starts = np.cumsum([0] + [a * c for a, c in shapes])
    out = np.zeros((b, q, h, d))
    for bi, qi, hi, li, pi in itertools.product(range(b), range(q), range(h), range(nl),
                                                range(p)):
        hh, ww = shapes[li]
        x = loc[bi, qi, hi, li, pi, 0] * ww - 0.5
        y = loc[bi, qi, hi, li, pi, 1] * hh - 0.5
        x0, y0 = int(np.floor(x)), int(np.floor(y))
        for cx, cy in ((x0, y0), (x0 + 1, y0), (x0, y0 + 1), (x0 + 1, y0 + 1)):
            if 0 <= cx < ww and 0 <= cy < hh:
                k = (1 - abs(x - cx)) * (1 - abs(y - cy))
                out[bi, qi, hi] += (w[bi, qi, hi, li, pi] * k
                                    * value[bi, starts[li] + cy * ww + cx, hi])
    return out.reshape(b, q, h * d)


@pytest.mark.parametrize("lo,hi", [(0.0, 1.0), (-0.3, 1.3), (-2.0, -1.0), (1.2, 3.0)])
def test_plain_version_matches_the_direct_loop(lo, hi):
    value, loc, w = case(2, 3, 2, 4, SMALL_SHAPES, 4, seed=int(10 * (lo + hi)) + 7, lo=lo, hi=hi)
    got = msdeform_plain(value, SMALL_SHAPES, loc, w)
    assert got.shape == (2, 3, 8) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), direct(value, SMALL_SHAPES, loc, w), atol=1e-6)
    if lo > 1.0 or hi < 0.0:
        assert not got.any()          # wholly outside every level: padding only


def test_plain_version_on_pixel_centres_and_edges():
    # a location on a pixel centre reads that pixel; half a pixel out of a
    # level's edge reads half its edge pixel
    value = torch.arange(15, dtype=torch.float32).view(1, 15, 1, 1)
    shapes = ((3, 5),)
    loc = torch.tensor([[(2.5 / 5, 1.5 / 3), (0.0, 1.5 / 3), (1.0 + 0.1 / 5, 0.5 / 3)]])
    loc = loc.view(1, 3, 1, 1, 1, 2)
    w = torch.ones(1, 3, 1, 1, 1)
    got = msdeform_plain(value, shapes, loc, w).flatten().tolist()
    assert got == pytest.approx([7.0, 0.5 * 5.0, 0.4 * 4.0], abs=1e-6)


def test_wrapper_routes_cpu_tensors_counts_and_refuses():
    value, loc, w = case(1, 4, 2, 4, SMALL_SHAPES, 2, seed=3, dtype=torch.bfloat16)
    launches = msdeform.launches
    spans.drain_counts()
    spans.enable()
    try:
        out = msdeform_attn(value, SMALL_SHAPES, loc, w)
    finally:
        spans.disable()
    assert out.dtype == torch.bfloat16 and out.shape == (1, 4, 8)
    assert torch.equal(out, msdeform_plain(value, SMALL_SHAPES, loc, w))
    assert msdeform.launches == launches          # no kernel for CPU tensors
    assert spans.drain_counts() == {"msdeform_launches": 1, "msdeform_points": 4 * 2 * 3 * 2}
    with pytest.raises(ValueError, match="CUDA or CPU"):
        msdeform_attn(value.to("meta"), SMALL_SHAPES, loc.to("meta"), w.to("meta"))


# -- the kernel on the card --------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA: the kernel has no CPU mode")
    return torch.device("cuda")


def _on_card(dev, *ts):
    return tuple(t.to(dev) for t in ts)


@pytest.mark.cuda
@pytest.mark.parametrize("b,lo,hi", [(2, 0.0, 1.0), (16, -0.1, 1.1), (4, -0.5, 1.5)])
def test_kernel_matches_plain_version_bf16(cuda_device, b, lo, hi):
    value, loc, w = _on_card(cuda_device, *case(b, 300, 8, 32, DECODER_SHAPES, 4, seed=b,
                                                lo=lo, hi=hi, dtype=torch.bfloat16))
    launches = msdeform.launches
    got = msdeform_attn(value, DECODER_SHAPES, loc, w)
    torch.cuda.synchronize()
    assert msdeform.launches == launches + 1
    assert got.dtype == torch.bfloat16 and got.shape == (b, 300, 256)
    want = msdeform_plain(value.float(), DECODER_SHAPES, loc, w)
    # one bf16 rounding of a float32 sum taken in another order
    torch.testing.assert_close(got.float(), want, rtol=2 ** -7, atol=1e-6)


@pytest.mark.cuda
def test_kernel_matches_plain_version_float32(cuda_device):
    value, loc, w = _on_card(cuda_device, *case(3, 300, 8, 32, DECODER_SHAPES, 4, seed=5))
    got = msdeform_attn(value, DECODER_SHAPES, loc, w)
    want = msdeform_plain(value, DECODER_SHAPES, loc, w)
    torch.cuda.synchronize()
    # float32 sums in another order, and x = loc * w - 0.5 against grid_sample's
    # ((2 loc - 1 + 1) w - 1) / 2
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_kernel_outside_every_level_reads_zero(cuda_device):
    value, loc, w = _on_card(cuda_device, *case(2, 300, 8, 32, DECODER_SHAPES, 4, seed=9,
                                                lo=1.1, hi=4.0, dtype=torch.bfloat16))
    got = msdeform_attn(value, DECODER_SHAPES, loc, w)
    torch.cuda.synchronize()
    assert not got.any()


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take(cuda_device):
    value, loc, w = _on_card(cuda_device, *case(1, 8, 2, 16, SMALL_SHAPES, 2, seed=1))
    with pytest.raises(ValueError, match="32 channels a head"):
        msdeform_attn(value, SMALL_SHAPES, loc, w)
    value, loc, w = _on_card(cuda_device, *case(1, 8, 2, 32, SMALL_SHAPES, 2, seed=1))
    with pytest.raises(ValueError, match="float32"):
        msdeform_attn(value, SMALL_SHAPES, loc.double(), w)
    with pytest.raises(ValueError, match="positions"):
        msdeform_attn(value, ((3, 5), (2, 2), (1, 4)), loc, w)
