"""The int8 convolution of the quantized detector: int8 x int8 -> int32.

The reference computes it with XLA's ``lax.conv_general_dilated(...,
preferred_element_type=int32)`` outside any Pallas kernel
(``rtmodt_tpu/quant/ptq.py``).  PyTorch has no int8 convolution on CUDA, so
the port lowers it to an im2col over the padded NHWC input and one int8
matrix product, ``torch._int_mm`` (cuBLASLt on the card):

    a (B*Ho*Wo, kh*kw*cin) int8  @  w (kh*kw*cin, cout) int8  ->  int32

The column order of ``a`` is (dy, dx, channel), the order of the reference's
HWIO kernel flattened, so ``w`` is that kernel reshaped.  On the card
``_int_mm`` needs more than 16 rows and a multiple of 8 for the inner and
output dimensions: ``int8_mm`` pads with zero rows / columns, which add
nothing to any product, and never falls back to a float product.

``int8_mm_reference`` is the plain version: the int64 product of the same
operands (on the card computed in float64, exact because every partial sum
is an integer far below 2**53).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

launches = 0     # int8_mm calls that ran torch._int_mm on a card


def im2col_int8(xq: torch.Tensor, kernel: int, stride: int
                ) -> tuple[torch.Tensor, tuple[int, int, int]]:
    """int8 NCHW input -> (a (B*Ho*Wo, kernel*kernel*C) contiguous, (B, Ho,
    Wo)), with the zero padding ``kernel // 2`` of a "same" conv."""
    b, c, h, w = xq.shape
    x = xq.permute(0, 2, 3, 1)                  # NHWC (a view of channels_last)
    pad = kernel // 2
    if pad:
        x = F.pad(x, (0, 0, pad, pad, pad, pad))
    ho = (h + 2 * pad - kernel) // stride + 1
    wo = (w + 2 * pad - kernel) // stride + 1
    if kernel == 1 and stride == 1:
        return x.reshape(b * ho * wo, c).contiguous(), (b, ho, wo)
    cols = [x[:, dy:dy + stride * (ho - 1) + 1:stride, dx:dx + stride * (wo - 1) + 1:stride]
            for dy in range(kernel) for dx in range(kernel)]
    a = torch.stack(cols, dim=3)                # (B, Ho, Wo, k*k, C)
    return a.reshape(b * ho * wo, kernel * kernel * c), (b, ho, wo)


def _pad_to(t: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    if t.shape == (rows, cols):
        return t
    return F.pad(t, (0, cols - t.shape[1], 0, rows - t.shape[0]))


def int8_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a`` (M, K) int8 @ ``b`` (K, N) int8 -> (M, N) int32, exact."""
    m, k = a.shape
    n = b.shape[1]
    if a.device.type != "cuda":
        return torch._int_mm(a.contiguous(), b.contiguous())
    global launches
    # cuBLASLt's int8 GEMM as PyTorch exposes it: M > 16, K and N multiples of 8,
    # both operands row-major
    mp, kp, np_ = max(m, 17), -(-k // 8) * 8, -(-n // 8) * 8
    out = torch._int_mm(_pad_to(a, mp, kp).contiguous(), _pad_to(b, kp, np_).contiguous())
    launches += 1
    return out[:m, :n] if (mp, np_) != (m, n) else out


def int8_mm_reference(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The plain version of ``int8_mm``: the int64 product (M, N)."""
    if a.device.type == "cuda":
        # no int64 GEMM on the card; a float64 product is exact while
        # K * 127 * 127 < 2**53
        assert a.shape[1] * 127 * 127 < 2 ** 53
        return (a.double() @ b.double()).long()
    return a.long() @ b.long()


def int8_conv2d(xq: torch.Tensor, wmat: torch.Tensor, kernel: int, stride: int,
                mm=int8_mm) -> torch.Tensor:
    """int8 NCHW ``xq`` conv the flattened HWIO kernel ``wmat`` (kernel *
    kernel * cin, cout) int8 -> the accumulators (B, cout, Ho, Wo) in
    ``mm``'s dtype (int32; int64 with ``int8_mm_reference``), channels_last
    in memory."""
    a, (b, ho, wo) = im2col_int8(xq, kernel, stride)
    y = mm(a, wmat)
    return y.reshape(b, ho, wo, -1).permute(0, 3, 1, 2)
