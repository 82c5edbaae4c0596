"""The native host frame packer and its plain numpy versions.

Port of ``rtmodt_tpu/native/__init__.py``'s packer half.  The C++ source
``csrc/framepack.cpp`` (built by ``_build.py`` with the host compiler and
``-march=native``, loaded with ctypes) resizes a whole chunk of BGR frames to
the letterbox content size and converts it to planar I420 in one call that
releases the GIL, on a thread pool over frames.  Its fast paths are the exact
integer downsamples: a 2x2 box average for 2x, point sampling for odd
factors; ``native_pack_wins`` says where they apply (elsewhere cv2 is
faster, and ``ops/yuv.py::pack_chunk`` takes cv2 there, as the reference
does).

``_pack_2x`` and ``_pack_odd`` are the plain numpy versions of the two fast
paths, byte for byte: the 15-bit fixed-point luma and the float32 chroma in
the C++ source's written rounding sequence (its fused multiply-adds emulated
in float64).  No path of the pipeline calls them.

A failed build or load raises; nothing falls back to numpy or cv2.
"""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

Planes = tuple[np.ndarray, np.ndarray, np.ndarray]

_lock = threading.Lock()
_typed: set[int] = set()


def _u8p():
    return np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    with _lock:
        if id(lib) not in _typed:
            lib.pack_i420_chunk.restype = None
            lib.pack_i420_chunk.argtypes = [
                _u8p(), ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, _u8p(), _u8p(), _u8p(), ctypes.c_int]
            _typed.add(id(lib))
    return lib


def default_threads() -> int:
    return min(8, os.cpu_count() or 4)


def pack_i420_chunk_native(frames: np.ndarray, ch: int, cw: int, num_threads: int = 0,
                           out: Planes | None = None,
                           lib: ctypes.CDLL | None = None) -> Planes:
    """(N, H, W, 3) uint8 BGR -> planar ``(y (N, ch, cw), u (N, ch/2, cw/2),
    v)`` in one native call, written into ``out`` when given (C-contiguous
    uint8).  ``num_threads`` <= 0 means ``min(8, cpus)``; ``lib`` is a
    library built from ``csrc/framepack.cpp`` (default: ``_build``'s)."""
    if ch % 2 or cw % 2:
        # I420 needs even content dims; the scalar chroma loop would read and
        # write one element past the row on odd widths
        raise ValueError(f"content dims must be even for I420, got {ch}x{cw}")
    if lib is None:
        from rtmodt_tpu_torch import _build

        lib = _build.load("framepack")
    _declare(lib)
    frames = np.ascontiguousarray(frames, dtype=np.uint8)
    n, h, w = frames.shape[:3]
    if out is None:
        out = (np.empty((n, ch, cw), np.uint8),
               np.empty((n, ch // 2, cw // 2), np.uint8),
               np.empty((n, ch // 2, cw // 2), np.uint8))
    y, u, v = out
    for p, shape in ((y, (n, ch, cw)), (u, (n, ch // 2, cw // 2)), (v, (n, ch // 2, cw // 2))):
        if p.shape != shape or p.dtype != np.uint8 or not p.flags.c_contiguous:
            raise ValueError(f"output plane {p.shape} {p.dtype} is not a C-contiguous "
                             f"uint8 array of shape {shape}")
    if num_threads <= 0:
        num_threads = default_threads()
    lib.pack_i420_chunk(frames, n, h, w, ch, cw, y, u, v, num_threads)
    return y, u, v


def native_pack_wins(src_h: int, src_w: int, ch: int, cw: int) -> bool:
    """True where the native packer's fast paths apply: an exact integer
    downsample, odd, or 2x with a content width that fills the AVX-512
    blocks (``cw % 32 == 0``).  Elsewhere cv2's resize + cvtColor is faster
    than the native scalar fallback."""
    if ch <= 0 or cw <= 0 or src_h % ch or src_w % cw:
        return False
    s = src_h // ch
    if s != src_w // cw:
        return False
    return bool(s & 1) or (s == 2 and cw % 32 == 0)


def _luma(b: np.ndarray, g: np.ndarray, r: np.ndarray, shift: int) -> np.ndarray:
    """15-bit fixed-point luma of per-pixel sums over 2**(shift-15) pixels,
    rounded: 9798 / 19235 / 3736 over 32768 (within 1e-5 of 0.299 / 0.587 /
    0.114)."""
    acc = 9798 * r.astype(np.int32) + 19235 * g.astype(np.int32) + 3736 * b.astype(np.int32)
    return ((acc + (1 << (shift - 1))) >> shift).astype(np.uint8)


def _fma(a: np.ndarray | float, b: np.ndarray | float, c: np.ndarray | float) -> np.ndarray:
    """float32 fused multiply-add, rounded once: the float32 product is exact
    in float64, and the float64 sum rounds to the same float32 but for ties
    of probability ~2**-29."""
    return (np.float64(a) * np.float64(b) + np.float64(c)).astype(np.float32)


def _chroma(s: np.ndarray, inv: float, u: np.ndarray, v: np.ndarray,
            block_order: bool) -> None:
    """U, V of (N, ch, cw, 3) BGR sums: the mean over each 2x2 output block
    (``inv`` = 1 / source pixels in it), then float32 BT.601 in the C++
    source's rounding sequence (``chroma_px``): the block order where its
    AVX-512 path's geometry is, the row order elsewhere."""
    c = (s[:, 0::2, 0::2].astype(np.int32) + s[:, 0::2, 1::2] + s[:, 1::2, 0::2]
         + s[:, 1::2, 1::2])
    c = c.astype(np.float32) * np.float32(inv)
    b4, g4, r4 = c[..., 0], c[..., 1], c[..., 2]
    f32 = np.float32
    g = f32(0.587) * g4
    ku, kv = f32(1.0) / f32(1.773), f32(1.0) / f32(1.403)
    if block_order:
        lum4 = _fma(f32(0.299), r4, _fma(f32(0.114), b4, g))
        uf = _fma(b4 - lum4, ku, f32(128.5))
        vf = _fma(r4 - lum4, kv, f32(128.5))
    else:
        lum4 = _fma(f32(0.114), b4, _fma(f32(0.299), r4, g))
        uf = _fma(b4 - lum4, ku, f32(128.0)) + f32(0.5)
        vf = _fma(r4 - lum4, kv, f32(128.0)) + f32(0.5)
    u[:] = np.clip(uf, 0, 255).astype(np.uint8)
    v[:] = np.clip(vf, 0, 255).astype(np.uint8)


def _pack_2x(frames: np.ndarray, out: Planes) -> None:
    """Exact 2x downsample + BT.601 of (N, 2ch, 2cw, 3) BGR into ``out``:
    2x2 box sums, luma over 4-pixel sums (>> 17)."""
    y, u, v = out
    f = frames.astype(np.uint16)
    s = f[:, 0::2, 0::2] + f[:, 0::2, 1::2] + f[:, 1::2, 0::2] + f[:, 1::2, 1::2]
    y[:] = _luma(s[..., 0], s[..., 1], s[..., 2], 17)
    _chroma(s, 1.0 / 16.0, u, v, block_order=y.shape[2] % 32 == 0)


def _pack_odd(frames: np.ndarray, s: int, out: Planes) -> None:
    """Exact odd-factor downsample + BT.601 of (N, s*ch, s*cw, 3) BGR into
    ``out``: bilinear at an odd integer scale samples source pixel
    ``s*i + (s-1)/2`` exactly, so this is point sampling; luma per pixel
    (>> 15), chroma over each 2x2 block of samples."""
    y, u, v = out
    ch, cw = y.shape[1:]
    off = (s - 1) // 2
    p = frames[:, off::s, off::s][:, :ch, :cw].astype(np.uint16)
    y[:] = _luma(p[..., 0], p[..., 1], p[..., 2], 15)
    _chroma(p, 1.0 / 4.0, u, v, block_order=s >= 3 and cw % 32 == 0)
