"""The port's native frame packer (``rtmodt_tpu_torch/csrc/framepack.cpp``)
against its plain numpy versions, and the port's ``pack_chunk`` against the
JAX package's.

* The C++ source is built twice here: as ``_build.py`` builds it (``-march=
  native``: on an AVX-512 host the 2x and odd-factor paths run 16-pixel
  AVX-512 blocks) and without ``-march=native`` (the scalar paths only).
  Both, on 1 and 4 threads, must equal ``_pack_2x`` / ``_pack_odd`` byte for
  byte on 2x, 1x and 3x geometries, aligned (``cw % 32 == 0``) and not.
* Fault F3: the port's ``pack_chunk`` took numpy's 2x path on every exact 2x
  geometry and cv2 on every other one, where the reference takes the native
  packer on odd factors and on 2x with ``cw % 32 == 0`` and cv2 elsewhere
  (``rtmodt_tpu/ops/yuv.py::pack_chunk``).  The two must now agree byte for
  byte on the four geometries below; the reference's own native library
  must have loaded, or the comparison would hold cv2 against cv2.
"""

from __future__ import annotations

import os

import numpy as np
import pytest

from rtmodt_tpu.native import _load_framepack as jax_native_lib
from rtmodt_tpu.native import native_pack_wins as jax_native_pack_wins
from rtmodt_tpu.ops.yuv import pack_chunk as jax_pack_chunk
from rtmodt_tpu.ops.yuv import pack_i420_planar as jax_pack_i420_planar
from rtmodt_tpu_torch import _build
from rtmodt_tpu_torch.ops import framepack as fp
from rtmodt_tpu_torch.ops import yuv

# (src_h, src_w, content h, content w, integer factor)
NATIVE_GEOMETRIES = [
    (288, 512, 144, 256, 2),     # 2x, cw % 32 == 0: the AVX-512 2x path
    (240, 416, 120, 208, 2),     # 2x, cw % 32 != 0: the scalar 2x path
    (360, 640, 360, 640, 1),     # 1x: scalar point sampling
    (1080, 1920, 360, 640, 3),   # 3x, cw % 32 == 0: the AVX-512 odd path
    (198, 330, 66, 110, 3),      # 3x, cw % 32 != 0: scalar point sampling
]
# the F3 geometries: (src_h, src_w, model input size, frames)
F3_GEOMETRIES = [(288, 512, 256, 2), (240, 416, 208, 2), (360, 640, 640, 2),
                 (1080, 1920, 640, 1)]


def _frames(n: int, h: int, w: int, seed: int) -> np.ndarray:
    """Random pixels (every rounding case of the chroma arithmetic) and a
    flat-colour frame."""
    rng = np.random.default_rng(seed)
    frames = rng.integers(0, 256, (n, h, w, 3), dtype=np.uint8)
    frames[0, : h // 2] = (30, 200, 200)
    return frames


@pytest.fixture(scope="module")
def builds(tmp_path_factory):
    """{build name: library}: ``_build``'s own, and one without -march=native."""
    src = os.path.join(_build.CSRC_DIR, "framepack.cpp")
    scalar = str(tmp_path_factory.mktemp("fp") / "libframepack_scalar.so")
    _build.compile_source(src, scalar, extra=("-ffp-contract=off",))
    import ctypes

    return {"native": _build.load("framepack"), "scalar": ctypes.CDLL(scalar)}


def _plain(frames: np.ndarray, ch: int, cw: int, s: int) -> fp.Planes:
    n = frames.shape[0]
    out = (np.empty((n, ch, cw), np.uint8), np.empty((n, ch // 2, cw // 2), np.uint8),
           np.empty((n, ch // 2, cw // 2), np.uint8))
    if s == 2:
        fp._pack_2x(frames, out)
    else:
        fp._pack_odd(frames, s, out)
    return out


@pytest.mark.parametrize("threads", [1, 4])
@pytest.mark.parametrize("build", ["native", "scalar"])
@pytest.mark.parametrize("h,w,ch,cw,s", NATIVE_GEOMETRIES)
def test_native_packer_equals_plain_versions(builds, build, threads, h, w, ch, cw, s):
    frames = _frames(5, h, w, seed=h + w + s)
    want = _plain(frames, ch, cw, s)
    got = fp.pack_i420_chunk_native(frames, ch, cw, num_threads=threads, lib=builds[build])
    for name, a, b in zip("yuv", got, want):
        assert a.shape == b.shape and a.dtype == np.uint8
        assert int((a != b).sum()) == 0, f"{name}: {int((a != b).sum())} bytes differ"


def test_native_packer_writes_into_given_planes():
    frames = _frames(3, 288, 512, seed=1)
    out = (np.zeros((3, 144, 256), np.uint8), np.zeros((3, 72, 128), np.uint8),
           np.zeros((3, 72, 128), np.uint8))
    got = fp.pack_i420_chunk_native(frames, 144, 256, out=out)
    assert all(a is b for a, b in zip(got, out))
    for a, b in zip(out, _plain(frames, 144, 256, 2)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="even"):
        fp.pack_i420_chunk_native(frames, 143, 256)
    with pytest.raises(ValueError, match="C-contiguous"):
        fp.pack_i420_chunk_native(frames, 144, 256,
                                  out=(np.zeros((3, 144, 512), np.uint8)[:, :, ::2], *out[1:]))


def test_a_failed_build_raises(tmp_path):
    bad = tmp_path / "broken.cpp"
    bad.write_text("this is not C++\n")
    with pytest.raises(RuntimeError, match="failed"):
        _build.compile_source(str(bad), str(tmp_path / "libbroken.so"))


def test_native_pack_wins_matches_reference():
    for h, w in [(720, 1280), (1080, 1920), (360, 640), (288, 512), (240, 416), (480, 640),
                 (1440, 2560), (2160, 3840), (100, 100)]:
        for size in (160, 208, 256, 320, 640):
            ch, cw = yuv.content_dims(h, w, size)
            assert fp.native_pack_wins(h, w, ch, cw) == jax_native_pack_wins(h, w, ch, cw), \
                (h, w, size)


@pytest.mark.parametrize("h,w,size,n", F3_GEOMETRIES)
def test_pack_chunk_equals_reference(h, w, size, n):
    """F3: byte for byte, through each package's own dispatch."""
    assert jax_native_lib() is not None, "the reference's native packer did not load"
    frames = _frames(n, h, w, seed=size + h)
    (y, u, v), meta = yuv.pack_chunk(frames, size)
    (jy, ju, jv), jmeta = jax_pack_chunk(frames, size)
    assert tuple(meta) == tuple(jmeta)
    for name, a, b in zip("yuv", (y, u, v), (jy, ju, jv)):
        assert a.shape == b.shape and a.dtype == b.dtype == np.uint8
        assert int((a != b).sum()) == 0, f"{name}: {int((a != b).sum())} bytes differ"


def test_pack_chunk_dispatch():
    """Native where it wins (the plain version's bytes), cv2 elsewhere."""
    cv2 = pytest.importorskip("cv2")
    frames = _frames(2, 240, 416, seed=5)
    (y, u, v), _ = yuv.pack_chunk(frames, 208)       # 2x, cw = 208: cv2
    for i in range(2):
        ref = cv2.cvtColor(cv2.resize(frames[i], (208, 120), interpolation=cv2.INTER_LINEAR),
                           cv2.COLOR_BGR2YUV_I420)
        np.testing.assert_array_equal(y[i], ref[:120])
    frames = _frames(2, 288, 512, seed=6)
    (y, u, v), _ = yuv.pack_chunk(frames, 256)       # 2x, cw = 256: native
    for a, b in zip((y, u, v), _plain(frames, 144, 256, 2)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("h,w,size", [(360, 640, 640), (288, 512, 256), (240, 416, 208)])
def test_pack_i420_planar_equals_reference(h, w, size):
    frame = _frames(1, h, w, seed=11)[0]
    (y, u, v), meta = yuv.pack_i420_planar(frame, size)
    (jy, ju, jv), jmeta = jax_pack_i420_planar(frame, size)
    assert tuple(meta) == tuple(jmeta) and y.ndim == 2
    for a, b in zip((y, u, v), (jy, ju, jv)):
        np.testing.assert_array_equal(a, b)
