// Native frame packer: BGR chunk -> letterbox-resized planar I420.
//
// Host source of the port (a copy of the reference package's packer), built
// with the host C++ compiler and -march=native by rtmodt_tpu_torch/_build.py
// and loaded with ctypes by rtmodt_tpu_torch/ops/framepack.py. Bilinear
// resize of each BGR frame to the model content size and BT.601 conversion
// to planar Y/U/V, for a whole chunk of frames in ONE call: the GIL is
// released for the entire chunk instead of per OpenCV call.
//
// Fast paths (the production geometries are exact integer downsamples):
//   * 2x  (720p -> 640x360 content): bilinear at scale 2 degenerates to an
//     exact 2x2 box average -> two contiguous SIMD-friendly passes
//     (vertical u8+u8->u16 add, horizontal pairwise add) + fixed-point
//     luma, with chroma from the running 4x4 sums. One sweep over the
//     source, no intermediate resized image.
//   * odd s (1080p -> 640x360 is s=3): bilinear at odd integer scale hits
//     source pixel centers exactly -> pure point sampling.
// Any other geometry falls back to the generic scalar bilinear.
// The AVX-512 forms of both fast paths compile only where the compiler
// targets AVX-512BW and AVX-512VL (hence -march=native); the scalar forms
// compute the same bytes.
//
// Color constants are the exact inverse of the device decode in
// rtmodt_tpu_torch/ops/yuv.py::planar_letterbox (R = Y + 1.403 Vc etc.), so
// pack -> unpack is numerically closed.
//
// Rounding. Luma is integer. Chroma is float32 in one of two fixed rounding
// sequences with explicit fused multiply-adds (chroma_px below): the row
// order where the fast paths run scalar rows, the block order where they run
// 16-pixel AVX-512 blocks (cw % 32 == 0; s == 2 or odd s >= 3). A build
// without AVX-512 takes the block order on those geometries too, so every
// build gives the same bytes. The source is compiled with
// -ffp-contract=off: no fusion other than the written ones. The sequences
// are those g++ 12 -O3 -march=native makes of the reference's expressions on
// an AVX-512 host, so the bytes equal the reference's there.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

#if defined(__AVX512BW__) && defined(__AVX512VL__)
#include <immintrin.h>
#define FRAMEPACK_AVX512 1
#endif

namespace {

inline uint8_t clamp_u8(float v) {
  return static_cast<uint8_t>(std::max(0.f, std::min(255.f, v + 0.5f)));
}

// ---------------------------------------------------------------------------
// Generic scalar bilinear (fallback for non-integer scales).

inline void sample_bilinear(const uint8_t* img, int h, int w, float fy, float fx,
                            float* bgr) {
  const int x0 = std::max(0, std::min(w - 1, static_cast<int>(fx)));
  const int y0 = std::max(0, std::min(h - 1, static_cast<int>(fy)));
  const int x1 = std::min(w - 1, x0 + 1);
  const int y1 = std::min(h - 1, y0 + 1);
  const float ax = fx - x0;
  const float ay = fy - y0;
  const float w00 = (1 - ax) * (1 - ay), w01 = ax * (1 - ay);
  const float w10 = (1 - ax) * ay, w11 = ax * ay;
  const uint8_t* p00 = img + (static_cast<size_t>(y0) * w + x0) * 3;
  const uint8_t* p01 = img + (static_cast<size_t>(y0) * w + x1) * 3;
  const uint8_t* p10 = img + (static_cast<size_t>(y1) * w + x0) * 3;
  const uint8_t* p11 = img + (static_cast<size_t>(y1) * w + x1) * 3;
  for (int c = 0; c < 3; ++c) {
    bgr[c] = w00 * p00[c] + w01 * p01[c] + w10 * p10[c] + w11 * p11[c];
  }
}

void pack_one_generic(const uint8_t* frame, int src_h, int src_w, int ch, int cw,
                      uint8_t* y_out, uint8_t* u_out, uint8_t* v_out) {
  const float sy = static_cast<float>(src_h) / ch;
  const float sx = static_cast<float>(src_w) / cw;
  std::vector<float> rrow(cw), grow(cw), brow(cw);
  std::vector<float> re(cw), ge(cw), be(cw);

  for (int yy = 0; yy < ch; ++yy) {
    const float fy = (yy + 0.5f) * sy - 0.5f;
    for (int xx = 0; xx < cw; ++xx) {
      const float fx = (xx + 0.5f) * sx - 0.5f;
      float bgr[3];
      sample_bilinear(frame, src_h, src_w, std::max(0.f, fy), std::max(0.f, fx), bgr);
      brow[xx] = bgr[0];
      grow[xx] = bgr[1];
      rrow[xx] = bgr[2];
      const float lum = 0.299f * bgr[2] + 0.587f * bgr[1] + 0.114f * bgr[0];
      y_out[static_cast<size_t>(yy) * cw + xx] = clamp_u8(lum);
    }
    if ((yy & 1) == 0) {
      re = rrow; ge = grow; be = brow;
    } else {
      // chroma from the 2x2 average (standard 4:2:0 siting)
      uint8_t* urow = u_out + static_cast<size_t>(yy / 2) * (cw / 2);
      uint8_t* vrow = v_out + static_cast<size_t>(yy / 2) * (cw / 2);
      for (int xx = 0; xx < cw; xx += 2) {
        const float r4 = 0.25f * (re[xx] + re[xx + 1] + rrow[xx] + rrow[xx + 1]);
        const float g4 = 0.25f * (ge[xx] + ge[xx + 1] + grow[xx] + grow[xx + 1]);
        const float b4 = 0.25f * (be[xx] + be[xx + 1] + brow[xx] + brow[xx + 1]);
        const float lum4 = 0.299f * r4 + 0.587f * g4 + 0.114f * b4;
        urow[xx / 2] = clamp_u8((b4 - lum4) / 1.773f + 128.f);
        vrow[xx / 2] = clamp_u8((r4 - lum4) / 1.403f + 128.f);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Shared fixed-point luma/chroma from per-output-pixel BGR sums.
//
// `sum_scale` = how many source pixels each (b,g,r) sum aggregates (4 for the
// 2x box path, 1 for point sampling).  Luma in 15-bit fixed point:
// 9798/32768 = 0.299004, 19235/32768 = 0.587006, 3736/32768 = 0.114014 -
// within 1e-5 of the float constants the device decode inverts.

template <int SUM_SCALE>
inline void luma_row_from_sums(const uint16_t* bs, const uint16_t* gs,
                               const uint16_t* rs, int cw, uint8_t* y_row) {
  // (coef * sum) >> (15 + log2(SUM_SCALE)), with +0.5 rounding. Sums are
  // <= 255*SUM_SCALE so 19235 * 1020 < 2^31: int32 is safe.
  constexpr int SHIFT = SUM_SCALE == 4 ? 17 : 15;
  constexpr int32_t ROUND = 1 << (SHIFT - 1);
  for (int xx = 0; xx < cw; ++xx) {
    int32_t acc = 9798 * rs[xx] + 19235 * gs[xx] + 3736 * bs[xx] + ROUND;
    y_row[xx] = static_cast<uint8_t>(acc >> SHIFT);  // coeffs sum < 1: no clamp needed
  }
}

// Chroma for one output row pair from this row's and the previous row's
// per-output-pixel BGR sums (each aggregating SUM_SCALE source pixels):
// the 2x2 average over output pixels -> 4*SUM_SCALE source pixels.
// U and V of one 2x2 block from its mean B, G, R.
//   row order:   lum = fma(.114, b, fma(.299, r, .587 g));
//                u = trunc(clamp(fma(b - lum, 1/1.773, 128) + 0.5))
//   block order: lum = fma(.299, r, fma(.114, b, .587 g));
//                u = trunc(clamp(fma(b - lum, 1/1.773, 128.5)))
// (v likewise with r and 1/1.403).
template <bool BLOCK_ORDER>
inline void chroma_px(float b4, float g4, float r4, uint8_t* u, uint8_t* v) {
  constexpr float KU = 1.0f / 1.773f, KV = 1.0f / 1.403f;
  const float g = 0.587f * g4;
  if (BLOCK_ORDER) {
    const float lum4 = std::fma(0.299f, r4, std::fma(0.114f, b4, g));
    *u = static_cast<uint8_t>(std::max(0.f, std::min(255.f, std::fma(b4 - lum4, KU, 128.5f))));
    *v = static_cast<uint8_t>(std::max(0.f, std::min(255.f, std::fma(r4 - lum4, KV, 128.5f))));
  } else {
    const float lum4 = std::fma(0.114f, b4, std::fma(0.299f, r4, g));
    *u = clamp_u8(std::fma(b4 - lum4, KU, 128.f));
    *v = clamp_u8(std::fma(r4 - lum4, KV, 128.f));
  }
}

template <int SUM_SCALE, bool BLOCK_ORDER>
inline void chroma_row_from_sums(const uint16_t* be, const uint16_t* ge,
                                 const uint16_t* re, const uint16_t* bo,
                                 const uint16_t* go, const uint16_t* ro,
                                 int cw, uint8_t* u_row, uint8_t* v_row) {
  constexpr float INV = 1.0f / (4.0f * SUM_SCALE);
  for (int xc = 0; xc < cw / 2; ++xc) {
    const int x0 = 2 * xc, x1 = 2 * xc + 1;
    const float b4 = INV * (be[x0] + be[x1] + bo[x0] + bo[x1]);
    const float g4 = INV * (ge[x0] + ge[x1] + go[x0] + go[x1]);
    const float r4 = INV * (re[x0] + re[x1] + ro[x0] + ro[x1]);
    chroma_px<BLOCK_ORDER>(b4, g4, r4, u_row + xc, v_row + xc);
  }
}

#ifdef FRAMEPACK_AVX512

// Shared AVX-512 chroma pass: one U/V output row from two rows of
// deinterleaved per-output-pixel B/G/R u16 sums (each aggregating
// `sum_scale` source pixels).  Requires cw % 32 == 0.
void chroma_rows_avx512(const uint16_t* be, const uint16_t* ge,
                        const uint16_t* re, const uint16_t* bo,
                        const uint16_t* go, const uint16_t* ro, int cw,
                        uint8_t* urow, uint8_t* vrow, float sum_scale) {
  const __m512i ones16 = _mm512_set1_epi16(1);
  const __m512 inv = _mm512_set1_ps(1.0f / (4.0f * sum_scale));
  const __m512 kr = _mm512_set1_ps(0.299f);
  const __m512 kg = _mm512_set1_ps(0.587f);
  const __m512 kb = _mm512_set1_ps(0.114f);
  const __m512 ku = _mm512_set1_ps(1.0f / 1.773f);
  const __m512 kv = _mm512_set1_ps(1.0f / 1.403f);
  const __m512 k128 = _mm512_set1_ps(128.5f);      // +0.5 = round after truncate
  const __m512 v0 = _mm512_set1_ps(0.0f);
  const __m512 v255 = _mm512_set1_ps(255.0f);
  for (int xc = 0; xc < cw / 2; xc += 16) {
    const int x0 = 2 * xc;
    const __m512i bsum = _mm512_add_epi16(
        _mm512_loadu_si512(be + x0), _mm512_loadu_si512(bo + x0));
    const __m512i gsum = _mm512_add_epi16(
        _mm512_loadu_si512(ge + x0), _mm512_loadu_si512(go + x0));
    const __m512i rsum = _mm512_add_epi16(
        _mm512_loadu_si512(re + x0), _mm512_loadu_si512(ro + x0));
    const __m512 bf = _mm512_mul_ps(
        _mm512_cvtepi32_ps(_mm512_madd_epi16(bsum, ones16)), inv);
    const __m512 gf = _mm512_mul_ps(
        _mm512_cvtepi32_ps(_mm512_madd_epi16(gsum, ones16)), inv);
    const __m512 rf = _mm512_mul_ps(
        _mm512_cvtepi32_ps(_mm512_madd_epi16(rsum, ones16)), inv);
    // the block order of chroma_px
    const __m512 lum = _mm512_fmadd_ps(
        kr, rf, _mm512_fmadd_ps(kb, bf, _mm512_mul_ps(kg, gf)));
    __m512 uf = _mm512_fmadd_ps(_mm512_sub_ps(bf, lum), ku, k128);
    __m512 vf = _mm512_fmadd_ps(_mm512_sub_ps(rf, lum), kv, k128);
    uf = _mm512_max_ps(v0, _mm512_min_ps(v255, uf));
    vf = _mm512_max_ps(v0, _mm512_min_ps(v255, vf));
    _mm_storeu_si128(reinterpret_cast<__m128i*>(urow + xc),
                     _mm512_cvtepi32_epi8(_mm512_cvttps_epi32(uf)));
    _mm_storeu_si128(reinterpret_cast<__m128i*>(vrow + xc),
                     _mm512_cvtepi32_epi8(_mm512_cvttps_epi32(vf)));
  }
}

// AVX-512 odd-factor path (1080p -> 640x360 is s=3): bilinear at odd
// integer scale lands exactly on source pixel centers, so each output
// pixel is a dword gather at byte stride 3s (the 4th gathered byte is the
// next pixel's B, masked away).  Requires s >= 3 (s=1 would overread one
// byte past the last pixel) and cw % 32 == 0.
void pack_one_odd_avx512(const uint8_t* frame, int src_w, int s, int ch,
                         int cw, uint8_t* y_out, uint8_t* u_out,
                         uint8_t* v_out) {
  const size_t rstride = static_cast<size_t>(src_w) * 3;
  const int off = (s - 1) / 2;
  std::vector<uint16_t> bs[2], gs[2], rs[2];
  for (int k = 0; k < 2; ++k) {
    bs[k].resize(cw); gs[k].resize(cw); rs[k].resize(cw);
  }
  alignas(64) int32_t idx[16];
  for (int i = 0; i < 16; ++i) idx[i] = 3 * s * i;
  const __m512i vidx = _mm512_load_si512(idx);
  const __m512i mask8 = _mm512_set1_epi32(0xFF);
  const __m512i cb = _mm512_set1_epi32(3736);
  const __m512i cg = _mm512_set1_epi32(19235);
  const __m512i cr = _mm512_set1_epi32(9798);
  const __m512i yround = _mm512_set1_epi32(1 << 14);

  for (int yy = 0; yy < ch; ++yy) {
    const uint8_t* row =
        frame + static_cast<size_t>(s * yy + off) * rstride + 3 * off;
    const int par = yy & 1;
    uint16_t* brow = bs[par].data();
    uint16_t* grow = gs[par].data();
    uint16_t* rrow = rs[par].data();
    uint8_t* yrow = y_out + static_cast<size_t>(yy) * cw;
    for (int x = 0; x < cw; x += 16) {
      const __m512i g = _mm512_i32gather_epi32(
          vidx, row + static_cast<size_t>(3 * s) * x, 1);
      const __m512i bi = _mm512_and_si512(g, mask8);
      const __m512i gi = _mm512_and_si512(_mm512_srli_epi32(g, 8), mask8);
      const __m512i ri = _mm512_and_si512(_mm512_srli_epi32(g, 16), mask8);
      _mm256_storeu_si256(reinterpret_cast<__m256i*>(brow + x),
                          _mm512_cvtepi32_epi16(bi));
      _mm256_storeu_si256(reinterpret_cast<__m256i*>(grow + x),
                          _mm512_cvtepi32_epi16(gi));
      _mm256_storeu_si256(reinterpret_cast<__m256i*>(rrow + x),
                          _mm512_cvtepi32_epi16(ri));
      __m512i acc = _mm512_mullo_epi32(cb, bi);
      acc = _mm512_add_epi32(acc, _mm512_mullo_epi32(cg, gi));
      acc = _mm512_add_epi32(acc, _mm512_mullo_epi32(cr, ri));
      acc = _mm512_srli_epi32(_mm512_add_epi32(acc, yround), 15);
      _mm_storeu_si128(reinterpret_cast<__m128i*>(yrow + x),
                       _mm512_cvtepi32_epi8(acc));
    }
    if (par) {
      chroma_rows_avx512(bs[0].data(), gs[0].data(), rs[0].data(),
                         bs[1].data(), gs[1].data(), rs[1].data(), cw,
                         u_out + static_cast<size_t>(yy / 2) * (cw / 2),
                         v_out + static_cast<size_t>(yy / 2) * (cw / 2), 1.0f);
    }
  }
}

// AVX-512 2x path. Per output row:
//   pass 1: vertical u8+u8 -> u16 row sum (contiguous)
//   pass 2: horizontal pair add with BGR-triple stride-6 compaction
//           (permutex2var 16-bit gathers over a sliding 64-lane window)
//   pass 3: deinterleave to B/G/R u16 rows + fixed-point luma
//   pass 4 (odd rows): chroma from the 2x2 sums of two B/G/R rows
// Requires cw % 32 == 0 (the production content widths 640/160 qualify).

void pack_one_2x_avx512(const uint8_t* frame, int src_w, int ch, int cw,
                        uint8_t* y_out, uint8_t* u_out, uint8_t* v_out) {
  const size_t rstride = static_cast<size_t>(src_w) * 3;
  std::vector<uint16_t> vsum(rstride + 64);       // +64: sliding-window overread
  std::vector<uint16_t> hrow(static_cast<size_t>(cw) * 3 + 64);
  std::vector<uint16_t> bs[2], gs[2], rs[2];
  for (int k = 0; k < 2; ++k) {
    bs[k].resize(cw); gs[k].resize(cw); rs[k].resize(cw);
  }

  // pass-2 gather indices: lanes 0..23 pick u16 positions {6x+c} (x<8, c<3)
  alignas(64) uint16_t idxl[32], idxr[32];
  for (int i = 0; i < 32; ++i) {
    const int x = i / 3, c = i % 3;
    idxl[i] = i < 24 ? static_cast<uint16_t>(6 * x + c) : 0;
    idxr[i] = i < 24 ? static_cast<uint16_t>(6 * x + 3 + c) : 0;
  }
  const __m512i vidxl = _mm512_load_si512(idxl);
  const __m512i vidxr = _mm512_load_si512(idxr);
  // pass-3 deinterleave indices: lanes 0..15 pick {3j+c} (j<16)
  alignas(64) uint16_t idxb[32], idxg[32], idxrr[32];
  for (int i = 0; i < 32; ++i) {
    idxb[i] = i < 16 ? static_cast<uint16_t>(3 * i) : 0;
    idxg[i] = i < 16 ? static_cast<uint16_t>(3 * i + 1) : 0;
    idxrr[i] = i < 16 ? static_cast<uint16_t>(3 * i + 2) : 0;
  }
  const __m512i vidxb = _mm512_load_si512(idxb);
  const __m512i vidxg = _mm512_load_si512(idxg);
  const __m512i vidxr3 = _mm512_load_si512(idxrr);

  const __m512i cb = _mm512_set1_epi32(3736);
  const __m512i cg = _mm512_set1_epi32(19235);
  const __m512i cr = _mm512_set1_epi32(9798);
  const __m512i yround = _mm512_set1_epi32(1 << 16);

  for (int yy = 0; yy < ch; ++yy) {
    const uint8_t* p0 = frame + static_cast<size_t>(2 * yy) * rstride;
    const uint8_t* p1 = p0 + rstride;
    // pass 1: vertical sums
    size_t i = 0;
    for (; i + 32 <= rstride; i += 32) {
      const __m512i a = _mm512_cvtepu8_epi16(_mm256_loadu_si256(
          reinterpret_cast<const __m256i*>(p0 + i)));
      const __m512i b = _mm512_cvtepu8_epi16(_mm256_loadu_si256(
          reinterpret_cast<const __m256i*>(p1 + i)));
      _mm512_storeu_si512(vsum.data() + i, _mm512_add_epi16(a, b));
    }
    for (; i < rstride; ++i) {
      vsum[i] = static_cast<uint16_t>(p0[i]) + p1[i];
    }
    // pass 2: horizontal pair add + compact; 8 output px per iteration
    {
      const uint16_t* src = vsum.data();
      uint16_t* dst = hrow.data();
      for (int x = 0; x < cw; x += 8, src += 48, dst += 24) {
        const __m512i a = _mm512_loadu_si512(src);
        const __m512i b = _mm512_loadu_si512(src + 32);
        const __m512i l = _mm512_permutex2var_epi16(a, vidxl, b);
        const __m512i r = _mm512_permutex2var_epi16(a, vidxr, b);
        _mm512_mask_storeu_epi16(dst, 0xFFFFFF, _mm512_add_epi16(l, r));
      }
    }
    // pass 3: deinterleave + luma; 16 px per iteration
    const int par = yy & 1;
    uint16_t* brow = bs[par].data();
    uint16_t* grow = gs[par].data();
    uint16_t* rrow = rs[par].data();
    uint8_t* yrow = y_out + static_cast<size_t>(yy) * cw;
    {
      const uint16_t* src = hrow.data();
      for (int x = 0; x < cw; x += 16, src += 48) {
        const __m512i a = _mm512_loadu_si512(src);
        const __m512i b = _mm512_loadu_si512(src + 32);
        const __m512i bz = _mm512_permutex2var_epi16(a, vidxb, b);
        const __m512i gz = _mm512_permutex2var_epi16(a, vidxg, b);
        const __m512i rz = _mm512_permutex2var_epi16(a, vidxr3, b);
        const __m256i b16 = _mm512_castsi512_si256(bz);
        const __m256i g16 = _mm512_castsi512_si256(gz);
        const __m256i r16 = _mm512_castsi512_si256(rz);
        _mm256_storeu_si256(reinterpret_cast<__m256i*>(brow + x), b16);
        _mm256_storeu_si256(reinterpret_cast<__m256i*>(grow + x), g16);
        _mm256_storeu_si256(reinterpret_cast<__m256i*>(rrow + x), r16);
        __m512i acc = _mm512_mullo_epi32(cb, _mm512_cvtepu16_epi32(b16));
        acc = _mm512_add_epi32(acc,
                               _mm512_mullo_epi32(cg, _mm512_cvtepu16_epi32(g16)));
        acc = _mm512_add_epi32(acc,
                               _mm512_mullo_epi32(cr, _mm512_cvtepu16_epi32(r16)));
        acc = _mm512_srli_epi32(_mm512_add_epi32(acc, yround), 17);
        _mm_storeu_si128(reinterpret_cast<__m128i*>(yrow + x),
                         _mm512_cvtepi32_epi8(acc));
      }
    }
    // pass 4: chroma from this + previous row's 2x2 sums
    if (par) {
      chroma_rows_avx512(bs[0].data(), gs[0].data(), rs[0].data(),
                         bs[1].data(), gs[1].data(), rs[1].data(), cw,
                         u_out + static_cast<size_t>(yy / 2) * (cw / 2),
                         v_out + static_cast<size_t>(yy / 2) * (cw / 2), 4.0f);
    }
  }
}

#endif  // FRAMEPACK_AVX512

// ---------------------------------------------------------------------------
// 2x fast path: bilinear at scale 2 == exact 2x2 box average.

void pack_one_2x(const uint8_t* frame, int src_w, int ch, int cw,
                 uint8_t* y_out, uint8_t* u_out, uint8_t* v_out) {
#ifdef FRAMEPACK_AVX512
  if (cw % 32 == 0) {
    pack_one_2x_avx512(frame, src_w, ch, cw, y_out, u_out, v_out);
    return;
  }
#endif
  const bool block_order = cw % 32 == 0;           // the AVX-512 path's geometry
  const size_t rstride = static_cast<size_t>(src_w) * 3;
  std::vector<uint16_t> vsum(rstride);              // vertical pair sum, interleaved BGR
  // deinterleaved per-output-pixel 2x2 sums for this and the previous row
  std::vector<uint16_t> bs[2], gs[2], rs[2];
  for (int k = 0; k < 2; ++k) {
    bs[k].resize(cw); gs[k].resize(cw); rs[k].resize(cw);
  }

  for (int yy = 0; yy < ch; ++yy) {
    const uint8_t* p0 = frame + static_cast<size_t>(2 * yy) * rstride;
    const uint8_t* p1 = p0 + rstride;
    // pass 1: vertical u8+u8 -> u16, fully contiguous (auto-vectorizes wide)
    for (size_t i = 0; i < rstride; ++i) {
      vsum[i] = static_cast<uint16_t>(p0[i]) + p1[i];
    }
    // pass 2: horizontal pairwise add + deinterleave -> 2x2 sums per channel
    const int par = yy & 1;
    uint16_t* b = bs[par].data();
    uint16_t* g = gs[par].data();
    uint16_t* r = rs[par].data();
    for (int xx = 0; xx < cw; ++xx) {
      const uint16_t* q = vsum.data() + static_cast<size_t>(xx) * 6;
      b[xx] = q[0] + q[3];
      g[xx] = q[1] + q[4];
      r[xx] = q[2] + q[5];
    }
    luma_row_from_sums<4>(b, g, r, cw, y_out + static_cast<size_t>(yy) * cw);
    if (par) {
      uint8_t* urow = u_out + static_cast<size_t>(yy / 2) * (cw / 2);
      uint8_t* vrow = v_out + static_cast<size_t>(yy / 2) * (cw / 2);
      if (block_order) {
        chroma_row_from_sums<4, true>(bs[0].data(), gs[0].data(), rs[0].data(),
                                      bs[1].data(), gs[1].data(), rs[1].data(), cw,
                                      urow, vrow);
      } else {
        chroma_row_from_sums<4, false>(bs[0].data(), gs[0].data(), rs[0].data(),
                                       bs[1].data(), gs[1].data(), rs[1].data(), cw,
                                       urow, vrow);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Odd integer factor: bilinear sample points land exactly on source pixel
// (s*i + (s-1)/2) -> point sampling (identical to cv2 INTER_LINEAR there).

void pack_one_odd(const uint8_t* frame, int src_w, int s, int ch, int cw,
                  uint8_t* y_out, uint8_t* u_out, uint8_t* v_out) {
#ifdef FRAMEPACK_AVX512
  if (s >= 3 && cw % 32 == 0) {
    pack_one_odd_avx512(frame, src_w, s, ch, cw, y_out, u_out, v_out);
    return;
  }
#endif
  const bool block_order = s >= 3 && cw % 32 == 0;  // the AVX-512 path's geometry
  const size_t rstride = static_cast<size_t>(src_w) * 3;
  const int off = (s - 1) / 2;
  std::vector<uint16_t> bs[2], gs[2], rs[2];
  for (int k = 0; k < 2; ++k) {
    bs[k].resize(cw); gs[k].resize(cw); rs[k].resize(cw);
  }
  for (int yy = 0; yy < ch; ++yy) {
    const uint8_t* row = frame + static_cast<size_t>(s * yy + off) * rstride;
    const int par = yy & 1;
    uint16_t* b = bs[par].data();
    uint16_t* g = gs[par].data();
    uint16_t* r = rs[par].data();
    for (int xx = 0; xx < cw; ++xx) {
      const uint8_t* q = row + static_cast<size_t>(s * xx + off) * 3;
      b[xx] = q[0];
      g[xx] = q[1];
      r[xx] = q[2];
    }
    luma_row_from_sums<1>(b, g, r, cw, y_out + static_cast<size_t>(yy) * cw);
    if (par) {
      uint8_t* urow = u_out + static_cast<size_t>(yy / 2) * (cw / 2);
      uint8_t* vrow = v_out + static_cast<size_t>(yy / 2) * (cw / 2);
      if (block_order) {
        chroma_row_from_sums<1, true>(bs[0].data(), gs[0].data(), rs[0].data(),
                                      bs[1].data(), gs[1].data(), rs[1].data(), cw,
                                      urow, vrow);
      } else {
        chroma_row_from_sums<1, false>(bs[0].data(), gs[0].data(), rs[0].data(),
                                       bs[1].data(), gs[1].data(), rs[1].data(), cw,
                                       urow, vrow);
      }
    }
  }
}

void pack_one(const uint8_t* frame, int src_h, int src_w, int ch, int cw,
              uint8_t* y_out, uint8_t* u_out, uint8_t* v_out) {
  if (ch > 0 && cw > 0 && src_h % ch == 0 && src_w % cw == 0 &&
      src_h / ch == src_w / cw) {
    const int s = src_h / ch;
    if (s == 1 || (s & 1)) {
      pack_one_odd(frame, src_w, s, ch, cw, y_out, u_out, v_out);
      return;
    }
    if (s == 2) {
      pack_one_2x(frame, src_w, ch, cw, y_out, u_out, v_out);
      return;
    }
  }
  pack_one_generic(frame, src_h, src_w, ch, cw, y_out, u_out, v_out);
}

}  // namespace

extern "C" {

// frames: (n, src_h, src_w, 3) BGR uint8 contiguous.
// y: (n, ch, cw); u, v: (n, ch/2, cw/2) preallocated outputs.
void pack_i420_chunk(const uint8_t* frames, int n, int src_h, int src_w,
                     int ch, int cw, uint8_t* y, uint8_t* u, uint8_t* v,
                     int num_threads) {
  const size_t fstride = static_cast<size_t>(src_h) * src_w * 3;
  const size_t ystride = static_cast<size_t>(ch) * cw;
  const size_t cstride = ystride / 4;
  const int workers = std::max(1, std::min(num_threads, n));
  if (workers == 1) {
    for (int i = 0; i < n; ++i) {
      pack_one(frames + i * fstride, src_h, src_w, ch, cw,
               y + i * ystride, u + i * cstride, v + i * cstride);
    }
    return;
  }
  std::vector<std::thread> pool;
  pool.reserve(workers);
  for (int t = 0; t < workers; ++t) {
    pool.emplace_back([=]() {
      for (int i = t; i < n; i += workers) {
        pack_one(frames + i * fstride, src_h, src_w, ch, cw,
                 y + i * ystride, u + i * cstride, v + i * cstride);
      }
    });
  }
  for (auto& th : pool) th.join();
}

}  // extern "C"
