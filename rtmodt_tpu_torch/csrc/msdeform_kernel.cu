// Multi-scale deformable attention's sampling for Hopper (sm_90a): G2, the
// gather at the heart of RT-DETR's decoder cross-attention.
//
// Replaces no TPU kernel: the JAX package has no RT-DETR.  No library call
// does this on the card (torchvision is absent, PyTorch has no such op), and
// the plain version (ops/msdeform.py::msdeform_plain, grid_sample per level)
// writes every sampled value of every point to device memory before the
// weighted sum.
//
// Function: value (B, V, H, 32) bf16 or f32, the levels' maps flattened level
// after level (row-major, width w); loc (B, Q, H, L, P, 2) f32 in [0, 1] of
// each level's width and height; attn (B, Q, H, L, P) f32 -> out (B, Q, H *
// 32) in the value's type:
//   out[b, q, h, c] = sum_{l, p} attn * bilinear(value level l, head h, channel c,
//                                                x = loc_x * w_l - 0.5, y = loc_y * h_l - 0.5)
// with grid_sample's rule (align_corners=False, zero padding: each of the
// four corners outside the level contributes 0), summed in f32.
//
// What bounds it on this card: the latency of its gathers.  A point reads
// four 64-byte corner rows (32 bf16 channels) at data-dependent places in
// maps of 4.3 MB a frame (1.1 GB at the cells' 256 frames, past the 50 MB L2
// cache); the least time is one read of the maps, locations and weights and
// one write of the output at 3.35 TB/s (perfbench/msdeform_bound.py).  The
// arithmetic is ~10 operations a point and channel.
//
// Design: one warp per (frame, query, head), eight a 256-thread block.  The
// half-warps take alternate points; each lane owns a pair of channels, so a
// half-warp's loads of one corner are 16 consecutive 4-byte words: one
// coalesced 64-byte segment.  A point's four corner loads are issued before
// any of them is used, to keep several gathers in flight a lane; a point
// whose location lies wholly outside its level is skipped.  The halves' sums
// meet by one shuffle and the low half writes the result (bf16x2 or
// float2).  Locations and weights are read straight from global memory: all
// lanes of a half-warp read the same word, one broadcast transaction.

#include <cuda_bf16.h>
#include <cuda_runtime.h>


constexpr int kMaxLevels = 4;

// Outside the anonymous namespace: a profiler names a kernel by its demangled
// signature, and a parameter type from an anonymous namespace would put a
// second "(anonymous namespace)::" into it, past the kernel's own name.
struct MsdeformLevels {
  int h[kMaxLevels];
  int w[kMaxLevels];
  int start[kMaxLevels];
};

namespace {

constexpr int kPairs = 16;          // channel pairs a head (32 channels)
constexpr int kThreads = 256;

__device__ __forceinline__ float2 load2(const __nv_bfloat162* p) {
  return __bfloat1622float2(*p);
}
__device__ __forceinline__ float2 load2(const float2* p) { return *p; }
__device__ __forceinline__ void store2(__nv_bfloat162* p, float a, float b) {
  *p = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store2(float2* p, float a, float b) { *p = make_float2(a, b); }

template <typename V>
__global__ void __launch_bounds__(kThreads) msdeform_kernel(
    const V* __restrict__ value, const float* __restrict__ loc,
    const float* __restrict__ attn, V* __restrict__ out, long long units, int len_v,
    int len_q, int heads, int levels, int points, MsdeformLevels lv) {
  const long long unit = (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  if (unit >= units) return;                       // whole warps leave together
  const int lane = threadIdx.x & 31;
  const int half = lane >> 4;
  const int pair = lane & (kPairs - 1);
  const int h = static_cast<int>(unit % heads);
  const long long b = unit / heads / len_q;
  const int lp = levels * points;
  const float* locp = loc + unit * lp * 2;
  const float* ap = attn + unit * lp;
  const size_t row = static_cast<size_t>(heads) * kPairs;   // V units a position
  const V* vb = value + (static_cast<size_t>(b) * len_v * heads + h) * kPairs + pair;
  float acc0 = 0.f, acc1 = 0.f;
  for (int i = half; i < lp; i += 2) {
    const int l = i / points;
    const int W = lv.w[l], H = lv.h[l];
    const float x = locp[2 * i] * static_cast<float>(W) - 0.5f;
    const float y = locp[2 * i + 1] * static_cast<float>(H) - 0.5f;
    // wholly outside (NaN included): every corner is padding
    if (!(x > -1.f && x < static_cast<float>(W) && y > -1.f && y < static_cast<float>(H)))
      continue;
    const float a = ap[i];
    const float xf = floorf(x), yf = floorf(y);
    const int x0 = static_cast<int>(xf), y0 = static_cast<int>(yf);
    const float dx = x - xf, dy = y - yf;
    const bool xin0 = x0 >= 0, xin1 = x0 + 1 < W, yin0 = y0 >= 0, yin1 = y0 + 1 < H;
    const V* base = vb + static_cast<size_t>(lv.start[l]) * row;
    const float2 zero = make_float2(0.f, 0.f);
    const float2 v00 = (yin0 && xin0) ? load2(base + (static_cast<size_t>(y0) * W + x0) * row) : zero;
    const float2 v01 = (yin0 && xin1) ? load2(base + (static_cast<size_t>(y0) * W + x0 + 1) * row) : zero;
    const float2 v10 = (yin1 && xin0) ? load2(base + (static_cast<size_t>(y0 + 1) * W + x0) * row) : zero;
    const float2 v11 = (yin1 && xin1) ? load2(base + (static_cast<size_t>(y0 + 1) * W + x0 + 1) * row) : zero;
    const float w00 = (1.f - dx) * (1.f - dy), w01 = dx * (1.f - dy);
    const float w10 = (1.f - dx) * dy, w11 = dx * dy;
    acc0 += a * (v00.x * w00 + v01.x * w01 + v10.x * w10 + v11.x * w11);
    acc1 += a * (v00.y * w00 + v01.y * w01 + v10.y * w10 + v11.y * w11);
  }
  acc0 += __shfl_xor_sync(0xffffffffu, acc0, 16);
  acc1 += __shfl_xor_sync(0xffffffffu, acc1, 16);
  if (half == 0) store2(out + unit * kPairs + pair, acc0, acc1);
}

}  // namespace

// value, loc, attn, out: device pointers, contiguous, as above; bf16: 1 for
// bf16 value and output, 0 for float32; hw: the levels' (h, w) pairs on the
// host.  Launches on `stream`; returns the first nonzero CUDA error
// (cudaErrorInvalidValue for what it does not take).
extern "C" int msdeform_launch(const void* value, const void* loc, const void* attn,
                               void* out, int bf16, int batch, int len_v, int len_q,
                               int heads, int levels, int points, const int* hw,
                               void* stream) {
  if (value == nullptr || loc == nullptr || attn == nullptr || out == nullptr ||
      hw == nullptr || batch <= 0 || len_q <= 0 || heads <= 0 || points <= 0 ||
      levels <= 0 || levels > kMaxLevels)
    return static_cast<int>(cudaErrorInvalidValue);
  MsdeformLevels lv{};
  int start = 0;
  for (int l = 0; l < levels; ++l) {
    lv.h[l] = hw[2 * l];
    lv.w[l] = hw[2 * l + 1];
    lv.start[l] = start;
    start += lv.h[l] * lv.w[l];
  }
  if (start != len_v) return static_cast<int>(cudaErrorInvalidValue);
  const long long units = static_cast<long long>(batch) * len_q * heads;
  const long long blocks = (units * 32 + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) {
    msdeform_kernel<__nv_bfloat162><<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
        static_cast<const __nv_bfloat162*>(value), static_cast<const float*>(loc),
        static_cast<const float*>(attn), static_cast<__nv_bfloat162*>(out), units, len_v,
        len_q, heads, levels, points, lv);
  } else {
    msdeform_kernel<float2><<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
        static_cast<const float2*>(value), static_cast<const float*>(loc),
        static_cast<const float*>(attn), static_cast<float2*>(out), units, len_v, len_q,
        heads, levels, points, lv);
  }
  return static_cast<int>(cudaGetLastError());
}
