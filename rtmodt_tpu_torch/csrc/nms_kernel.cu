// Exact greedy NMS suppression for a batch of frames, for Hopper (sm_90a).
//
// Replaces the TPU kernel rtmodt_tpu/ops/pallas/nms_kernel.py::_nms_kernel
// (reached through pallas_greedy_suppress's pl.pallas_call).  Same function:
// candidates are sorted by descending score and already class-offset; a kept,
// valid row i drops every later row j with IoU(i, j) > iou_thresh; rows with
// score <= 0 never suppress and are never kept.
//
// What bounds it on this card: per frame ~K^2/2 IoU tests (K = 300 is about
// 45k tests, well under a microsecond of the SM's f32 rate) and a K-step
// serial scan whose every step depends on the previous one.  The bytes moved
// (20 B of input and 1 B of output per candidate) are negligible, so the
// kernel is bound by latency: launch, one pass over shared memory, and the
// serial scan.
//
// Design:
//   * one CTA per frame; the grid is the B frames of a chunk;
//   * boxes, areas and scores are staged in shared memory once;
//   * all threads build the thresholded conflict matrix AS BITS in shared
//     memory: row i holds bit j only for j > i, in W = ceil(K/64) u64 words
//     (K = 300: 300 x 5 words = 12 KB; an f32 K x K IoU matrix would take
//     360 KB, more than a CTA may hold);
//   * one warp runs the serial scan: lane w keeps removed-word w in a
//     register, the owner of row i's word broadcasts whether i is removed,
//     and a kept row ORs its W conflict words into the lanes' registers.
//
// Exactness: the IoU is evaluated with the operations, in the order, of the
// plain version (rtmodt_tpu_torch/ops/nms_kernel.py::greedy_suppress_reference
// and the JAX _greedy_suppress): min/max, (x2-x1)*(y2-y1), area_i + area_j -
// inter, + 1e-7, an IEEE divide, then a strict '>'.  Each step uses an
// explicitly rounded intrinsic so that no FMA contraction can change a
// borderline decision; the file is also built with -fmad=false.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxWords = 32;          // one warp lane per removed-mask word
constexpr int kMaxK = 64 * 16;         // 1024 candidates: 150 KB of shared memory

__device__ __forceinline__ float box_area(float x1, float y1, float x2, float y2) {
  return __fmul_rn(__fsub_rn(x2, x1), __fsub_rn(y2, y1));
}

__global__ void nms_greedy_kernel(const float* __restrict__ boxes,
                                  const float* __restrict__ scores,
                                  bool* __restrict__ keep, int k, int words,
                                  float iou_thresh) {
  extern __shared__ unsigned long long smem[];
  unsigned long long* conflict = smem;                          // k * words
  float* sx1 = reinterpret_cast<float*>(conflict + static_cast<size_t>(k) * words);
  float* sy1 = sx1 + k;
  float* sx2 = sy1 + k;
  float* sy2 = sx2 + k;
  float* sarea = sy2 + k;
  float* sscore = sarea + k;

  const int frame = blockIdx.x;
  const float* fb = boxes + static_cast<size_t>(frame) * k * 4;
  const float* fs = scores + static_cast<size_t>(frame) * k;
  bool* fk = keep + static_cast<size_t>(frame) * k;

  for (int i = threadIdx.x; i < k; i += blockDim.x) {
    const float x1 = fb[4 * i + 0], y1 = fb[4 * i + 1];
    const float x2 = fb[4 * i + 2], y2 = fb[4 * i + 3];
    sx1[i] = x1; sy1[i] = y1; sx2[i] = x2; sy2[i] = y2;
    sarea[i] = box_area(x1, y1, x2, y2);
    sscore[i] = fs[i];
  }
  __syncthreads();

  // conflict bits: one (row, word) pair per thread iteration
  for (int idx = threadIdx.x; idx < k * words; idx += blockDim.x) {
    const int i = idx / words;
    const int w = idx - i * words;
    unsigned long long bits = 0ull;
    const int j0 = max(w * 64, i + 1);
    const int j1 = min(w * 64 + 64, k);
    if (sscore[i] > 0.0f) {
      const float ax1 = sx1[i], ay1 = sy1[i], ax2 = sx2[i], ay2 = sy2[i];
      const float aa = sarea[i];
      for (int j = j0; j < j1; ++j) {
        const float ix = fmaxf(__fsub_rn(fminf(ax2, sx2[j]), fmaxf(ax1, sx1[j])), 0.0f);
        const float iy = fmaxf(__fsub_rn(fminf(ay2, sy2[j]), fmaxf(ay1, sy1[j])), 0.0f);
        const float inter = __fmul_rn(ix, iy);
        const float uni = __fsub_rn(__fadd_rn(aa, sarea[j]), inter);
        const float iou = __fdiv_rn(inter, __fadd_rn(uni, 1e-7f));
        if (iou > iou_thresh) bits |= 1ull << (j - w * 64);
      }
    }
    conflict[idx] = bits;
  }
  __syncthreads();

  // serial greedy scan in warp 0; lane w owns removed-mask word w
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    unsigned long long removed = 0ull;
    for (int i = 0; i < k; ++i) {
      const int owner = i >> 6;
      const unsigned long long owner_word = __shfl_sync(0xffffffffu, removed, owner);
      const bool alive = !((owner_word >> (i & 63)) & 1ull) && sscore[i] > 0.0f;
      if (lane == 0) fk[i] = alive;
      if (alive && lane < words) removed |= conflict[static_cast<size_t>(i) * words + lane];
    }
  }
}

size_t shared_bytes(int k, int words) {
  return static_cast<size_t>(k) * words * sizeof(unsigned long long) +
         static_cast<size_t>(k) * 6 * sizeof(float);
}

}  // namespace

// boxes (B, K, 4) f32, scores (B, K) f32, keep (B, K) bool: device pointers,
// contiguous.  Launches on `stream`; returns cudaGetLastError() (or
// cudaErrorInvalidValue for shapes the kernel does not take).
extern "C" int nms_greedy_launch(const void* boxes, const void* scores, void* keep,
                                 int batch, int k, float iou_thresh, void* stream) {
  if (batch <= 0 || k <= 0 || k > kMaxK) return static_cast<int>(cudaErrorInvalidValue);
  const int words = (k + 63) / 64;
  if (words > kMaxWords) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = shared_bytes(k, words);
  // Past the default 48 KB of dynamic shared memory (K above ~480) the limit
  // must be raised first.  It is a driver call, so the main path's K = 300
  // (19 KB) does not make it.
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        nms_greedy_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  nms_greedy_kernel<<<batch, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(boxes), static_cast<const float*>(scores),
      static_cast<bool*>(keep), k, words, iou_thresh);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int nms_max_candidates() { return kMaxK; }
