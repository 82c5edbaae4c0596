// Exact greedy NMS suppression for a batch of frames, for Hopper (sm_90a).
//
// Replaces the TPU kernel rtmodt_tpu/ops/pallas/nms_kernel.py:24 _nms_kernel
// (reached through pallas_greedy_suppress, whose pl.pallas_call is at :62).
// Same function: candidates are sorted by descending score and already
// class-offset; a kept, valid row i drops every later row j with
// IoU(i, j) > iou_thresh; rows with score <= 0 never suppress and are never
// kept.
//
// What bounds it on this card: latency.  The roofline is bytes (a 4 B score
// read and a 1 B keep flag written per candidate, and a 16 B box read per
// valid candidate only; 16 frames x 300 candidates with ~77 valid a frame
// is ~44 KB, ~0.000013 ms at 3.35 TB/s), and the v(v-1)/2 IoU tests over
// the v valid candidates of a frame are a few MFLOP at most.  What the kernel waits on
// is a chain: the staging loads, block-wide syncs, and greedy's scan, where
// each row's fate depends on every earlier kept row.
//
// Two paths, chosen by K.  K <= 1024 (the main path's 300, validation's and
// offline detection's 1000) runs one kernel that keeps everything in shared
// memory; K > 1024 (detection.nms_candidates up to every anchor: 8400 at 640,
// 33600 at 1280) runs the same three steps as three kernels over a scratch
// buffer in device memory that the caller allocates.
//
// Design for K <= 1024: one CTA of 1024 threads per frame; the grid is the B
// frames.
//   1. Stage and compact.  Each thread reads one candidate's score and box;
//      a block-wide ballot prefix sum gives the valid rows (score > 0) their
//      ascending compact index c, and stores vi[c] = frame row, the box and
//      its area in shared memory.  Invalid rows get keep = 0 right away.
//      The v valid rows are all the later steps look at: the main path has
//      ~80 of 300.
//   2. Conflict words by ballot, valid pairs only.  Warp w takes compact
//      rows a = w, w + 32, ...; for each 32-column group g from a / 32 on,
//      lane l tests column c = 32 g + l (c > a, c < v) and the warp's
//      __ballot_sync is the u32 conflict word conf[a][g].  No atomics; words
//      left of the diagonal group are never written and never read.
//      Shared memory: v x ceil(v/32) u32 (12 KB at v = 300, 128 KB at
//      K = 1024).  32 warps hide each other's shared-load and divide
//      latency; a warp's items are a dependent chain.
//   3. Blocked scan in warp 0.  Lane g owns removed word g in a register.
//      For block g (compact rows 32 g .. 32 g + 31), lane g loads the
//      block's 32 diagonal words first, then walks them: a row whose removed
//      bit is clear is kept and ORs its word in; the chain is a test and an
//      OR per row.  __shfl_sync broadcasts the block's keep bits, each lane
//      w > g ORs in conf[a][w] of the kept rows a (independent loads), and
//      the warp writes the block's keep bytes.  The scan runs v steps, not K.
//
// Exactness: the IoU is evaluated with the operations, in the order, of the
// plain version (rtmodt_tpu_torch/ops/nms_kernel.py::greedy_suppress_reference
// and the JAX _greedy_suppress): min/max, (x2-x1)*(y2-y1), area_i + area_j -
// inter, + 1e-7, an IEEE divide, then a strict '>' against the f32
// threshold.  Each step uses an explicitly rounded intrinsic so that no FMA
// contraction can change a borderline decision; the file is also built with
// -fmad=false.  Compaction keeps the valid rows in ascending order, and an
// invalid row neither suppresses nor is kept, so dropping it changes no
// decision.
//
// Design for K > 1024 (the wide path).  The one-CTA design cannot grow: its
// conflict words take v x ceil(v/32) u32 of shared memory (512 KB at
// v = 2048, 8.8 MB at 8400, against 227 KB a block), and its scan gives each
// of one warp's 32 lanes one removed word (1024 rows).  The same steps, with
// the data placed elsewhere:
//   1. nms_wide_compact, one 1024-thread CTA per frame: the ballot prefix sum
//      of step 1, looped over 1024-candidate tiles with a running offset;
//      writes the compact boxes, areas, frame-row indices and v to scratch.
//   2. nms_wide_conflicts, one 256-thread block per (frame, 32 compact rows):
//      each warp ballots 32 columns into one u32 word, as in step 2, into
//      scratch (row stride ceil(K/32) words); only words on or right of the
//      diagonal group are written, and blocks past v return at once.  The
//      K^2/8 bytes of a frame stay in the 50 MB L2 up to K ~ 20,000.
//   3. nms_wide_scan, one 1024-thread CTA per frame: the removed words
//      (ceil(v/32), 1050 at K = 33600) sit in shared memory, word w owned by
//      thread w mod 1024.  For each 32-row block g, the owner of word g walks
//      the block's 32 diagonal words serially (step 3's lane g) and
//      broadcasts the kept bits through shared memory; then every thread ORs
//      the kept rows' words into its own words right of g.  Two
//      __syncthreads a block, v / 32 blocks.
// The IoU test is the same iou_above, so the keep mask is bit-equal to the
// plain version for every K.  Offsets into the scratch are size_t: B x K x
// ceil(K/32) passes 2^28 at B = 16, K = 33600.

#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxK = 64 * 16;          // 1024 candidates: 152 KB of shared memory
constexpr unsigned kFull = 0xffffffffu;
static_assert(kMaxK <= kThreads, "one candidate a thread in the compaction");
static_assert((kMaxK + 31) / 32 <= 32, "one scan lane per removed word");

__device__ __forceinline__ float box_area(float4 b) {
  return __fmul_rn(__fsub_rn(b.z, b.x), __fsub_rn(b.w, b.y));
}

// IoU(a, b) > t with the plain version's rounding and order (a is the row).
// Most pairs do not overlap, and the IEEE divide sends a zero numerator down
// its slow path; IEEE gives 0 / d = +-0 for d != 0 (d = +-inf included) and
// NaN for d = 0 or NaN, so that case is decided without the divide.
__device__ __forceinline__ bool iou_above(float4 a, float area_a, float4 b, float area_b,
                                          float t) {
  const float ix = fmaxf(__fsub_rn(fminf(a.z, b.z), fmaxf(a.x, b.x)), 0.0f);
  const float iy = fmaxf(__fsub_rn(fminf(a.w, b.w), fmaxf(a.y, b.y)), 0.0f);
  const float inter = __fmul_rn(ix, iy);
  const float den = __fadd_rn(__fsub_rn(__fadd_rn(area_a, area_b), inter), 1e-7f);
  if (inter == 0.0f) return t < 0.0f && den != 0.0f && !isnan(den);
  return __fdiv_rn(inter, den) > t;
}

__global__ void __launch_bounds__(kThreads)
nms_greedy_kernel(const float4* __restrict__ boxes, const float* __restrict__ scores,
                  bool* __restrict__ keep, int k, float iou_thresh) {
  extern __shared__ float4 smem[];
  float4* sbox = smem;                                          // k, compact order
  float* sarea = reinterpret_cast<float*>(sbox + k);            // k
  int* svi = reinterpret_cast<int*>(sarea + k);                 // k: compact -> frame row
  uint32_t* conf = reinterpret_cast<uint32_t*>(svi + k);        // v * words
  __shared__ int warp_valid[kWarps];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float4* fb = boxes + static_cast<size_t>(blockIdx.x) * k;
  const float* fs = scores + static_cast<size_t>(blockIdx.x) * k;
  bool* fk = keep + static_cast<size_t>(blockIdx.x) * k;

  // 1. stage and compact: thread i takes frame row i
  const int i = threadIdx.x;
  float s = 0.0f;
  float4 b = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (i < k) {            // both loads in flight before the ballot
    s = fs[i];
    b = fb[i];
  }
  const bool valid = s > 0.0f;
  const unsigned ballot = __ballot_sync(kFull, valid);
  if (lane == 0) warp_valid[warp] = __popc(ballot);
  __syncthreads();
  int pos = __popc(ballot & ((1u << lane) - 1u));
  int v = 0;
  for (int w = 0; w < kWarps; ++w) {
    const int n = warp_valid[w];
    pos += w < warp ? n : 0;
    v += n;
  }
  if (valid) {
    sbox[pos] = b;
    sarea[pos] = box_area(b);
    svi[pos] = i;
  } else if (i < k) {
    fk[i] = false;
  }
  if (v == 0) return;     // uniform: every thread summed the same counts
  __syncthreads();

  // 2. conflict words: conf[a * words + g], bit l = column 32 g + l
  const int words = (v + 31) >> 5;
  for (int a = warp; a < v; a += kWarps) {
    const float4 ba = sbox[a];
    const float area_a = sarea[a];
    for (int g = a >> 5; g < words; ++g) {
      const int c = (g << 5) + lane;
      const bool hit = c > a && c < v && iou_above(ba, area_a, sbox[c], sarea[c], iou_thresh);
      const unsigned word = __ballot_sync(kFull, hit);
      if (lane == 0) conf[a * words + g] = word;
    }
  }
  __syncthreads();

  // 3. blocked greedy scan in warp 0; lane w owns removed word w
  if (warp != 0) return;
  uint32_t removed = 0u;
  for (int g = 0; g < words; ++g) {
    const int row0 = g << 5;
    const int n = min(32, v - row0);
    uint32_t kept = 0u;
    if (lane == g) {
      uint32_t diag[32];
#pragma unroll
      for (int r = 0; r < 32; ++r) diag[r] = r < n ? conf[(row0 + r) * words + g] : 0u;
#pragma unroll
      for (int r = 0; r < 32; ++r) {
        if (!((removed >> r) & 1u)) removed |= diag[r];
      }
      kept = ~removed & (n == 32 ? kFull : (1u << n) - 1u);
    }
    kept = __shfl_sync(kFull, kept, g);
    if (lane > g && lane < words) {
#pragma unroll
      for (int r = 0; r < 32; ++r) {
        if ((kept >> r) & 1u) removed |= conf[(row0 + r) * words + lane];
      }
    }
    if (lane < n) fk[svi[row0 + lane]] = (kept >> lane) & 1u;
  }
}

size_t shared_bytes(int k) {
  const size_t words = (k + 31) / 32;
  return static_cast<size_t>(k) * (sizeof(float4) + sizeof(float) + sizeof(int)) +
         static_cast<size_t>(k) * words * sizeof(uint32_t);
}

// ---- the wide path (K > kMaxK) ----------------------------------------------

constexpr int kRowBlock = 32;          // compact rows of one conflict block
constexpr int kConfThreads = 256;      // 8 warps, 4 rows each
constexpr int kConfWarps = kConfThreads / 32;

__host__ __device__ inline size_t row_words(int k) { return (static_cast<size_t>(k) + 31) / 32; }

size_t round16(size_t n) { return (n + 15) / 16 * 16; }

// The scratch buffer of B frames: compact boxes, areas and frame rows
// (B x K each), the valid counts (B) and the conflict words (B x K x
// ceil(K/32) u32).  Frame f's rows start at f x K.
struct Wide {
  float4* box;
  float* area;
  int* vi;
  int* count;
  uint32_t* conf;
};

size_t wide_scratch_bytes(int batch, int k) {
  const size_t n = static_cast<size_t>(batch) * k;
  return n * (sizeof(float4) + sizeof(float) + sizeof(int)) +
         round16(static_cast<size_t>(batch) * sizeof(int)) + n * row_words(k) * sizeof(uint32_t);
}

Wide wide_layout(void* scratch, int batch, int k) {
  char* p = static_cast<char*>(scratch);
  const size_t n = static_cast<size_t>(batch) * k;
  Wide ws;
  ws.box = reinterpret_cast<float4*>(p);
  p += n * sizeof(float4);
  ws.area = reinterpret_cast<float*>(p);
  p += n * sizeof(float);
  ws.vi = reinterpret_cast<int*>(p);
  p += n * sizeof(int);
  ws.count = reinterpret_cast<int*>(p);
  p += round16(static_cast<size_t>(batch) * sizeof(int));
  ws.conf = reinterpret_cast<uint32_t*>(p);
  return ws;
}

// 1. compaction over 1024-candidate tiles, in ascending frame-row order
__global__ void __launch_bounds__(kThreads)
nms_wide_compact(const float4* __restrict__ boxes, const float* __restrict__ scores,
                 bool* __restrict__ keep, Wide ws, int k) {
  __shared__ int warp_valid[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const size_t f0 = static_cast<size_t>(blockIdx.x) * k;
  int offset = 0;         // valid rows of the earlier tiles
  for (int t0 = 0; t0 < k; t0 += kThreads) {
    const int i = t0 + threadIdx.x;
    float s = 0.0f;
    float4 b = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (i < k) {
      s = scores[f0 + i];
      b = boxes[f0 + i];
    }
    const bool valid = s > 0.0f;
    const unsigned ballot = __ballot_sync(kFull, valid);
    if (lane == 0) warp_valid[warp] = __popc(ballot);
    __syncthreads();
    int pos = offset + __popc(ballot & ((1u << lane) - 1u));
    int n = 0;
    for (int w = 0; w < kWarps; ++w) {
      const int c = warp_valid[w];
      pos += w < warp ? c : 0;
      n += c;
    }
    if (valid) {
      ws.box[f0 + pos] = b;
      ws.area[f0 + pos] = box_area(b);
      ws.vi[f0 + pos] = i;
    } else if (i < k) {
      keep[f0 + i] = false;
    }
    offset += n;          // uniform: every thread summed the same counts
    __syncthreads();      // warp_valid is rewritten by the next tile
  }
  if (threadIdx.x == 0) ws.count[blockIdx.x] = offset;
}

// 2. conflict words of 32 compact rows of one frame: word (a, g), bit l =
// column 32 g + l, for g from a / 32 on; the block is blockIdx.x = frame x
// row_blocks + row block
__global__ void __launch_bounds__(kConfThreads)
nms_wide_conflicts(Wide ws, int k, int row_blocks, float iou_thresh) {
  const int f = blockIdx.x / row_blocks;
  const int row0 = (blockIdx.x % row_blocks) * kRowBlock;
  const int v = ws.count[f];
  if (row0 >= v) return;  // uniform over the block
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const size_t words = row_words(k);
  const int vwords = (v + 31) >> 5;
  const size_t f0 = static_cast<size_t>(f) * k;
  const float4* box = ws.box + f0;
  const float* area = ws.area + f0;
  uint32_t* conf = ws.conf + f0 * words;
  const int row_end = min(row0 + kRowBlock, v);
  for (int a = row0 + warp; a < row_end; a += kConfWarps) {
    const float4 ba = box[a];
    const float area_a = area[a];
    for (int g = a >> 5; g < vwords; ++g) {
      const int c = (g << 5) + lane;
      const bool hit = c > a && c < v && iou_above(ba, area_a, box[c], area[c], iou_thresh);
      const unsigned word = __ballot_sync(kFull, hit);
      if (lane == 0) conf[static_cast<size_t>(a) * words + g] = word;
    }
  }
}

// 3. the blocked greedy scan of one frame; removed word w lives in shared
// memory and only thread w mod 1024 touches it
__global__ void __launch_bounds__(kThreads)
nms_wide_scan(Wide ws, bool* __restrict__ keep, int k) {
  extern __shared__ uint32_t removed[];   // ceil(K/32); the first ceil(v/32) used
  __shared__ uint32_t kept_bits;
  const int v = ws.count[blockIdx.x];
  if (v == 0) return;     // uniform
  const size_t words = row_words(k);
  const int vwords = (v + 31) >> 5;
  const size_t f0 = static_cast<size_t>(blockIdx.x) * k;
  const uint32_t* conf = ws.conf + f0 * words;
  const int* vi = ws.vi + f0;
  bool* fk = keep + f0;
  for (int w = threadIdx.x; w < vwords; w += kThreads) removed[w] = 0u;
  for (int g = 0; g < vwords; ++g) {
    const int row0 = g << 5;
    const int n = min(32, v - row0);
    if (static_cast<int>(threadIdx.x) == (g & (kThreads - 1))) {    // the owner of word g
      uint32_t diag[32];
#pragma unroll
      for (int r = 0; r < 32; ++r)
        diag[r] = r < n ? conf[static_cast<size_t>(row0 + r) * words + g] : 0u;
      uint32_t rem = removed[g];
#pragma unroll
      for (int r = 0; r < 32; ++r) {
        if (!((rem >> r) & 1u)) rem |= diag[r];
      }
      removed[g] = rem;
      kept_bits = ~rem & (n == 32 ? kFull : (1u << n) - 1u);
    }
    __syncthreads();
    const uint32_t kept = kept_bits;
    for (int w = threadIdx.x; w < vwords; w += kThreads) {
      if (w <= g) continue;
      uint32_t rem = removed[w];
#pragma unroll
      for (int r = 0; r < 32; ++r) {
        if ((kept >> r) & 1u) rem |= conf[static_cast<size_t>(row0 + r) * words + w];
      }
      removed[w] = rem;
    }
    if (static_cast<int>(threadIdx.x) < n) fk[vi[row0 + threadIdx.x]] = (kept >> threadIdx.x) & 1u;
    __syncthreads();      // kept_bits is rewritten by the next block
  }
}

template <typename Kernel>
cudaError_t raise_smem_limit(Kernel* kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

}  // namespace

// Bytes of device scratch the launch of (batch, k) needs: 0 for K <= 1024
// (the one-CTA kernel keeps everything in shared memory).
extern "C" size_t nms_scratch_bytes(int batch, int k) {
  if (batch <= 0 || k <= kMaxK) return 0;
  return wide_scratch_bytes(batch, k);
}

// boxes (B, K, 4) f32 (16-byte aligned), scores (B, K) f32, keep (B, K) bool:
// device pointers, contiguous; scratch: nms_scratch_bytes(B, K) bytes of
// device memory, 16-byte aligned (null where that is 0).  Launches on
// `stream`; returns the first nonzero cudaGetLastError() after a launch (or
// cudaErrorInvalidValue for shapes or pointers the kernels do not take).
extern "C" int nms_greedy_launch(const void* boxes, const void* scores, void* keep,
                                 void* scratch, int batch, int k, float iou_thresh,
                                 void* stream) {
  if (batch <= 0 || k <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(boxes) % alignof(float4) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (k <= kMaxK) {
    const size_t smem = shared_bytes(k);
    // Past the default 48 KB of dynamic shared memory (K above 534) the limit
    // must be raised first, with a runtime call that the main path's K = 300
    // (19 KB) does not make.
    cudaError_t err = raise_smem_limit(nms_greedy_kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    nms_greedy_kernel<<<batch, kThreads, smem, st>>>(
        static_cast<const float4*>(boxes), static_cast<const float*>(scores),
        static_cast<bool*>(keep), k, iou_thresh);
    return static_cast<int>(cudaGetLastError());
  }
  if (scratch == nullptr || reinterpret_cast<uintptr_t>(scratch) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int row_blocks = (k + kRowBlock - 1) / kRowBlock;
  if (static_cast<size_t>(batch) * row_blocks > 0x7fffffffu)
    return static_cast<int>(cudaErrorInvalidValue);
  const Wide ws = wide_layout(scratch, batch, k);
  nms_wide_compact<<<batch, kThreads, 0, st>>>(
      static_cast<const float4*>(boxes), static_cast<const float*>(scores),
      static_cast<bool*>(keep), ws, k);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  nms_wide_conflicts<<<batch * row_blocks, kConfThreads, 0, st>>>(ws, k, row_blocks,
                                                                  iou_thresh);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = row_words(k) * sizeof(uint32_t);
  err = raise_smem_limit(nms_wide_scan, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  nms_wide_scan<<<batch, kThreads, smem, st>>>(ws, static_cast<bool*>(keep), k);
  return static_cast<int>(cudaGetLastError());
}
