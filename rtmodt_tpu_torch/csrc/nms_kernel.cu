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
// the conflict words in a scratch buffer in device memory:
//   1. nms_wide_compact, one 1024-thread CTA per frame: the ballot prefix sum
//      of step 1, looped over 1024-candidate tiles with a running offset;
//      writes the compact boxes, areas, frame-row indices and v to scratch.
//   2. nms_wide_conflicts, 256-thread blocks over the (frame, 32 compact
//      rows, 512-column tile) pairs of the upper triangle, so a pair is at
//      most 32 x 512 tests whatever its row.  The grid is fixed at launch,
//      before v is known: min(pairs at K, ceil(4096 / B)) blocks a frame,
//      each looping over every grid-th pair, in row-tile order, of the
//      column tiles that hold the frame's v rows (16 x T(T+1)/2 pairs for T
//      = ceil(v / 512) tiles), so a frame with few valid rows costs a few
//      pairs, not a grid that grows with K^2.  For each pair the block
//      stages its columns' boxes and areas in shared memory with cp.async
//      (each column read once per pair); warp w holds rows w, w + 8, w + 16,
//      w + 24 in registers and ballots each column group against all four,
//      and lane l keeps word 16 j + (l mod 16) of two of the rows, so one
//      coalesced store writes two rows' 16 words of the tile.  Only words on
//      or right of the diagonal group are written.  Rows are padded to a
//      multiple of 4 words (16 bytes).
//   3. nms_wide_scan, one 512-thread CTA per frame, in tiles of 512 compact
//      rows (16 removed words).  The tile's diagonal block of words (512 x
//      16 u32, 32 KB) is copied into a shared double buffer with cp.async
//      two tiles ahead of the scan.  Warp 0 scans the tile 32 rows at a time
//      on shared memory and registers only, with no block-wide barrier
//      inside the tile: lane l owns removed word l of the tile; for block b
//      lane r holds row r's diagonal word, the candidates are the rows not
//      yet removed (lane b's word, by __shfl_sync), and the block's keep
//      mask is the fixpoint of kept = candidates & ~OR{words of kept rows},
//      iterated from kept = candidates, one __reduce_or_sync a round: a row
//      only suppresses later rows, so round m settles row m - 1, the
//      fixpoint is greedy's mask and comes after n + 1 rounds at most (a
//      chain of boxes, each suppressing the next, takes them all; sparse
//      conflicts settle in a few); the lanes right of b then OR in the
//      kept rows' words of the staged tile.
//      Warp 0 lists the tile's kept rows in shared memory; after one barrier
//      all threads OR the kept rows' words into the next tile's removed
//      words (16-byte loads, 16 rows in flight a thread, shared atomics),
//      and the next tile starts after a second barrier: one barrier pair per
//      512 rows.  While warp 0 scans that tile, the other 15 warps write the
//      last tile's keep bytes and OR its kept rows' words into the words
//      past the tile being scanned, so only the next tile's share of the
//      update waits between two scans.
//   Scratch: B x K x (16 + 4 + 4) bytes of compact rows and B x K x
//   round4(ceil(K/32)) u32 of words: 9.07 MB a frame at K = 8400, 142.2 MB at
//   33600.  The scan's shared memory is 64 KB of tiles plus 4 x round4(ceil(
//   K/32)) bytes of removed words (68 KB at K = 33600).
// The IoU test is the same iou_above, so the keep mask is bit-equal to the
// plain version for every K.  Offsets into the scratch are size_t: B x K x
// ceil(K/32) passes 2^28 at B = 16, K = 33600.

#include <algorithm>
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

constexpr int kRowBlock = 32;                     // compact rows of one conflict block
constexpr int kConfThreads = 256;                 // 8 warps, 4 rows each
constexpr int kConfWarps = kConfThreads / 32;
constexpr int kRowsPerWarp = kRowBlock / kConfWarps;
constexpr int kColTileWords = 16;                 // words of one conflict block: a half warp's
constexpr int kColTile = kColTileWords * 32;      // its 512 columns
constexpr int kScanThreads = 512;
constexpr int kTile = 512;                        // compact rows of one scan tile
constexpr int kTileWords = kTile / 32;            // its removed words, one a scan lane
constexpr int kTileU32 = kTile * kTileWords;      // its diagonal block of words (32 KB)
constexpr int kOrRows = 16;                       // kept rows in flight a thread (16 B each)
constexpr size_t kConfGrid = 4096;                // conflict blocks of a launch at most
static_assert(kTileWords % 4 == 0 && kTileWords <= 32, "16-byte tile rows, a lane a word");
static_assert(kColTileWords == 16 && kRowsPerWarp == 4, "a store covers two rows' words");

__host__ __device__ inline size_t row_words(int k) { return (static_cast<size_t>(k) + 31) / 32; }

// u32 a conflict row: ceil(K/32) rounded up to 16 bytes
__host__ __device__ inline size_t conf_stride(int k) { return (row_words(k) + 3) / 4 * 4; }

size_t round16(size_t n) { return (n + 15) / 16 * 16; }

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most `pending` of this thread's groups are in flight
template <int pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(pending) : "memory");
}

// The scratch buffer of B frames: compact boxes, areas and frame rows
// (B x K each), the valid counts (B) and the conflict words (B x K x
// conf_stride(K) u32), each section 16-byte aligned.  Frame f's rows start
// at f x K.
struct Wide {
  float4* box;
  float* area;
  int* vi;
  int* count;
  uint32_t* conf;
};

size_t wide_scratch_bytes(int batch, int k) {
  const size_t n = static_cast<size_t>(batch) * k;
  return round16(n * sizeof(float4)) + round16(n * sizeof(float)) + round16(n * sizeof(int)) +
         round16(static_cast<size_t>(batch) * sizeof(int)) + n * conf_stride(k) * sizeof(uint32_t);
}

Wide wide_layout(void* scratch, int batch, int k) {
  char* p = static_cast<char*>(scratch);
  const size_t n = static_cast<size_t>(batch) * k;
  Wide ws;
  ws.box = reinterpret_cast<float4*>(p);
  p += round16(n * sizeof(float4));
  ws.area = reinterpret_cast<float*>(p);
  p += round16(n * sizeof(float));
  ws.vi = reinterpret_cast<int*>(p);
  p += round16(n * sizeof(int));
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

// (row block, column tile) pairs of one frame's upper triangle: row tile I
// (the kColTileWords row blocks whose diagonal words lie in column tile I)
// meets the column tiles I .. col_tiles - 1
__host__ __device__ inline size_t conflict_pairs(int col_tiles) {
  return static_cast<size_t>(kColTileWords) * col_tiles * (col_tiles + 1) / 2;
}

// blocks a frame of the conflict grid: the frame's pairs at K, but about
// kConfGrid blocks in all (one a frame at least), so a launch whose frames
// hold few valid rows is not a grid of blocks that find nothing to do
int conflict_grid(int batch, int k) {
  const int col_tiles = static_cast<int>((row_words(k) + kColTileWords - 1) / kColTileWords);
  const size_t most = (kConfGrid + batch - 1) / batch;
  return static_cast<int>(std::min(conflict_pairs(col_tiles), most));
}

// 2. conflict words of one frame, 32 compact rows against one tile of 512
// columns at a time: word (a, g), bit l = column 32 g + l, for g from a / 32
// on.  Block x of frame f (blockIdx.x = f x grid + x) takes pairs x, x +
// grid, ... of the pairs of the column tiles that hold the frame's v rows,
// in row-tile order, so the loop ends with the frame's valid rows
__global__ void __launch_bounds__(kConfThreads)
nms_wide_conflicts(Wide ws, int k, int grid, float iou_thresh) {
  __shared__ float4 sbox[kColTile];
  __shared__ float sarea[kColTile];
  const int f = blockIdx.x / grid;
  const int v = ws.count[f];
  const int vwords = (v + 31) >> 5;
  const int tiles = (vwords + kColTileWords - 1) / kColTileWords;
  const int pairs = static_cast<int>(conflict_pairs(tiles));
  const size_t f0 = static_cast<size_t>(f) * k;
  const float4* box = ws.box + f0;
  const float* area = ws.area + f0;
  uint32_t* conf = ws.conf + f0 * conf_stride(k);
  const size_t stride = conf_stride(k);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int half = lane >> 4;
  int row_tile = 0, first = 0;  // the row tile of pair p, and its first pair
  for (int p = blockIdx.x % grid; p < pairs; p += grid) {
    while (p - first >= kColTileWords * (tiles - row_tile)) {
      first += kColTileWords * (tiles - row_tile);
      ++row_tile;
    }
    const int j = row_tile + (p - first) / kColTileWords;            // column tile
    const int i = row_tile * kColTileWords + (p - first) % kColTileWords;  // row block
    const int row0 = i * kRowBlock;
    const int g0 = j * kColTileWords;                  // the tile's first word
    const int g_begin = max(i, g0);
    const int g_end = min(g0 + kColTileWords, vwords);
    if (row0 >= v || g_begin >= g_end) continue;       // uniform over the block

    // stage the columns of groups g_begin .. g_end - 1 that are valid
    const int c_tile = g0 * 32;
    const int lo = (g_begin - g0) * 32;
    const int hi = min(kColTile, v - c_tile);
    for (int c = lo + threadIdx.x; c < hi; c += kConfThreads) {
      cp_async16(&sbox[c], &box[c_tile + c]);
      cp_async4(&sarea[c], &area[c_tile + c]);
    }
    cp_async_commit();

    // the warp's rows in registers, while the columns land
    float4 rb[kRowsPerWarp];
    float ra[kRowsPerWarp];
    int ar[kRowsPerWarp];
#pragma unroll
    for (int q = 0; q < kRowsPerWarp; ++q) {
      ar[q] = row0 + warp + q * kConfWarps;
      rb[q] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      ra[q] = 0.0f;
      if (ar[q] < v) {
        rb[q] = box[ar[q]];
        ra[q] = area[ar[q]];
      }
    }
    cp_async_wait<0>();
    __syncthreads();

    // lane l keeps word g0 + (l mod 16) of rows 0 + l / 16 and 2 + l / 16 of
    // the warp's four, so one store writes two rows' words of the tile
    uint32_t mine0 = 0u, mine1 = 0u;
    for (int g = g_begin; g < g_end; ++g) {
      const int c = (g << 5) + lane;
      const bool col = c < v;
      const int cs = col ? c - c_tile : 0;   // a lane past v reads slot 0 and tests nothing
      const float4 cb = sbox[cs];
      const float ca = sarea[cs];
      // c > a with c < v implies a < v: rows past v hit nothing
      const uint32_t w0 = __ballot_sync(kFull, col && c > ar[0] &&
                                                   iou_above(rb[0], ra[0], cb, ca, iou_thresh));
      const uint32_t w1 = __ballot_sync(kFull, col && c > ar[1] &&
                                                   iou_above(rb[1], ra[1], cb, ca, iou_thresh));
      const uint32_t w2 = __ballot_sync(kFull, col && c > ar[2] &&
                                                   iou_above(rb[2], ra[2], cb, ca, iou_thresh));
      const uint32_t w3 = __ballot_sync(kFull, col && c > ar[3] &&
                                                   iou_above(rb[3], ra[3], cb, ca, iou_thresh));
      if ((lane & 15) == g - g0) {
        mine0 = half ? w1 : w0;
        mine1 = half ? w3 : w2;
      }
    }
    const int g = g0 + (lane & 15);
    if (g >= g_begin && g < g_end) {
      const int a0 = half ? ar[1] : ar[0];
      const int a1 = half ? ar[3] : ar[2];
      if (a0 < v) conf[static_cast<size_t>(a0) * stride + g] = mine0;
      if (a1 < v) conf[static_cast<size_t>(a1) * stride + g] = mine1;
    }
    __syncthreads();      // the columns are read: the next pair may stage its own
  }
}

// OR the words of the kept rows `rows[0 .. nk)` at 16-byte chunks c_begin ..
// c_end - 1 into the shared removed words, on threads tid = 0 .. nthreads - 1:
// item = (chunk, group of kOrRows rows), chunks fastest, so a warp reads
// neighbouring chunks of one row, and a thread has kOrRows loads in flight
__device__ __forceinline__ void or_kept_rows(uint32_t* removed, const uint4* conf4, size_t stride4,
                                             const int* rows, int nk, int c_begin, int c_end,
                                             int tid, int nthreads) {
  const int chunks = c_end - c_begin;
  if (nk <= 0 || chunks <= 0) return;
  const int items = chunks * ((nk + kOrRows - 1) / kOrRows);
  for (int item = tid; item < items; item += nthreads) {
    const int c = c_begin + item % chunks;
    const int j0 = item / chunks * kOrRows;
    uint4 x[kOrRows];
#pragma unroll
    for (int u = 0; u < kOrRows; ++u) {
      x[u] = j0 + u < nk ? conf4[static_cast<size_t>(rows[j0 + u]) * stride4 + c]
                         : make_uint4(0u, 0u, 0u, 0u);
    }
    uint4 acc = x[0];
#pragma unroll
    for (int u = 1; u < kOrRows; ++u) {
      acc.x |= x[u].x;
      acc.y |= x[u].y;
      acc.z |= x[u].z;
      acc.w |= x[u].w;
    }
    uint32_t* dst = removed + 4 * c;
    if (acc.x) atomicOr(dst, acc.x);
    if (acc.y) atomicOr(dst + 1, acc.y);
    if (acc.z) atomicOr(dst + 2, acc.z);
    if (acc.w) atomicOr(dst + 3, acc.w);
  }
}

// copy tile s's diagonal block of words (rows s x kTile .., words s x
// kTileWords ..; only rows < v and 16-byte chunks that start below vwords)
// into buf, one cp.async of 16 bytes a chunk
__device__ __forceinline__ void stage_tile(uint32_t* buf, const uint32_t* conf, size_t stride,
                                           int v, int vwords, int s) {
  const int r0 = s * kTile;
  const int rows = min(kTile, v - r0);
  const int w0 = s * kTileWords;
  constexpr int chunks = kTileWords / 4;
  for (int e = threadIdx.x; e < rows * chunks; e += kScanThreads) {
    const int r = e / chunks;
    const int q = (e % chunks) * 4;
    if (w0 + q < vwords)
      cp_async16(buf + r * kTileWords + q, conf + static_cast<size_t>(r0 + r) * stride + w0 + q);
  }
}

// 3. the tiled greedy scan of one frame; one CTA an SM at most (the B frames
// run on B SMs), so warp 0's chain may take up to 128 registers a thread
__global__ void __launch_bounds__(kScanThreads, 1)
nms_wide_scan(Wide ws, bool* __restrict__ keep, int k) {
  extern __shared__ __align__(16) uint32_t scan_smem[];
  uint32_t* diag = scan_smem;                    // 2 tiles of kTile x kTileWords
  uint32_t* removed = scan_smem + 2 * kTileU32;  // conf_stride(K) words
  __shared__ int klist[2][kTile];                // a tile's kept rows, by tile parity
  __shared__ uint32_t kept_tile[2][kTileWords];
  __shared__ int nkept[2];
  const int v = ws.count[blockIdx.x];
  if (v == 0) return;     // uniform
  const size_t stride = conf_stride(k);
  const int vwords = (v + 31) >> 5;
  const int tiles = (v + kTile - 1) / kTile;
  const size_t f0 = static_cast<size_t>(blockIdx.x) * k;
  const uint32_t* conf = ws.conf + f0 * stride;
  const int* vi = ws.vi + f0;
  bool* fk = keep + f0;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const uint4* conf4 = reinterpret_cast<const uint4*>(conf);
  const size_t stride4 = stride / 4;
  const int c_end = (vwords + 3) / 4;   // 16-byte chunks of a row in use

  for (int w = threadIdx.x; w < static_cast<int>(stride); w += kScanThreads) removed[w] = 0u;
  stage_tile(diag, conf, stride, v, vwords, 0);
  cp_async_commit();
  if (tiles > 1) stage_tile(diag + kTileU32, conf, stride, v, vwords, 1);
  cp_async_commit();

  for (int s = 0; s < tiles; ++s) {
    const int r0 = s * kTile;
    const int rows = min(kTile, v - r0);
    cp_async_wait<1>();   // this thread's copies of tile s have landed
    __syncthreads();      // everyone's, and every earlier tile's ORs into tile s's words

    if (warp == 0) {
      // the blocked scan on the staged tile: lane l owns removed word
      // s x kTileWords + l; for block b (rows 32 b .. 32 b + 31 of the tile)
      // lane r holds row r's diagonal word, the block's greedy keep mask is
      // the fixpoint of kept = cand & ~OR{row words of kept rows} (unique,
      // since a row only suppresses later rows), and the lanes right of b
      // OR in the kept rows' words
      const uint32_t* tile = diag + (s & 1) * kTileU32;
      const int blocks = (rows + 31) >> 5;
      uint32_t rem = lane < blocks ? removed[s * kTileWords + lane] : 0u;
      uint32_t rw = lane < rows ? tile[lane * kTileWords] : 0u;
      uint32_t mine = 0u;
      for (int b = 0; b < blocks; ++b) {
        const int row0 = b << 5;
        const int n = min(32, rows - row0);
        const uint32_t next_rw = lane < rows - row0 - 32
                                     ? tile[(row0 + 32 + lane) * kTileWords + b + 1] : 0u;
        const uint32_t valid = n == 32 ? kFull : (1u << n) - 1u;
        const uint32_t cand = ~__shfl_sync(kFull, rem, b) & valid;
        uint32_t kept = cand;
        for (;;) {        // a round settles one more row: n + 1 rounds at most
          const uint32_t hit = __reduce_or_sync(kFull, (kept >> lane) & 1u ? rw : 0u);
          const uint32_t next = cand & ~hit;
          if (next == kept) break;
          kept = next;
        }
        if (lane == b) mine = kept;
        if (lane > b && lane < blocks) {   // OR the kept rows' words: loads, then a tree
          const uint32_t* words = tile + row0 * kTileWords + lane;
          uint32_t x[32];
#pragma unroll
          for (int r = 0; r < 32; ++r) x[r] = (kept >> r) & 1u ? words[r * kTileWords] : 0u;
#pragma unroll
          for (int r = 0; r < 16; ++r) x[r] |= x[r + 16];
#pragma unroll
          for (int r = 0; r < 8; ++r) x[r] |= x[r + 8];
#pragma unroll
          for (int r = 0; r < 4; ++r) x[r] |= x[r + 4];
          rem |= (x[0] | x[1]) | (x[2] | x[3]);
        }
        rw = next_rw;
      }
      // list the tile's kept rows in order: a warp prefix sum of the counts
      const int cnt = __popc(mine);
      int incl = cnt;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(kFull, incl, d);
        if (lane >= d) incl += y;
      }
      int pos = incl - cnt;
      for (uint32_t m = mine; m != 0u; m &= m - 1u)
        klist[s & 1][pos++] = r0 + (lane << 5) + __ffs(m) - 1;
      if (lane < kTileWords) kept_tile[s & 1][lane] = mine;
      if (lane == 31) nkept[s & 1] = incl;
    } else if (s > 0) {
      // meanwhile the other warps finish the last tile: its keep bytes, and
      // its kept rows' words right of this tile
      const int p = (s - 1) & 1;
      const int t0 = threadIdx.x - 32;
      for (int t = t0; t < kTile; t += kScanThreads - 32)
        fk[vi[r0 - kTile + t]] = (kept_tile[p][t >> 5] >> (t & 31)) & 1u;
      or_kept_rows(removed, conf4, stride4, klist[p], nkept[p], (s + 1) * kTileWords / 4, c_end,
                   t0, kScanThreads - 32);
    }
    __syncthreads();      // the tile's kept rows are listed; its buffer is free

    if (s + 2 < tiles) stage_tile(diag + (s & 1) * kTileU32, conf, stride, v, vwords, s + 2);
    cp_async_commit();    // an empty group past the last tile keeps the count
    // the tile's kept rows' words into the next tile's words, which its scan
    // needs first; the words past it are ORed in during that scan
    or_kept_rows(removed, conf4, stride4, klist[s & 1], nkept[s & 1], (s + 1) * kTileWords / 4,
                 min((s + 2) * kTileWords / 4, c_end), threadIdx.x, kScanThreads);
  }
  const int last = tiles - 1;   // the last tile's keep bytes
  for (int t = threadIdx.x; t < v - last * kTile; t += kScanThreads)
    fk[vi[last * kTile + t]] = (kept_tile[last & 1][t >> 5] >> (t & 31)) & 1u;
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
  const int grid = conflict_grid(batch, k);
  const size_t blocks = static_cast<size_t>(batch) * grid;
  if (blocks > 0x7fffffffu) return static_cast<int>(cudaErrorInvalidValue);
  const Wide ws = wide_layout(scratch, batch, k);
  nms_wide_compact<<<batch, kThreads, 0, st>>>(
      static_cast<const float4*>(boxes), static_cast<const float*>(scores),
      static_cast<bool*>(keep), ws, k);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  nms_wide_conflicts<<<static_cast<unsigned>(blocks), kConfThreads, 0, st>>>(ws, k, grid,
                                                                             iou_thresh);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = (2 * static_cast<size_t>(kTileU32) + conf_stride(k)) * sizeof(uint32_t);
  err = raise_smem_limit(nms_wide_scan, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  nms_wide_scan<<<batch, kScanThreads, smem, st>>>(ws, static_cast<bool*>(keep), k);
  return static_cast<int>(cudaGetLastError());
}
