// Greedy maximum-similarity assignment for Hopper (sm_90a): the trackers'
// association step, with no read of the device from the host.
//
// Replaces no TPU kernel.  The JAX package runs greedy assignment as a
// data-dependent lax.while_loop that XLA compiles (rtmodt_tpu/ops/
// assignment.py); the port's plain version (ops/assignment.py::
// greedy_assign_reference) is a Python loop that reads its condition on the
// host once a round.  That read is a device -> host sync, and it keeps the
// tracker step out of a CUDA graph.  This kernel runs every round on the
// card and writes the round count to device memory.
//
// Function (the plain version's, bit for bit): for each of S matrices
// (R, C), NaN counts as -1e9, +inf as FLT_MAX and -inf as -FLT_MAX
// (torch.nan_to_num(x, nan=-1e9)); invalid rows and columns count as -1e9.
// Mutual-best rounds: row r's best column (first index on a tie) and column
// c's best row (first index on a tie) name each other, and the entry is
// >= threshold: the pair is committed and its row and column count as
// -1e9 from then on.  A matrix stops when no entry is >= threshold, or
// after min(R, C) rounds.  Outputs row_to_col (S, R), col_to_row (S, C)
// int32 (-1 if unmatched) and the largest round count of the S matrices
// (an atomicMax into a zeroed device int).
//
// What bounds it on this card: one read of the S matrices (S x R x C x 4
// bytes: 3.3 MB at the cells' 32 x 256 x 100, ~1 us at 3.35 TB/s), then a
// dependent chain of rounds, each a row argmax, a column argmax and the
// commit, with a block-wide barrier between them; the operations are a few
// compares an entry a round.
//
// Design.  One CTA per matrix (per stream, per association).
//   * Shared path (the matrix fits a block's shared memory: 256 slots x 100
//     detections is 100 KB).  The valid rows and columns are listed in order
//     first (a block-wide ballot compaction); the trackers' matrices are
//     mostly invalid (a few tens of live slots of 256, a dozen high or low
//     detections of 100), so only the valid rows' and columns' entries are
//     loaded into dynamic shared memory, cleaned of NaN and infinities on
//     the way, with an odd row stride so that threads on consecutive rows
//     read different banks, and a thread per column reads consecutive words.
//   * Rows and columns keep an alive flag (a committed one dies) instead of
//     writing -1e9 back into the matrix each round.  The plain version's
//     matrix holds -1e9 at every dead (invalid or committed) row and
//     column; a row's or column's best over its live entries is turned into
//     its best over all of them with the least dead index (where the live
//     best is -1e9 the first of the two indices wins, below it the dead
//     index does), so ties break on the first index exactly as the plain
//     version's argmax does.  A dead row's best is (-1e9, column 0), a dead
//     column's best row is 0.
//   * Round k: a thread per live row takes its row's best; __syncthreads_or
//     of "best >= threshold" is the loop's condition; a thread per live
//     column takes its column's best row; a thread per live row commits a
//     mutual pair (mutual pairs have distinct columns, so no two threads
//     write one column).  With a threshold at or below -1e9 a dead row can
//     pair with column 0, as in the plain version; one thread takes that
//     case, read before any commit of the round.
//   * Global path (the matrix past shared memory, e.g. 1024 slots or 300
//     detections): the same rounds over every row and column, reading the
//     matrix from device memory, a warp per row (lanes over columns, a
//     shuffle argmax that keeps the first index) and a thread per column
//     (consecutive columns, coalesced), with the flags and bests in a
//     scratch buffer the caller allocates.

#include <cfloat>
#include <cmath>
#include <climits>
#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr float kNeg = -1e9f;
constexpr int kMaxThreads = 1024;
constexpr int kMaxDevices = 64;

__device__ __forceinline__ float clean(float v) {
  if (isnan(v)) return kNeg;
  if (isinf(v)) return v > 0.f ? FLT_MAX : -FLT_MAX;
  return v;
}

struct Args {
  const float* sim;              // (S, R, C)
  const unsigned char* row_valid;  // (S, R) bool or null
  const unsigned char* col_valid;  // (S, C) bool or null
  int* row_to_col;               // (S, R)
  int* col_to_row;               // (S, C)
  int* rounds;                   // () zeroed by the caller
  float thr;
  int r;
  int c;
};

// Shared memory of the shared path, sized by the shapes (the matrix of the
// valid rows and columns may be all of it): the compact matrix (rows of an
// odd stride), the compact row and column lists, each column's compact
// position, rowval / rowbest by compact row, colbest by column, the
// compaction's warp counts and four scalars; then the byte flags.
__host__ __device__ inline size_t shared_bytes(int r, int c) {
  return (static_cast<size_t>(r) * (c | 1) + 3 * static_cast<size_t>(r) + 3 * c + 37) * 4 +
         2 * static_cast<size_t>(r) + c;
}

// Block-wide ordered compaction: out[0..n') = the indices i < n with
// valid[i] (every i where valid is null); returns n'.  Every thread calls it.
__device__ int compact(const unsigned char* valid, int n, int* out, int* wbase) {
  const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31, w = tid >> 5;
  int total = 0;
  for (int base = 0; base < n; base += nt) {
    const int i = base + tid;
    const bool f = i < n && (valid == nullptr || valid[i]);
    const unsigned ballot = __ballot_sync(0xffffffffu, f);
    if (lane == 0) wbase[w] = __popc(ballot);
    __syncthreads();
    if (tid == 0) {
      int acc = total;
      for (int k = 0; k < nt / 32; ++k) {
        const int cnt = wbase[k];
        wbase[k] = acc;
        acc += cnt;
      }
      wbase[32] = acc;
    }
    __syncthreads();
    if (f) out[wbase[w] + __popc(ballot & ((1u << lane) - 1))] = i;
    total = wbase[32];
    __syncthreads();
  }
  return total;
}

// The best of a row or column over its live entries (value, first original
// index), to the best over every entry, where the dead ones (invalid or
// committed) count as -1e9: `first_dead` is the least dead index (n if none).
__device__ __forceinline__ void with_dead(float best, int bi, int first_dead, int n,
                                          float* val, int* idx) {
  if (first_dead >= n || best > kNeg) {
    *val = best;
    *idx = bi;
  } else {
    *val = kNeg;
    *idx = best == kNeg ? min(bi, first_dead) : first_dead;
  }
}

__global__ void __launch_bounds__(kMaxThreads) assign_shared_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int R = a.r, C = a.c;
  float* m = reinterpret_cast<float*>(smem);
  int* arow = reinterpret_cast<int*>(m + static_cast<size_t>(R) * (C | 1));
  int* acol = arow + R;
  int* cpos = acol + C;
  float* rowval = reinterpret_cast<float*>(cpos + C);
  int* rowbest = reinterpret_cast<int*>(rowval + R);
  int* colbest = rowbest + R;
  int* wbase = colbest + C;          // 33
  int* scal = wbase + 33;            // first dead row, first dead column
  unsigned char* ralive = reinterpret_cast<unsigned char*>(scal + 4);
  unsigned char* calive = ralive + R;
  unsigned char* row_live = calive + C;   // by row, for the dead-row case

  const size_t s = blockIdx.x;
  const float* sim = a.sim + s * R * C;
  const unsigned char* rv = a.row_valid ? a.row_valid + s * R : nullptr;
  const unsigned char* cv = a.col_valid ? a.col_valid + s * C : nullptr;
  int* r2c = a.row_to_col + s * R;
  int* c2r = a.col_to_row + s * C;
  const int tid = threadIdx.x, nt = blockDim.x;

  for (int i = tid; i < R; i += nt) {
    row_live[i] = rv ? rv[i] : 1;
    r2c[i] = -1;
  }
  for (int j = tid; j < C; j += nt) {
    c2r[j] = -1;
    colbest[j] = 0;                  // a dead column's best row
    cpos[j] = -1;
  }
  const int na = compact(rv, R, arow, wbase);
  const int nc = compact(cv, C, acol, wbase);
  if (tid == 0) {
    scal[0] = na < R ? na : R;
    scal[1] = nc < C ? nc : C;
  }
  __syncthreads();
  // the first invalid index is the first gap in the ascending list
  for (int i = tid; i < na; i += nt)
    if (arow[i] != i) atomicMin(&scal[0], i);
  for (int j = tid; j < nc; j += nt) {
    if (acol[j] != j) atomicMin(&scal[1], j);
    cpos[acol[j]] = j;
  }
  // the valid rows' and columns' entries, cleaned: odd stride, so threads on
  // consecutive rows read different banks
  const int stride = nc | 1;
  for (int i = tid; i < na * nc; i += nt) {
    const int ra = i / nc, cb = i - ra * nc;
    m[ra * stride + cb] = clean(sim[static_cast<size_t>(arow[ra]) * C + acol[cb]]);
  }
  for (int i = tid; i < na; i += nt) ralive[i] = 1;
  for (int j = tid; j < nc; j += nt) calive[j] = 1;
  __syncthreads();

  const float thr = a.thr;
  const int max_rounds = min(R, C);
  int k = 0;
  for (; k < max_rounds; ++k) {
    const int fdr = scal[0], fdc = scal[1];
    // a dead row's best is (-1e9, column 0)
    int more = tid == 0 && thr <= kNeg && fdr < R;
    for (int ra = tid; ra < na; ra += nt) {
      if (!ralive[ra]) continue;
      const float* row = m + ra * stride;
      float best = -INFINITY;
      int bi = INT_MAX;
#pragma unroll 4
      for (int cb = 0; cb < nc; ++cb) {
        const float v = calive[cb] ? row[cb] : -INFINITY;
        if (v > best) {
          best = v;
          bi = cb;
        }
      }
      float val;
      int idx;
      with_dead(best, bi == INT_MAX ? INT_MAX : acol[bi], fdc, C, &val, &idx);
      rowval[ra] = val;
      rowbest[ra] = idx;
      more |= val >= thr;
    }
    if (!__syncthreads_or(more)) break;
    for (int cb = tid; cb < nc; cb += nt) {
      int idx = 0;
      if (calive[cb]) {
        float best = -INFINITY;
        int bi = INT_MAX;
#pragma unroll 4
        for (int ra = 0; ra < na; ++ra) {
          const float v = ralive[ra] ? m[ra * stride + cb] : -INFINITY;
          if (v > best) {
            best = v;
            bi = ra;
          }
        }
        float unused;
        with_dead(best, bi == INT_MAX ? INT_MAX : arow[bi], fdr, R, &unused, &idx);
      }
      colbest[acol[cb]] = idx;
    }
    __syncthreads();
    // a dead row commits to column 0 where column 0's best row is it (only
    // reachable with a threshold at or below -1e9); read before any commit
    int dead_r = -1;
    if (thr <= kNeg) {
      if (tid == 0 && !row_live[colbest[0]]) dead_r = colbest[0];
      __syncthreads();
    }
    for (int ra = tid; ra < na; ra += nt) {
      if (!ralive[ra]) continue;
      const int r = arow[ra], j = rowbest[ra];
      if (colbest[j] == r && rowval[ra] >= thr) {
        r2c[r] = j;
        c2r[j] = r;
        ralive[ra] = 0;
        row_live[r] = 0;
        if (cpos[j] >= 0) calive[cpos[j]] = 0;
        atomicMin(&scal[0], r);
        atomicMin(&scal[1], j);
      }
    }
    if (dead_r >= 0) {
      r2c[dead_r] = 0;
      c2r[0] = dead_r;
      if (cpos[0] >= 0) calive[cpos[0]] = 0;
      atomicMin(&scal[1], 0);
    }
    __syncthreads();
  }
  if (tid == 0 && k > 0) atomicMax(a.rounds, k);
}

// Scratch of the global path, per matrix: rowval, rowbest, colbest (4 bytes
// each), then the flags, padded to 16 bytes.
__host__ __device__ inline size_t global_scratch_per(int r, int c) {
  const size_t n = (2 * static_cast<size_t>(r) + c) * 4 + static_cast<size_t>(r) + c;
  return (n + 15) / 16 * 16;
}

__global__ void __launch_bounds__(kMaxThreads)
    assign_global_kernel(Args a, unsigned char* scratch) {
  const int R = a.r, C = a.c;
  const size_t s = blockIdx.x;
  unsigned char* base = scratch + s * global_scratch_per(R, C);
  float* rowval = reinterpret_cast<float*>(base);
  int* rowbest = reinterpret_cast<int*>(rowval + R);
  int* colbest = rowbest + R;
  unsigned char* row_alive = reinterpret_cast<unsigned char*>(colbest + C);
  unsigned char* col_alive = row_alive + R;

  const float* sim = a.sim + s * R * C;
  const unsigned char* rv = a.row_valid ? a.row_valid + s * R : nullptr;
  const unsigned char* cv = a.col_valid ? a.col_valid + s * C : nullptr;
  int* r2c = a.row_to_col + s * R;
  int* c2r = a.col_to_row + s * C;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nt >> 5;

  for (int i = tid; i < R; i += nt) {
    row_alive[i] = rv ? rv[i] : 1;
    r2c[i] = -1;
  }
  for (int j = tid; j < C; j += nt) {
    col_alive[j] = cv ? cv[j] : 1;
    c2r[j] = -1;
  }
  __syncthreads();

  const float thr = a.thr;
  const int max_rounds = min(R, C);
  int k = 0;
  for (; k < max_rounds; ++k) {
    int more = 0;
    for (int r = warp; r < R; r += nwarps) {
      float best = kNeg;
      int bi = 0;
      if (row_alive[r]) {
        const float* row = sim + static_cast<size_t>(r) * C;
        // each lane's first index on a tie, then the warp's: the larger
        // value, the smaller index on equal values
        best = -INFINITY;
        bi = INT_MAX;
        for (int j = lane; j < C; j += 32) {
          const float v = col_alive[j] ? clean(row[j]) : kNeg;
          if (v > best) {
            best = v;
            bi = j;
          }
        }
        for (int off = 16; off > 0; off >>= 1) {
          const float ov = __shfl_down_sync(0xffffffffu, best, off);
          const int oi = __shfl_down_sync(0xffffffffu, bi, off);
          if (ov > best || (ov == best && oi < bi)) {
            best = ov;
            bi = oi;
          }
        }
        best = __shfl_sync(0xffffffffu, best, 0);
        bi = __shfl_sync(0xffffffffu, bi, 0);
      }
      if (lane == 0) {
        rowval[r] = best;
        rowbest[r] = bi;
        more |= best >= thr;
      }
    }
    if (!__syncthreads_or(more)) break;
    for (int j = tid; j < C; j += nt) {
      int bi = 0;
      if (col_alive[j]) {
        float best = row_alive[0] ? clean(sim[j]) : kNeg;
        for (int r = 1; r < R; ++r) {
          const float v = row_alive[r] ? clean(sim[static_cast<size_t>(r) * C + j]) : kNeg;
          if (v > best) {
            best = v;
            bi = r;
          }
        }
      }
      colbest[j] = bi;
    }
    __syncthreads();
    for (int r = tid; r < R; r += nt) {
      const int j = rowbest[r];
      if (colbest[j] == r && rowval[r] >= thr) {
        r2c[r] = j;
        c2r[j] = r;
        row_alive[r] = 0;
        col_alive[j] = 0;
      }
    }
    __syncthreads();
  }
  if (tid == 0 && k > 0) atomicMax(a.rounds, k);
}

// The shared memory a block may opt in to on the current device, read once
// a device.
int optin_limit(int* device_out) {
  static int limit[kMaxDevices] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices) return -1;
  *device_out = dev;
  if (limit[dev] == 0) {
    int v = 0;
    if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess)
      return -1;
    limit[dev] = v;
  }
  return limit[dev];
}

bool use_shared(int r, int c) {
  int dev = 0;
  const int limit = optin_limit(&dev);
  return limit > 0 && shared_bytes(r, c) <= static_cast<size_t>(limit);
}

int threads_for(int n) {
  const int t = (n + 31) / 32 * 32;
  return t < 32 ? 32 : (t > kMaxThreads ? kMaxThreads : t);
}

}  // namespace

// Bytes of device scratch that a launch of (streams, r, c) needs: 0 where the
// matrix fits a block's shared memory.
extern "C" size_t assign_scratch_bytes(int streams, int r, int c) {
  if (streams <= 0 || r <= 0 || c <= 0 || use_shared(r, c)) return 0;
  return static_cast<size_t>(streams) * global_scratch_per(r, c);
}

// sim (S, R, C) f32, row_valid (S, R) / col_valid (S, C) bool or null,
// row_to_col (S, R) / col_to_row (S, C) int32, rounds a zeroed int32: device
// pointers, contiguous; scratch: assign_scratch_bytes(S, R, C) bytes,
// 16-byte aligned (null where that is 0).  Launches on `stream`; returns the
// first nonzero CUDA error (cudaErrorInvalidValue for what it does not take).
// The shared path's limit is raised once a device, on the first launch that
// needs it (before any graph capture: torch.cuda.graph warms up first).
extern "C" int assign_greedy_launch(const void* sim, const void* row_valid,
                                    const void* col_valid, void* row_to_col,
                                    void* col_to_row, void* rounds, void* scratch,
                                    int streams, int r, int c, float threshold,
                                    void* stream) {
  if (streams <= 0 || r <= 0 || c <= 0 || sim == nullptr || rounds == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  Args a{static_cast<const float*>(sim), static_cast<const unsigned char*>(row_valid),
         static_cast<const unsigned char*>(col_valid), static_cast<int*>(row_to_col),
         static_cast<int*>(col_to_row), static_cast<int*>(rounds), threshold, r, c};
  if (use_shared(r, c)) {
    static bool raised[kMaxDevices] = {false};
    const size_t smem = shared_bytes(r, c);
    int dev = 0;
    const int limit = optin_limit(&dev);
    if (smem > 48 * 1024 && !raised[dev]) {
      cudaError_t err = cudaFuncSetAttribute(
          assign_shared_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, limit);
      if (err != cudaSuccess) return static_cast<int>(err);
      raised[dev] = true;
    }
    assign_shared_kernel<<<streams, threads_for(r > c ? r : c), smem, st>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
  if (scratch == nullptr || reinterpret_cast<uintptr_t>(scratch) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  assign_global_kernel<<<streams, kMaxThreads, 0, st>>>(a, static_cast<unsigned char*>(scratch));
  return static_cast<int>(cudaGetLastError());
}
