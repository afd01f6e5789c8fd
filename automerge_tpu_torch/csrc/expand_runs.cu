// expand_runs: slope-RLE run tables -> dense columns (kernel A), and the
// packed transport's flags split (kernel B, unpack_flags).
//
// expand_runs replaces automerge_tpu/ops/merge.py _expander (:849, K9),
// the in-jit run gather of run_native_kernel (:1015-1034, K1) and the
// packed transport's _expand (:1135, K10). A stack holds K columns of one
// length n as (K, rcap) int32 tables W (run values) and C (run ends,
// ascending, padded with n), plus one slope S[k] per column in a delta
// stack. Row i of column k takes run j = upper_bound(i, C[k, :rcap])
// (searchsorted side="right"), clamped to rcap - 1 as jnp.clip does, and
// the value W[k, j] + S[k] * i. The arithmetic is uint32: XLA's int32
// wraps, C++'s signed overflow is undefined.
//
// An interval expand, one block per tile of rows of one column (grid:
// tiles x K; 4,096 rows a tile, halved down to 1,024 while the grid has
// fewer than two blocks an SM, as the wrapper picks):
//   1. two warps find the tile's first and last runs, j0 = upper_bound of
//      its first row and j1 = that of its last row (each clamped to
//      rcap - 1), by a 32-way search: one load a lane per round, about
//      log32(rcap) dependent rounds, where a search per row took
//      log2(rcap);
//   2. the block stages C[j0..j1] and W[j0..j1] in shared memory (the runs
//      of a tile with run ends strictly ascending are at most its rows;
//      with repeated ends, which no encoder writes, the tile reads them
//      from global memory instead);
//   3. each thread owns ER_ROWS consecutive rows: one binary search in
//      shared memory for its first row's run, then a walk forward, a row
//      at a time, past the run ends it crosses;
//   4. bool columns leave as one 16-byte store of a thread's sixteen
//      bytes; int32 columns pass through shared memory so that each
//      warp's 16-byte stores are contiguous. Both where the rows are
//      whole and the column aligned (16 divides n at every stack of the
//      merge: the columns are padded to a multiple of 16 rows), else row
//      by row.
// The result depends only on the rows, never on the tiling.
//
// Columns marked in bool_bits (bit k: column k is a torch.bool column)
// are written as 0/1 bytes (value != 0) into out_b, the others as int32
// into out_i32, each in column order: column k's slot is the count of
// columns of its kind before it.
//
// Bound: bytes. The dense columns written (4n per int32 column, n per
// bool) dominate; W, C and S are read once per stack (8*K*rcap + 4K).
//
// unpack_flags replaces the flags split of _unpack_transport
// (:1157-1162): action = f & 15, insert = f & 16, value_tag = (f >> 5) &
// 15, covered = f & 512, one thread per row. Bound: bytes (4n read, 10n
// written).
#include "common.cuh"

#define ER_MAX_THREADS 256
#define ER_ROWS 16  // rows a thread: 4 int4 or 1 uint4 store
#define ER_FULL 0xffffffffu

// The first j in [0, len) with c[j] > x, or len, found by one warp: each
// round the 32 lanes probe the ends of 32 equal parts of [lo, hi) and
// keep the part where the answer lies.
__device__ int er_warp_upper_bound(const int* __restrict__ c, int len, int x,
                                   int lane) {
  int lo = 0, hi = len;  // c[j] <= x for j < lo, c[j] > x for j >= hi
  while (hi - lo > 32) {
    long long span = hi - lo;
    int p = lo + (int)(span * (lane + 1) / 32) - 1;
    int below = __popc(__ballot_sync(ER_FULL, c[p] <= x));
    int plo = __shfl_sync(ER_FULL, p, below > 0 ? below - 1 : 0);
    int phi = __shfl_sync(ER_FULL, p, below < 32 ? below : 31);
    if (below > 0) lo = plo + 1;
    if (below < 32) hi = phi;
  }
  bool le = lane < hi - lo && c[lo + lane] <= x;
  return lo + __popc(__ballot_sync(ER_FULL, le));
}

// one block of blockDim.x threads per tile of blockDim.x * ER_ROWS rows;
// dynamic shared memory: two int arrays of the tile's length
template <bool DELTA>
__global__ void __launch_bounds__(ER_MAX_THREADS)
expand_tiles(const int* __restrict__ W, const int* __restrict__ C,
             const int* __restrict__ S, int rcap, int n, unsigned bool_bits,
             int* __restrict__ out_i32, unsigned char* __restrict__ out_b) {
  extern __shared__ int er_smem[];
  __shared__ int bounds[2];
  int tile = blockDim.x * ER_ROWS;
  int* sC = er_smem;
  int* sW = er_smem + tile;
  int k = blockIdx.y;
  int a = blockIdx.x * tile;
  int last = min(a + tile, n) - 1;
  const int* c = C + (long long)k * rcap;
  const int* w = W + (long long)k * rcap;
  int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp < 2) {
    int j = er_warp_upper_bound(c, rcap, warp == 0 ? a : last, lane);
    if (lane == 0) bounds[warp] = min(j, rcap - 1);
  }
  __syncthreads();
  int j0 = bounds[0];
  int m = bounds[1] - j0 + 1;
  bool staged = m <= tile;
  if (staged)
    for (int t = threadIdx.x; t < m; t += blockDim.x) {
      sC[t] = c[j0 + t];
      sW[t] = w[j0 + t];
    }
  __syncthreads();
  const int* cs = staged ? sC : c + j0;
  const int* ws = staged ? sW : w + j0;
  int r0 = a + threadIdx.x * ER_ROWS;
  unsigned v[ER_ROWS];
  if (r0 < n) {
    // the first row's run: the first j in [0, m - 1) with cs[j] > r0, else
    // m - 1 (the clamp)
    int lo = 0, hi = m - 1;
    while (lo < hi) {
      int mid = (lo + hi) >> 1;
      if (cs[mid] <= r0)
        lo = mid + 1;
      else
        hi = mid;
    }
    int j = lo;
    unsigned slope = DELTA ? (unsigned)S[k] : 0u;
#pragma unroll
    for (int q = 0; q < ER_ROWS; ++q) {
      int i = r0 + q;
      while (j < m - 1 && cs[j] <= i) ++j;
      v[q] = (unsigned)ws[j] + slope * (unsigned)i;
    }
  }
  // column k's slot among the columns of its kind, each n long
  int before = __popc(bool_bits & ((1u << k) - 1u));
  if ((bool_bits >> k) & 1u) {
    // a thread's sixteen bytes: one 16-byte store where whole and aligned
    // (every column, when 16 divides n), else row by row
    if (r0 >= n) return;
    long long at = (long long)before * n + r0;
    if (r0 + ER_ROWS <= n && (at & 15) == 0) {
      unsigned word[4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        word[q] = (unsigned)(v[4 * q] != 0u) | (unsigned)(v[4 * q + 1] != 0u) << 8 |
                  (unsigned)(v[4 * q + 2] != 0u) << 16 |
                  (unsigned)(v[4 * q + 3] != 0u) << 24;
      *(uint4*)(out_b + at) = make_uint4(word[0], word[1], word[2], word[3]);
    } else {
#pragma unroll
      for (int q = 0; q < ER_ROWS; ++q)
        if (r0 + q < n) out_b[at + q] = v[q] != 0u;
    }
    return;
  }
  // int32: the tile's values pass through shared memory (the staged runs
  // are no longer read), so that a warp's 16-byte stores are contiguous
  __syncthreads();
  int4* s4 = (int4*)er_smem;
  if (r0 < n) {
#pragma unroll
    for (int q = 0; q < 4; ++q)
      s4[threadIdx.x * 4 + q] = make_int4((int)v[4 * q], (int)v[4 * q + 1],
                                          (int)v[4 * q + 2], (int)v[4 * q + 3]);
  }
  __syncthreads();
  long long col = (long long)(k - before) * n;
  bool aligned = (col & 3) == 0;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    int chunk = threadIdx.x + q * blockDim.x;  // rows a + 4 chunk .. + 3
    int row = a + 4 * chunk;
    if (row >= n) continue;
    int4 x = s4[chunk];
    if (aligned && row + 4 <= n) {
      *(int4*)(out_i32 + col + row) = x;
    } else {
      int vals[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (row + e < n) out_i32[col + row + e] = vals[e];
    }
  }
}

__global__ void unpack_rows(const int* __restrict__ flags, int n,
                            int* __restrict__ action, bool* __restrict__ insert,
                            int* __restrict__ value_tag,
                            bool* __restrict__ covered) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  unsigned f = (unsigned)flags[i];
  action[i] = (int)(f & 15u);
  insert[i] = (f & 16u) != 0u;
  value_tag[i] = (int)((f >> 5) & 15u);
  covered[i] = (f & 512u) != 0u;
}

// W, C: int32 [K, rcap]; S: int32 [K] for a delta stack, NULL for a pure
// run-length one; out_i32: int32 [K - popcount(bool_bits), n]; out_b:
// bool [popcount(bool_bits), n] (NULL where there are none of its kind),
// both 16-byte aligned; threads: 64, 128 or 256 a block, the tile
// threads * ER_ROWS rows (kernels/expand_runs.py tile_rows picks it). K
// <= 32.
AMT_API int amt_expand_runs(const int* W, const int* C, const int* S, int K,
                            int rcap, int n, unsigned bool_bits, int threads,
                            int* out_i32, unsigned char* out_b,
                            cudaStream_t stream, int* launched) {
  if (K <= 0 || n <= 0) return (int)cudaGetLastError();
  if (K > 32 || rcap <= 0 ||
      (threads != 64 && threads != 128 && threads != ER_MAX_THREADS))
    return (int)cudaErrorInvalidValue;
  int tile = threads * ER_ROWS;
  dim3 grid((n + tile - 1) / tile, K);
  size_t smem = 2 * (size_t)tile * sizeof(int);
  if (S != nullptr)
    expand_tiles<true><<<grid, threads, smem, stream>>>(
        W, C, S, rcap, n, bool_bits, out_i32, out_b);
  else
    expand_tiles<false><<<grid, threads, smem, stream>>>(
        W, C, S, rcap, n, bool_bits, out_i32, out_b);
  AMT_LAUNCHED;
  return (int)cudaGetLastError();
}

AMT_API int amt_unpack_flags(const int* flags, int n, int* action,
                             bool* insert, int* value_tag, bool* covered,
                             cudaStream_t stream, int* launched) {
  if (n <= 0) return (int)cudaGetLastError();
  unpack_rows<<<amt_blocks(n), AMT_THREADS, 0, stream>>>(
      flags, n, action, insert, value_tag, covered);
  AMT_LAUNCHED;
  return (int)cudaGetLastError();
}
