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
// wraps, C++'s signed overflow is undefined. One thread per (row, column),
// grid (row blocks, K); a binary search over the column's rcap run ends,
// which stay in L1/L2 (a few KB per stack).
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

template <bool DELTA>
__global__ void expand_rows(const int* __restrict__ W,
                            const int* __restrict__ C,
                            const int* __restrict__ S, int rcap, int n,
                            unsigned bool_bits, int* __restrict__ out_i32,
                            bool* __restrict__ out_b) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  int k = blockIdx.y;
  if (i >= n) return;
  const int* c = C + (long long)k * rcap;
  int lo = 0, hi = rcap;  // first j with c[j] > i
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    if (c[mid] <= i)
      lo = mid + 1;
    else
      hi = mid;
  }
  int j = lo < rcap ? lo : rcap - 1;
  unsigned v = (unsigned)W[(long long)k * rcap + j];
  if (DELTA) v += (unsigned)S[k] * (unsigned)i;
  int bools_before = __popc(bool_bits & ((1u << k) - 1u));
  if ((bool_bits >> k) & 1u)
    out_b[(long long)bools_before * n + i] = v != 0u;
  else
    out_i32[(long long)(k - bools_before) * n + i] = (int)v;
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
// bool [popcount(bool_bits), n]. K <= 32.
AMT_API int amt_expand_runs(const int* W, const int* C, const int* S, int K,
                            int rcap, int n, unsigned bool_bits, int* out_i32,
                            bool* out_b, cudaStream_t stream, int* launched) {
  if (K <= 0 || n <= 0) return (int)cudaGetLastError();
  if (K > 32 || rcap <= 0) return (int)cudaErrorInvalidValue;
  dim3 grid(amt_blocks(n), K);
  if (S != nullptr)
    expand_rows<true><<<grid, AMT_THREADS, 0, stream>>>(
        W, C, S, rcap, n, bool_bits, out_i32, out_b);
  else
    expand_rows<false><<<grid, AMT_THREADS, 0, stream>>>(
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
