// sort_winners: per-key winners, conflict counts and per-object stats for
// any group geometry, by a sort of packed group keys.
//
// Replaces automerge_tpu/ops/merge.py resolve_state (:110-213), minus its
// forest call (forest.cu). The reference stably sorts (obj, kind, key, row)
// and takes each segment's largest visible sorted position. Rows ascend in
// Lamport order, so that position is the group's largest visible ROW, and
// the conflict count is the group's number of visible rows: the kernel
// needs the groups, not a stable order. Each row's group is one int64 key
//   ((g_obj * 2 + g_kind) << 32) | (uint32)(g_key + 4),
// with g_obj = P for padding rows: 2*g_obj + g_kind < 2^31 for P < 2^29,
// and the low word takes any int32 g_key (the elem_ref sentinels reach -3)
// injectively. Two hazards this layout avoids: packing the row into the
// key as well overflows int64 from P = 2^20 on, and a key field sized by
// P (ceil_log2(P + 5) bits) overflows on subset columns, whose prop ids
// are the whole log's and may exceed the subset's P. The keys are
// sorted with the bitonic network (padded to M = next_pow2(P) with
// INT64_MAX), and a row's group slot is the lower bound of its key in the
// sorted keys: the first sorted position holding it, one slot per group.
// Visible rows atomicMax their row and atomicAdd 1 into their slot; a
// gather pass then reads each row's slot back and atomically accumulates
// the per-object stats, as scatter_winners.cu does. Max and add commute,
// so the result is exact whatever the order of the atomics.
//
// Bound: bytes. Inputs action, elem_ref, obj_dense, prop (4P each), insert
// and visible (1P each) are read once, width only at the winners of
// visible elements; winner, conflicts (4P each) and the two stats arrays
// (4(P+2) each) written once. The sort's log2(M)(log2(M)+1)/2 passes over
// 8M bytes and the binary searches are what the simple design pays beyond
// that.
#include "bitonic.cuh"

__device__ __forceinline__ long long sk_key(int r, int a, bool ins, int er,
                                            int od, int pr, int P) {
  bool is_map = pr >= 0;
  long long g_obj = a != AMT_PAD_ACTION ? (long long)od : (long long)P;
  int g_key = is_map ? pr : (ins ? r : er);
  unsigned low = (unsigned)g_key + 4u;
  unsigned long long high = (unsigned long long)(g_obj * 2 + (is_map ? 1 : 0));
  return (long long)((high << 32) | low);
}

// first position of key in sorted[0:M)
__device__ __forceinline__ int sk_lower_bound(const long long* __restrict__ sorted,
                                              int M, long long key) {
  int lo = 0, hi = M;
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    if (sorted[mid] < key) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// keys [M] (padded with INT64_MAX), win/cnt [M] initialised -1 / 0, the
// stats [2, P+2] zeroed
__global__ void sk_keys(const int* __restrict__ action,
                        const bool* __restrict__ insert,
                        const int* __restrict__ elem_ref,
                        const int* __restrict__ obj_dense,
                        const int* __restrict__ prop, int P, int M,
                        long long* __restrict__ keys, int* __restrict__ win,
                        int* __restrict__ cnt, int* __restrict__ stats) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < M) {
    keys[i] = i < P ? sk_key(i, action[i], insert[i], elem_ref[i],
                             obj_dense[i], prop[i], P)
                    : AMT_KEY_MAX;
    win[i] = -1;
    cnt[i] = 0;
  }
  if (i < 2 * (P + 2)) stats[i] = 0;
}

__global__ void sk_scatter(const int* __restrict__ action,
                           const bool* __restrict__ insert,
                           const int* __restrict__ elem_ref,
                           const int* __restrict__ obj_dense,
                           const int* __restrict__ prop,
                           const bool* __restrict__ visible,
                           const long long* __restrict__ sorted, int P, int M,
                           int* __restrict__ slot,
                           int* __restrict__ win, int* __restrict__ cnt) {
  int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= P) return;
  long long key = sk_key(r, action[r], insert[r], elem_ref[r], obj_dense[r],
                         prop[r], P);
  int s = sk_lower_bound(sorted, M, key);
  slot[r] = s;
  if (!visible[r]) return;  // invisible rows add max(-1) / +0
  atomicMax(&win[s], r);
  atomicAdd(&cnt[s], 1);
}

__global__ void sk_gather(const int* __restrict__ action,
                          const bool* __restrict__ insert,
                          const int* __restrict__ obj_dense,
                          const int* __restrict__ width,
                          const int* __restrict__ slot, int P,
                          const int* __restrict__ win,
                          const int* __restrict__ cnt,
                          int* __restrict__ winner, int* __restrict__ conflicts,
                          int* __restrict__ obj_vis_len,
                          int* __restrict__ obj_text_width) {
  int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= P) return;
  int s = slot[r];
  int w = win[s];
  winner[r] = w;
  conflicts[r] = cnt[s];
  int od = obj_dense[r];
  // a visible element of object od (padding rows index P+1: dropped)
  if (action[r] != AMT_PAD_ACTION && insert[r] && w >= 0 && od >= 0 &&
      od < P + 2) {
    atomicAdd(&obj_vis_len[od], 1);
    atomicAdd(&obj_text_width[od], width[amt_clamp(w, P)]);
  }
}

// keys: int64 [M] scratch (M = next_pow2(P)); win/cnt: int32 [M] and
// slot: int32 [P] scratch; winner/conflicts: int32 [P]; stats: int32
// [2, P+2] (obj_vis_len, obj_text_width)
AMT_API int amt_sort_winners(const int* action, const bool* insert,
                             const int* elem_ref, const int* obj_dense,
                             const int* prop, const int* width,
                             const bool* visible, int P, int M,
                             long long* keys, int* win, int* cnt, int* slot,
                             int* winner, int* conflicts, int* stats,
                             cudaStream_t stream, int* launched) {
  if (P < 0 || M < P || M < 1 || (M & (M - 1)) != 0 || P >= (1 << 29))
    return (int)cudaErrorInvalidValue;
  long long fill = M > 2LL * (P + 2) ? (long long)M : 2LL * (P + 2);
  sk_keys<<<amt_blocks(fill), AMT_THREADS, 0, stream>>>(
      action, insert, elem_ref, obj_dense, prop, P, M, keys, win, cnt,
      stats);
  AMT_LAUNCHED;
  amt_bitonic_steps(keys, M, stream, launched);
  if (P == 0) return (int)cudaGetLastError();  // only the zeroed stats
  sk_scatter<<<amt_blocks(P), AMT_THREADS, 0, stream>>>(
      action, insert, elem_ref, obj_dense, prop, visible, keys, P, M, slot,
      win, cnt);
  AMT_LAUNCHED;
  sk_gather<<<amt_blocks(P), AMT_THREADS, 0, stream>>>(
      action, insert, obj_dense, width, slot, P, win, cnt, winner, conflicts,
      stats, stats + (P + 2));
  AMT_LAUNCHED;
  return (int)cudaGetLastError();
}
