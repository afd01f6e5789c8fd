// sort_winners: per-key winners, conflict counts and per-object stats for
// any group geometry, by a hash table of packed group keys.
//
// Replaces automerge_tpu/ops/merge.py resolve_state (:110-213), minus its
// forest call (forest.cu). The reference stably sorts (obj, kind, key, row)
// and takes each segment's largest visible sorted position. Rows ascend in
// Lamport order, so that position is the group's largest visible ROW, and
// the conflict count is the group's number of visible rows: the kernel
// needs the groups, not an order. Each row's group is one int64 key
//   ((g_obj * 2 + g_kind) << 32) | (uint32)(g_key + 4),
// with g_obj = P for padding rows: 2*g_obj + g_kind < 2^31 for P < 2^29,
// and the low word takes any int32 g_key (the elem_ref sentinels reach -3)
// injectively. Two hazards this layout avoids: packing the row into the
// key as well overflows int64 from P = 2^20 on, and a key field sized by
// P (ceil_log2(P + 5) bits) overflows on subset columns, whose prop ids
// are the whole log's and may exceed the subset's P.
//
// The groups are found with an open-addressing table of C slots, C the
// power of two >= 2 max(P, 1): at most P groups, so the load stays at or
// under 1/2 and a linear probe always ends. Three launches:
//   1. sk_fill: the table keys to SK_EMPTY, win to -1, cnt and the stats
//      to 0;
//   2. sk_insert, one thread per row: the key hashed by murmur3's fmix64
//      (the keys are dense structured integers, which a plain modulo
//      would cluster), then a linear probe that loads each slot first and
//      takes it if it holds the key; only an empty slot is claimed with
//      atomicCAS, and a lost race reads the winner's key from the CAS
//      (so thousands of rows of one hot group meet a plain load, not a
//      queue of CAS). The row's slot is written, and a visible row
//      atomicMax-es its row into win and atomicAdd-s 1 into cnt;
//   3. sk_gather reads each row's slot back and accumulates the
//      per-object stats: one atomicAdd pair per object among a warp's
//      visible elements (__match_any_sync on the object, __reduce_add_sync
//      of the widths), since a text's elements share one object.
// Max and add commute, so the result is exact and the same whatever slot
// each group lands in and whatever the order of the atomics.
//
// SK_EMPTY is all ones, a value no key takes. Bit 32 of a key is the low
// bit of 2*g_obj + g_kind, that is g_kind: an all-ones key is a map key
// (g_kind 1), whose g_key is a prop id >= 0. Its low word g_key + 4 then
// lies in [4, 2^31 + 3], never 2^32 - 1. This holds for any int32 inputs.
//
// Bound: bytes. Inputs action, elem_ref, obj_dense, prop (4P each), insert
// and visible (1P each) are read once, width only at the winners of
// visible elements; winner, conflicts (4P each) and the two stats arrays
// (4(P+2) each) written once. The design adds the table (16 B a slot:
// key, win, cnt), the slot column (8P: written and read back) and the
// fill. At the record fan-in (P = 851,968) C = 2^21 and the table is
// 32 MiB, inside the H100's 50 MiB L2; at P = 1,060,921, C = 2^22 and it
// is 64 MiB: at least 14 MiB of it spills to device memory, so over a
// fifth of the random probes miss L2.
#include "common.cuh"

#define SK_EMPTY 0xffffffffffffffffULL

__device__ __forceinline__ unsigned long long sk_key(int r, int a, bool ins,
                                                     int er, int od, int pr,
                                                     int P) {
  bool is_map = pr >= 0;
  long long g_obj = a != AMT_PAD_ACTION ? (long long)od : (long long)P;
  int g_key = is_map ? pr : (ins ? r : er);
  unsigned low = (unsigned)g_key + 4u;
  unsigned long long high = (unsigned long long)(g_obj * 2 + (is_map ? 1 : 0));
  return (high << 32) | low;
}

// murmur3's 64-bit finaliser
__device__ __forceinline__ unsigned long long sk_hash(unsigned long long k) {
  k ^= k >> 33;
  k *= 0xff51afd7ed558ccdULL;
  k ^= k >> 33;
  k *= 0xc4ceb9fe1a85ec53ULL;
  k ^= k >> 33;
  return k;
}

// table keys [C] to SK_EMPTY, win/cnt [C] to -1 / 0, the stats [2, P+2]
// to 0
__global__ void sk_fill(int P, int C, unsigned long long* __restrict__ tkeys,
                        int* __restrict__ win, int* __restrict__ cnt,
                        int* __restrict__ stats) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < C) {
    tkeys[i] = SK_EMPTY;
    win[i] = -1;
    cnt[i] = 0;
  }
  if (i < 2LL * (P + 2)) stats[i] = 0;
}

__global__ void sk_insert(const int* __restrict__ action,
                          const bool* __restrict__ insert,
                          const int* __restrict__ elem_ref,
                          const int* __restrict__ obj_dense,
                          const int* __restrict__ prop,
                          const bool* __restrict__ visible, int P, int C,
                          unsigned long long* tkeys, int* __restrict__ slot,
                          int* __restrict__ win, int* __restrict__ cnt) {
  int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= P) return;
  unsigned long long key = sk_key(r, action[r], insert[r], elem_ref[r],
                                  obj_dense[r], prop[r], P);
  const volatile unsigned long long* seen = tkeys;
  unsigned mask = (unsigned)C - 1u;
  unsigned s = (unsigned)sk_hash(key) & mask;
  for (;;) {
    unsigned long long cur = seen[s];
    if (cur == SK_EMPTY) {
      cur = atomicCAS(&tkeys[s], SK_EMPTY, key);
      if (cur == SK_EMPTY) break;  // claimed
    }
    if (cur == key) break;
    s = (s + 1u) & mask;
  }
  slot[r] = (int)s;
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
  bool elem = false;
  int od = -1;
  unsigned wd = 0;
  if (r < P) {
    int s = slot[r];
    int w = win[s];
    winner[r] = w;
    conflicts[r] = cnt[s];
    od = obj_dense[r];
    // a visible element of object od (padding rows index P+1: dropped)
    elem = action[r] != AMT_PAD_ACTION && insert[r] && w >= 0 && od >= 0 &&
           od < P + 2;
    if (elem) wd = (unsigned)width[amt_clamp(w, P)];
  }
  // One atomic pair per object among the warp's visible elements: a text's
  // elements all belong to one object, and an atomic per row on its two
  // counters would queue on two addresses. The sums wrap as int32 adds do.
  unsigned peers = __match_any_sync(0xffffffffu, elem ? od : -1);
  unsigned sum = __reduce_add_sync(peers, wd);
  if (elem && (int)(threadIdx.x & 31) == __ffs(peers) - 1) {
    atomicAdd(&obj_vis_len[od], __popc(peers));
    atomicAdd(&obj_text_width[od], (int)sum);
  }
}

// tkeys: int64 [C] scratch, C a power of two >= 2 max(P, 1)
// (kernels/sort_winners.py table_capacity); win/cnt: int32 [C] and slot:
// int32 [P] scratch; winner/conflicts: int32 [P]; stats: int32 [2, P+2]
// (obj_vis_len, obj_text_width)
AMT_API int amt_sort_winners(const int* action, const bool* insert,
                             const int* elem_ref, const int* obj_dense,
                             const int* prop, const int* width,
                             const bool* visible, int P, int C,
                             unsigned long long* tkeys, int* win, int* cnt,
                             int* slot, int* winner, int* conflicts, int* stats,
                             cudaStream_t stream, int* launched) {
  if (P < 0 || P >= (1 << 29) || C < 2 * (P > 1 ? P : 1) || (C & (C - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  long long fill = C > 2LL * (P + 2) ? (long long)C : 2LL * (P + 2);
  sk_fill<<<amt_blocks(fill), AMT_THREADS, 0, stream>>>(P, C, tkeys, win, cnt,
                                                       stats);
  AMT_LAUNCHED;
  if (P == 0) return (int)cudaGetLastError();  // only the zeroed stats
  sk_insert<<<amt_blocks(P), AMT_THREADS, 0, stream>>>(
      action, insert, elem_ref, obj_dense, prop, visible, P, C, tkeys, slot,
      win, cnt);
  AMT_LAUNCHED;
  sk_gather<<<amt_blocks(P), AMT_THREADS, 0, stream>>>(
      action, insert, obj_dense, width, slot, P, win, cnt, winner, conflicts,
      stats, stats + (P + 2));
  AMT_LAUNCHED;
  return (int)cudaGetLastError();
}
