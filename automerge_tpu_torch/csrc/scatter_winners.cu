// scatter_winners: per-key winners, conflict counts and per-object stats.
//
// Replaces automerge_tpu/ops/merge.py resolve_state_scatter (:595-648),
// minus its forest call (forest.cu). Each row maps to a dense group id:
// a sequence op to its run-head row (the insert row itself, or the
// element it targets), HEAD/missing sentinels per object, a map op to a
// slot of a dense obj x prop table; G = P + 2*n_objs2 + n_objs2*n_props
// + 1, the last slot taking padding rows. Two launches:
//   1. sw_scatter: visible rows atomicMax their row id into win[g] and
//      add 1 into cnt[g]. Where a warp's visible rows all share one group
//      (one map key put by many replicas), its highest such lane holds
//      the largest row and adds their count: one atomic pair a warp, not
//      one a row. The test is a min and a max over the warp (redux): at
//      the text fan-in, whose run heads are distinct, grouping every warp
//      by __match_any_sync instead cost 6.5 µs against 4.2 for per-row
//      atomics (NVIDIA H100 80GB HBM3, 700 W,
//      scripts/profile_winners_forest_torch.py as of commit 0c01cf5).
//   2. sw_gather: every row reads winner/conflicts back from its group,
//      and the visible elements' count and winners' widths are summed per
//      object. A text's elements all belong to one object, so an atomic
//      per element would queue on two addresses (761k at the text
//      fan-in, about one an L2 clock). The block first reduces: when all
//      of its contributing rows share one object (a block's min and max
//      object agree), one atomic pair a block; otherwise one pair per
//      (warp, object), by __match_any_sync and __reduce_add_sync.
// Integer max and add commute, and adds wrap as int32 adds do, so the
// result is exact whatever the order of the atomics.
//
// The table slots and the stats are set by one cudaMemsetAsync, not fill
// kernels: win holds row + off, with off = 1 for the fused entry point
// (zero then means no visible row, and one zero memset covers win, cnt
// and the stats) and off = 0 for the sharded row-range halves, whose win
// tables the collectives max as they are (-1 for none, memset 0xff).
//
// Bound: bytes. Inputs action, elem_ref, obj_dense, prop (4P each),
// insert and visible (1P each) are read once, width only at the winners
// of visible elements; winner, conflicts (4P each) and the two stats
// arrays (4(P+2) each) written once. The G-slot tables are scratch.
#include "common.cuh"

#define SW_FULL 0xffffffffu
#define SW_WARPS (AMT_THREADS / 32)

__device__ __forceinline__ int sw_gid(int r, int a, bool ins, int er, int od,
                                      int pr, int P, int G, int n_objs2,
                                      int n_props) {
  if (a == AMT_PAD_ACTION) return G - 1;
  // int32 arithmetic with wraparound, as XLA evaluates it
  if (pr >= 0)
    return (int)((unsigned)P + 2u * (unsigned)n_objs2 +
                 (unsigned)od * (unsigned)n_props + (unsigned)pr);
  int run = ins ? r : er;
  if (run >= 0) return run;
  return (int)((unsigned)P + (unsigned)od * 2u + (er == AMT_ELEM_HEAD ? 0u : 1u));
}

// rows [r0, r0 + count) into win (row + off) and cnt; win and cnt set
// beforehand to off - 1 and 0
__global__ void __launch_bounds__(AMT_THREADS)
sw_scatter(const int* __restrict__ action, const bool* __restrict__ insert,
           const int* __restrict__ elem_ref, const int* __restrict__ obj_dense,
           const int* __restrict__ prop, const bool* __restrict__ visible,
           int P, int r0, int count, int G, int n_objs2, int n_props, int off,
           int* __restrict__ win, int* __restrict__ cnt) {
  int k = blockIdx.x * blockDim.x + threadIdx.x;
  int r = r0 + k;
  int g = -1;  // invisible rows add max(-1) / +0: no group
  if (k < count && visible[r]) {
    g = sw_gid(r, action[r], insert[r], elem_ref[r], obj_dense[r], prop[r], P,
               G, n_objs2, n_props);
    if (g >= G) g = -1;  // dropped, as XLA drops a scatter out of range
  }
  int lo = __reduce_min_sync(SW_FULL, g >= 0 ? g : 0x7fffffff);
  int hi = __reduce_max_sync(SW_FULL, g);
  if (lo != hi) {  // several groups: an atomic pair a visible row
    if (g >= 0) {
      atomicMax(&win[g], r + off);
      atomicAdd(&cnt[g], 1);
    }
    return;
  }
  // one group (or none: hi < 0); lanes hold ascending rows, so the
  // highest visible lane holds the group's largest row
  unsigned peers = __ballot_sync(SW_FULL, g >= 0);
  if (g >= 0 && (int)(threadIdx.x & 31) == 31 - __clz(peers)) {
    atomicMax(&win[g], r + off);
    atomicAdd(&cnt[g], __popc(peers));
  }
}

__global__ void __launch_bounds__(AMT_THREADS)
sw_gather(const int* __restrict__ action, const bool* __restrict__ insert,
          const int* __restrict__ elem_ref, const int* __restrict__ obj_dense,
          const int* __restrict__ prop, const int* __restrict__ width, int P,
          int r0, int count, int G, int n_objs2, int n_props, int off,
          const int* __restrict__ win, const int* __restrict__ cnt,
          int* __restrict__ winner, int* __restrict__ conflicts,
          int* __restrict__ obj_vis_len, int* __restrict__ obj_text_width) {
  __shared__ int s_min[SW_WARPS], s_max[SW_WARPS];
  __shared__ unsigned s_len[SW_WARPS], s_width[SW_WARPS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int k = blockIdx.x * blockDim.x + threadIdx.x;
  int od = -1;  // the object a visible element adds to, else -1
  unsigned wd = 0;
  if (k < count) {
    int r = r0 + k;
    int a = action[r];
    bool valid = a != AMT_PAD_ACTION;
    bool ins = insert[r];
    int o = obj_dense[r];
    int g = amt_clamp(
        sw_gid(r, a, ins, elem_ref[r], o, prop[r], P, G, n_objs2, n_props), G);
    int w = valid ? win[g] - off : -1;
    winner[k] = w;
    conflicts[k] = valid ? cnt[g] : 0;
    // a visible element of object o (padding rows index P+1: dropped)
    if (valid && ins && w >= 0 && o >= 0 && o < P + 2) {
      od = o;
      wd = (unsigned)width[amt_clamp(w, P)];
    }
  }
  // the warp's range of objects and its sums, then the block's
  int lo = __reduce_min_sync(SW_FULL, od >= 0 ? od : 0x7fffffff);
  int hi = __reduce_max_sync(SW_FULL, od);
  unsigned len = __reduce_add_sync(SW_FULL, od >= 0 ? 1u : 0u);
  unsigned sum = __reduce_add_sync(SW_FULL, wd);
  if (lane == 0) {
    s_min[warp] = lo;
    s_max[warp] = hi;
    s_len[warp] = len;
    s_width[warp] = sum;
  }
  __syncthreads();
  int blo = s_min[0], bhi = s_max[0];
#pragma unroll
  for (int w = 1; w < SW_WARPS; ++w) {
    blo = min(blo, s_min[w]);
    bhi = max(bhi, s_max[w]);
  }
  if (bhi < 0) return;  // no visible element in the block
  if (blo == bhi) {     // one object: one atomic pair for the block
    if (threadIdx.x == 0) {
      unsigned bl = 0, bw = 0;
#pragma unroll
      for (int w = 0; w < SW_WARPS; ++w) {
        bl += s_len[w];
        bw += s_width[w];
      }
      atomicAdd(&obj_vis_len[bhi], (int)bl);
      atomicAdd(&obj_text_width[bhi], (int)bw);
    }
    return;
  }
  if (hi < 0) return;  // this warp adds nothing
  if (lo == hi) {      // one object in this warp
    if (lane == 0) {
      atomicAdd(&obj_vis_len[hi], (int)len);
      atomicAdd(&obj_text_width[hi], (int)sum);
    }
    return;
  }
  unsigned peers = __match_any_sync(SW_FULL, od);
  unsigned psum = __reduce_add_sync(peers, wd);
  if (od >= 0 && lane == __ffs(peers) - 1) {
    atomicAdd(&obj_vis_len[od], __popc(peers));
    atomicAdd(&obj_text_width[od], (int)psum);
  }
}

// buf: int32 [2G + 2(P+2) + 2P]: win [G] (row + 1, 0 for none), cnt [G],
// the stats [2, P+2] (obj_vis_len, obj_text_width), then the outputs
// winner [P] and conflicts [P]. The first 2G + 2(P+2) words are zeroed
// here, in one memset.
AMT_API int amt_scatter_winners(const int* action, const bool* insert,
                                const int* elem_ref, const int* obj_dense,
                                const int* prop, const int* width,
                                const bool* visible, int P, int n_objs2,
                                int n_props, int G, int* buf,
                                cudaStream_t stream, int* launched) {
  if (P < 0 || G < 1) return (int)cudaErrorInvalidValue;
  int* win = buf;
  int* cnt = buf + G;
  int* stats = cnt + G;
  int* winner = stats + 2 * (P + 2);
  int* conflicts = winner + P;
  cudaError_t e = cudaMemsetAsync(
      buf, 0, (2LL * G + 2LL * (P + 2)) * sizeof(int), stream);
  if (e != cudaSuccess) return (int)e;
  if (P == 0) return (int)cudaGetLastError();  // only the zeroed stats
  sw_scatter<<<amt_blocks(P), AMT_THREADS, 0, stream>>>(
      action, insert, elem_ref, obj_dense, prop, visible, P, 0, P, G, n_objs2,
      n_props, 1, win, cnt);
  AMT_LAUNCHED;
  sw_gather<<<amt_blocks(P), AMT_THREADS, 0, stream>>>(
      action, insert, elem_ref, obj_dense, prop, width, P, 0, P, G, n_objs2,
      n_props, 1, win, cnt, winner, conflicts, stats, stats + (P + 2));
  AMT_LAUNCHED;
  return (int)cudaGetLastError();
}

// The sharded merge's row-range halves (automerge_tpu/parallel/sharding.py
// _sharded_winners, :99-163): each shard scatters the rows [r0, r0+count)
// of the full columns into its own win/cnt tables (G slots, group ids and
// rows global; win -1 for none), the collectives max the shards' win
// tables and sum their cnt tables, then each shard gathers winner/conflicts
// for its rows (written from index 0) and its partial per-object stats
// [2, P+2].
AMT_API int amt_winners_partial(const int* action, const bool* insert,
                                const int* elem_ref, const int* obj_dense,
                                const int* prop, const bool* visible, int P,
                                int r0, int count, int n_objs2, int n_props,
                                int G, int* win, int* cnt,
                                cudaStream_t stream, int* launched) {
  if (G <= 0) return (int)cudaGetLastError();
  cudaError_t e = cudaMemsetAsync(win, 0xff, (size_t)G * sizeof(int), stream);
  if (e == cudaSuccess)
    e = cudaMemsetAsync(cnt, 0, (size_t)G * sizeof(int), stream);
  if (e != cudaSuccess) return (int)e;
  if (count > 0) {
    sw_scatter<<<amt_blocks(count), AMT_THREADS, 0, stream>>>(
        action, insert, elem_ref, obj_dense, prop, visible, P, r0, count, G,
        n_objs2, n_props, 0, win, cnt);
    AMT_LAUNCHED;
  }
  return (int)cudaGetLastError();
}

// winner/conflicts: int32 [count]; stats: int32 [2, P+2]
AMT_API int amt_winners_gather(const int* action, const bool* insert,
                               const int* elem_ref, const int* obj_dense,
                               const int* prop, const int* width, int P,
                               int r0, int count, int n_objs2, int n_props,
                               int G, const int* win, const int* cnt,
                               int* winner, int* conflicts, int* stats,
                               cudaStream_t stream, int* launched) {
  cudaError_t e = cudaMemsetAsync(stats, 0, 2LL * (P + 2) * sizeof(int), stream);
  if (e != cudaSuccess) return (int)e;
  if (count > 0) {
    sw_gather<<<amt_blocks(count), AMT_THREADS, 0, stream>>>(
        action, insert, elem_ref, obj_dense, prop, width, P, r0, count, G,
        n_objs2, n_props, 0, win, cnt, winner, conflicts, stats, stats + (P + 2));
    AMT_LAUNCHED;
  }
  return (int)cudaGetLastError();
}
