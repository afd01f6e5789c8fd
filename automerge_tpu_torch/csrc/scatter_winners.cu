// scatter_winners: per-key winners, conflict counts and per-object stats.
//
// Replaces automerge_tpu/ops/merge.py resolve_state_scatter (:595-648),
// minus its forest call (forest.cu). Each row maps to a dense group id:
// a sequence op to its run-head row (the insert row itself, or the
// element it targets), HEAD/missing sentinels per object, a map op to a
// slot of a dense obj x prop table; G = P + 2*n_objs2 + n_objs2*n_props
// + 1, the last slot taking padding rows. Visible rows atomicMax their
// row id and atomicAdd 1 into the G table (initialised -1 / 0); a second
// pass gathers winner/conflicts back to every row and atomicAdds the
// visible elements' count and winner width into the per-object stats
// [P+2]. Max and add commute, so the result is exact whatever the order
// of the atomics.
//
// Bound: bytes. Inputs action, elem_ref, obj_dense, prop (4P each),
// insert and visible (1P each) are read once, width only at the winners
// of visible elements; winner, conflicts
// (4P each) and the two stats arrays (4(P+2) each) written once. The
// G-slot tables are scratch.
#include "common.cuh"

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

__global__ void sw_scatter(const int* __restrict__ action,
                           const bool* __restrict__ insert,
                           const int* __restrict__ elem_ref,
                           const int* __restrict__ obj_dense,
                           const int* __restrict__ prop,
                           const bool* __restrict__ visible, int P, int r0,
                           int count, int G, int n_objs2, int n_props,
                           int* __restrict__ win, int* __restrict__ cnt) {
  int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= count) return;
  int r = r0 + k;
  if (!visible[r]) return;  // invisible rows add max(-1) / +0
  int g = sw_gid(r, action[r], insert[r], elem_ref[r], obj_dense[r], prop[r],
                 P, G, n_objs2, n_props);
  if (g < 0 || g >= G) return;
  atomicMax(&win[g], r);
  atomicAdd(&cnt[g], 1);
}

__global__ void sw_gather(const int* __restrict__ action,
                          const bool* __restrict__ insert,
                          const int* __restrict__ elem_ref,
                          const int* __restrict__ obj_dense,
                          const int* __restrict__ prop,
                          const int* __restrict__ width, int P, int r0,
                          int count, int G, int n_objs2, int n_props,
                          const int* __restrict__ win,
                          const int* __restrict__ cnt,
                          int* __restrict__ winner, int* __restrict__ conflicts,
                          int* __restrict__ obj_vis_len,
                          int* __restrict__ obj_text_width) {
  int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= count) return;
  int r = r0 + k;
  int a = action[r];
  bool valid = a != AMT_PAD_ACTION;
  bool ins = insert[r];
  int od = obj_dense[r];
  int g = amt_clamp(
      sw_gid(r, a, ins, elem_ref[r], od, prop[r], P, G, n_objs2, n_props), G);
  int w = valid ? win[g] : -1;
  winner[k] = w;
  conflicts[k] = valid ? cnt[g] : 0;
  if (valid && ins && w >= 0) {  // a visible element of object od
    if (od >= 0 && od < P + 2) {
      atomicAdd(&obj_vis_len[od], 1);
      atomicAdd(&obj_text_width[od], width[amt_clamp(w, P)]);
    }
  }
}

// win/cnt: int32 [G] scratch; winner/conflicts: int32 [P];
// stats: int32 [2, P+2] (obj_vis_len, obj_text_width)
AMT_API int amt_scatter_winners(const int* action, const bool* insert,
                                const int* elem_ref, const int* obj_dense,
                                const int* prop, const int* width,
                                const bool* visible, int P, int n_objs2,
                                int n_props, int G, int* win, int* cnt,
                                int* winner, int* conflicts, int* stats,
                                cudaStream_t stream, int* launched) {
  if (P <= 0) return (int)cudaGetLastError();
  amt_fill_i32<<<amt_blocks(G), AMT_THREADS, 0, stream>>>(win, -1, G);
  AMT_LAUNCHED;
  amt_fill_i32<<<amt_blocks(G), AMT_THREADS, 0, stream>>>(cnt, 0, G);
  AMT_LAUNCHED;
  long long ns = 2LL * (P + 2);
  amt_fill_i32<<<amt_blocks(ns), AMT_THREADS, 0, stream>>>(stats, 0, ns);
  AMT_LAUNCHED;
  sw_scatter<<<amt_blocks(P), AMT_THREADS, 0, stream>>>(
      action, insert, elem_ref, obj_dense, prop, visible, P, 0, P, G, n_objs2,
      n_props, win, cnt);
  AMT_LAUNCHED;
  sw_gather<<<amt_blocks(P), AMT_THREADS, 0, stream>>>(
      action, insert, elem_ref, obj_dense, prop, width, P, 0, P, G, n_objs2,
      n_props, win, cnt, winner, conflicts, stats, stats + (P + 2));
  AMT_LAUNCHED;
  return (int)cudaGetLastError();
}

// The sharded merge's row-range halves (automerge_tpu/parallel/sharding.py
// _sharded_winners, :99-163): each shard scatters the rows [r0, r0+count)
// of the full columns into its own win/cnt tables (G slots, group ids and
// rows global), the collectives max the shards' win tables and sum their
// cnt tables, then each shard gathers winner/conflicts for its rows
// (written from index 0) and its partial per-object stats [2, P+2].
AMT_API int amt_winners_partial(const int* action, const bool* insert,
                                const int* elem_ref, const int* obj_dense,
                                const int* prop, const bool* visible, int P,
                                int r0, int count, int n_objs2, int n_props,
                                int G, int* win, int* cnt,
                                cudaStream_t stream, int* launched) {
  if (G <= 0) return (int)cudaGetLastError();
  amt_fill_i32<<<amt_blocks(G), AMT_THREADS, 0, stream>>>(win, -1, G);
  AMT_LAUNCHED;
  amt_fill_i32<<<amt_blocks(G), AMT_THREADS, 0, stream>>>(cnt, 0, G);
  AMT_LAUNCHED;
  if (count > 0) {
    sw_scatter<<<amt_blocks(count), AMT_THREADS, 0, stream>>>(
        action, insert, elem_ref, obj_dense, prop, visible, P, r0, count, G,
        n_objs2, n_props, win, cnt);
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
  long long ns = 2LL * (P + 2);
  amt_fill_i32<<<amt_blocks(ns), AMT_THREADS, 0, stream>>>(stats, 0, ns);
  AMT_LAUNCHED;
  if (count > 0) {
    sw_gather<<<amt_blocks(count), AMT_THREADS, 0, stream>>>(
        action, insert, elem_ref, obj_dense, prop, width, P, r0, count, G,
        n_objs2, n_props, win, cnt, winner, conflicts, stats, stats + (P + 2));
    AMT_LAUNCHED;
  }
  return (int)cudaGetLastError();
}
