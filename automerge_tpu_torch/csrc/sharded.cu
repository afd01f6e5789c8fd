// The condensed arm of the sharded merge: its elementwise passes.
//
// Replaces the elementwise parts of automerge_tpu/parallel/sharding.py
// _sharded_linearize_condensed (:255-335). The host condenses the
// sibling forest's first-child chains into R chains (parallel/condense.py)
// padded to R2 slots, the last the sentinel chain SC = R2-1; both doubling
// loops then run over R2 slots with linearize.cu's range entries:
//   cond_init   (:283-285) the climb's start state per chain;
//   cond_succ   (:300-306) each chain's successor chain and length;
//   cond_expand (:320-334) element ranks of a row range from the chain
//               ranks and in-chain offsets.
// Gathers clamp, as XLA's do. int32 arithmetic wraps (uint32 here).
//
// Bound: bytes, each input read once and each output written once (the
// tables are gathered at data-dependent slots, counted once each).
//
// cond_expand is called once per device over all the rows that device's
// shards hold (the whole [0, P) on a mesh of one card), writing straight
// into the replicated result, one row a thread. cdist (R2 <= 524,288
// int32) and start_chain are gathers that sit in L2. (On an H100 at the
// text fan-in, four rows a thread with 16-byte loads measured 1.05-1.15x
// and a grid-stride loop over 8 blocks an SM 1.06x this kernel's device
// time, PERF.md §6.)
#include "common.cuh"

__global__ void cc_init(const int* __restrict__ centry,
                        const int* __restrict__ cpar, int R2,
                        int* __restrict__ ans, bool* __restrict__ done,
                        int* __restrict__ jump) {
  int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= R2) return;
  int ce = centry[c];
  int cp = cpar[c];
  // climb: first non-missing centry along the cpar chain, starting at the
  // chain itself; chains whose parent is a root end with -1
  done[c] = ce != -1 || cp == -1;
  ans[c] = ce;
  jump[c] = cp == -1 ? c : cp;
}

__global__ void cc_succ(const int* __restrict__ tail_ans,
                        const int* __restrict__ ans,
                        const int* __restrict__ chain_id,
                        const int* __restrict__ clen, int R2, int P,
                        int* __restrict__ cdist, int* __restrict__ cnxt) {
  int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= R2) return;
  int ta = tail_ans[c];
  // A(tail): the within-chain answer wins, else the resolved climb; A
  // targets are always chain heads
  int a = ta != -1 ? ta : ans[c];
  int sc = R2 - 1;
  cnxt[c] = c == sc ? sc : (a >= 0 ? chain_id[amt_clamp(a, P)] : sc);
  cdist[c] = clen[c];
}

// rank[k] for the rows r0 + k, k < count
__global__ void cc_expand(const int* __restrict__ chain_id,
                          const int* __restrict__ offset,
                          const int* __restrict__ obj_dense,
                          const bool* __restrict__ insert,
                          const int* __restrict__ action,
                          const int* __restrict__ start_chain, int n_objs2,
                          const int* __restrict__ cdist, int R2, int r0,
                          int count, int* __restrict__ rank) {
  int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= count) return;
  int r = r0 + k;
  int cid = chain_id[r];
  int start = start_chain[amt_clamp(obj_dense[r], n_objs2)];
  bool is_elem = insert[r] && action[r] != AMT_PAD_ACTION;
  unsigned dist = (unsigned)cdist[amt_clamp(cid, R2)] - (unsigned)offset[r];
  unsigned dstart = (unsigned)cdist[amt_clamp(start, R2)];
  rank[k] = (is_elem && cid >= 0 && start >= 0) ? (int)(dstart - dist) : -1;
}

// ans/jump: int32 [R2]; done: bool [R2]
AMT_API int amt_cond_init(const int* centry, const int* cpar, int R2,
                          int* ans, bool* done, int* jump,
                          cudaStream_t stream, int* launched) {
  if (R2 <= 0) return (int)cudaGetLastError();
  cc_init<<<amt_blocks(R2), AMT_THREADS, 0, stream>>>(centry, cpar, R2, ans,
                                                      done, jump);
  AMT_LAUNCHED;
  return (int)cudaGetLastError();
}

// cdist/cnxt: int32 [R2]; chain_id: int32 [P]
AMT_API int amt_cond_succ(const int* tail_ans, const int* ans,
                          const int* chain_id, const int* clen, int R2, int P,
                          int* cdist, int* cnxt, cudaStream_t stream,
                          int* launched) {
  if (R2 <= 0) return (int)cudaGetLastError();
  cc_succ<<<amt_blocks(R2), AMT_THREADS, 0, stream>>>(tail_ans, ans, chain_id,
                                                      clen, R2, P, cdist, cnxt);
  AMT_LAUNCHED;
  return (int)cudaGetLastError();
}

// rank: int32 [count], the rows [r0, r0+count)
AMT_API int amt_cond_expand(const int* chain_id, const int* offset,
                            const int* obj_dense, const bool* insert,
                            const int* action, const int* start_chain,
                            int n_objs2, const int* cdist, int R2, int r0,
                            int count, int* rank, cudaStream_t stream,
                            int* launched) {
  if (count <= 0) return (int)cudaGetLastError();
  cc_expand<<<amt_blocks(count), AMT_THREADS, 0, stream>>>(
      chain_id, offset, obj_dense, insert, action, start_chain, n_objs2, cdist,
      R2, r0, count, rank);
  AMT_LAUNCHED;
  return (int)cudaGetLastError();
}
