// linearize: document-order element indices, all on the device.
//
// Replaces automerge_tpu/ops/merge.py device_linearize (:216-285). The
// loops run in element space E = P+1 (rows plus the sentinel P):
//   1. sibling-climb threading (_thread): A(i), the next sibling of i or
//      of its nearest ancestor, by pointer doubling over the parent chain;
//   2. Wyllie list ranking (_rank) of the preorder successor chain
//      (first child, else A(i)), giving each node's distance to the end;
// each for ceil_log2(E)+1 rounds, one launch per round. Every round
// reads only the previous round's state (the reference's loop body is
// a pure function of it), so the state lives in ping-pong buffers: an
// in-place `jump = jump[jump]` would race, and give wrong ranks that
// show only now and then. elem_index = dist[object start] - dist[row].
//
// Bound: bytes. first_child and next_sib over the rows [0, P) (4P each),
// elem_ref, obj_dense (4P each), is_elem (1P) and first_child at the
// object roots the elements reach are read once, elem_index (4P) written
// once; the root and sentinel slots [P, N) are otherwise never read. The 2*(ceil_log2(E)+1) rounds of gathers along
// near-random chains are what the simple design pays beyond that.
#include "common.cuh"

__global__ void li_init(const int* __restrict__ first_child,
                        const int* __restrict__ next_sib,
                        const bool* __restrict__ is_elem,
                        const int* __restrict__ elem_ref, int P, int Epad,
                        int* __restrict__ ans, bool* __restrict__ done,
                        int* __restrict__ jump, int* __restrict__ fc_e) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= Epad) return;
  if (i > P) {  // padding past the sentinel: a fixed point of the loops
    ans[i] = -1;
    done[i] = true;
    jump[i] = P;
    fc_e[i] = -1;
    return;
  }
  int ns = -1, fc = -1, pe = P;
  bool ie = false;
  if (i < P) {
    ns = next_sib[i];
    fc = first_child[i];
    if (fc > P) fc = -1;  // child refs are always < P
    ie = is_elem[i];
    int er = elem_ref[i];
    if (ie && er >= 0) pe = er;
  }
  bool has_sib = ns != -1;
  done[i] = has_sib || !ie || pe == P;
  ans[i] = (has_sib && ie) ? ns : -1;
  jump[i] = pe;
  fc_e[i] = fc;
}

// one round over the nodes [i0, i0+count) of the E-node state; the
// outputs are written from index 0
__global__ void li_thread(const int* __restrict__ ans0,
                          const bool* __restrict__ done0,
                          const int* __restrict__ jump0, int E, int i0,
                          int count, int* __restrict__ ans1,
                          bool* __restrict__ done1, int* __restrict__ jump1) {
  int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= count) return;
  int i = i0 + k;
  int j = amt_clamp(jump0[i], E);
  bool d = done0[i];
  bool take = !d && done0[j];
  ans1[k] = take ? ans0[j] : ans0[i];
  done1[k] = d || take;
  jump1[k] = jump0[j];
}

__global__ void li_rank_init(const int* __restrict__ fc_e,
                             const int* __restrict__ ans, int P, int Epad,
                             int* __restrict__ dist, int* __restrict__ nxt) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= Epad) return;
  if (i > P) {  // padding: dist 0, nxt the sentinel
    nxt[i] = P;
    dist[i] = 0;
    return;
  }
  int s = fc_e[i] != -1 ? fc_e[i] : ans[i];
  nxt[i] = (s < 0 || i == P) ? P : s;
  dist[i] = i == P ? 0 : 1;
}

__global__ void li_rank(const int* __restrict__ dist0,
                        const int* __restrict__ nxt0, int E, int i0,
                        int count, int* __restrict__ dist1,
                        int* __restrict__ nxt1) {
  int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= count) return;
  int i = i0 + k;
  int j = amt_clamp(nxt0[i], E);
  dist1[k] = (int)((unsigned)dist0[i] + (unsigned)dist0[j]);
  nxt1[k] = nxt0[j];
}

__global__ void li_final(const int* __restrict__ first_child,
                         const bool* __restrict__ is_elem,
                         const int* __restrict__ obj_dense,
                         const int* __restrict__ dist, int P, int r0,
                         int count, int* __restrict__ elem_index) {
  int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= count) return;
  int r = r0 + k;
  int N = 2 * P + 3;
  // chain start per row: its object root's first child
  int start = first_child[amt_clamp(P + obj_dense[r], N)];
  elem_index[k] = (is_elem[r] && start >= 0)
                      ? dist[amt_clamp(start, P)] - dist[r]
                      : -1;
}

// first_child/next_sib: int32 [N = 2P+3]; scratch: int32 [7, E] (ans x2,
// jump x2, dist x2, fc_e; nxt reuses the jump buffers) and bool [2, E]
// (done x2), E = P+1; elem_index: int32 [P]. rounds = ceil_log2(E) + 1.
AMT_API int amt_linearize(const int* first_child, const int* next_sib,
                          const bool* is_elem, const int* elem_ref,
                          const int* obj_dense, int P, int rounds,
                          int* scratch, bool* done_buf, int* elem_index,
                          cudaStream_t stream, int* launched) {
  if (P <= 0) return (int)cudaGetLastError();
  int E = P + 1;
  int* ans[2] = {scratch, scratch + E};
  int* jump[2] = {scratch + 2 * (long long)E, scratch + 3 * (long long)E};
  int* dist[2] = {scratch + 4 * (long long)E, scratch + 5 * (long long)E};
  int* fc_e = scratch + 6 * (long long)E;
  bool* done[2] = {done_buf, done_buf + E};
  int blocks = amt_blocks(E);
  li_init<<<blocks, AMT_THREADS, 0, stream>>>(first_child, next_sib, is_elem,
                                              elem_ref, P, E, ans[0], done[0],
                                              jump[0], fc_e);
  AMT_LAUNCHED;
  int cur = 0;
  for (int t = 0; t < rounds; ++t, cur ^= 1) {
    li_thread<<<blocks, AMT_THREADS, 0, stream>>>(
        ans[cur], done[cur], jump[cur], E, 0, E, ans[cur ^ 1], done[cur ^ 1],
        jump[cur ^ 1]);
    AMT_LAUNCHED;
  }
  // the threading answers are final; the jump buffers now carry nxt
  int* a = ans[cur];
  int* nxt[2] = {jump[0], jump[1]};
  li_rank_init<<<blocks, AMT_THREADS, 0, stream>>>(fc_e, a, P, E, dist[0],
                                                   nxt[0]);
  AMT_LAUNCHED;
  cur = 0;
  for (int t = 0; t < rounds; ++t, cur ^= 1) {
    li_rank<<<blocks, AMT_THREADS, 0, stream>>>(dist[cur], nxt[cur], E, 0, E,
                                                dist[cur ^ 1], nxt[cur ^ 1]);
    AMT_LAUNCHED;
  }
  li_final<<<amt_blocks(P), AMT_THREADS, 0, stream>>>(
      first_child, is_elem, obj_dense, dist[cur], P, 0, P, elem_index);
  AMT_LAUNCHED;
  return (int)cudaGetLastError();
}

// -- the sharded merge's range entries ----------------------------------------
//
// automerge_tpu/parallel/sharding.py runs both doubling loops with each
// shard advancing its slice of the state and an all_gather re-replicating
// it between rounds (_sharded_linearize :166-252 over the E-padded node
// space, _sharded_linearize_condensed :287-317 over the R2 chain tables).
// Each entry reads the full gathered state and writes one slice.

// ans/jump/fc_e: int32 [Epad]; done: bool [Epad]; Epad >= P + 1, the
// nodes past the sentinel P fixed points (done, jump = P, dist 0, nxt P)
AMT_API int amt_linearize_init(const int* first_child, const int* next_sib,
                               const bool* is_elem, const int* elem_ref,
                               int P, int Epad, int* ans, bool* done,
                               int* jump, int* fc_e, cudaStream_t stream,
                               int* launched) {
  if (Epad <= 0) return (int)cudaGetLastError();
  li_init<<<amt_blocks(Epad), AMT_THREADS, 0, stream>>>(
      first_child, next_sib, is_elem, elem_ref, P, Epad, ans, done, jump, fc_e);
  AMT_LAUNCHED;
  return (int)cudaGetLastError();
}

// one threading round over the nodes [i0, i0+count) of the E-node state
AMT_API int amt_linearize_thread(const int* ans0, const bool* done0,
                                 const int* jump0, int E, int i0, int count,
                                 int* ans1, bool* done1, int* jump1,
                                 cudaStream_t stream, int* launched) {
  if (count <= 0) return (int)cudaGetLastError();
  li_thread<<<amt_blocks(count), AMT_THREADS, 0, stream>>>(
      ans0, done0, jump0, E, i0, count, ans1, done1, jump1);
  AMT_LAUNCHED;
  return (int)cudaGetLastError();
}

// dist/nxt: int32 [Epad] from the threaded answers ans [Epad]
AMT_API int amt_linearize_rank_init(const int* fc_e, const int* ans, int P,
                                    int Epad, int* dist, int* nxt,
                                    cudaStream_t stream, int* launched) {
  if (Epad <= 0) return (int)cudaGetLastError();
  li_rank_init<<<amt_blocks(Epad), AMT_THREADS, 0, stream>>>(fc_e, ans, P,
                                                             Epad, dist, nxt);
  AMT_LAUNCHED;
  return (int)cudaGetLastError();
}

// one ranking round over the nodes [i0, i0+count) of the E-node state
AMT_API int amt_linearize_rank(const int* dist0, const int* nxt0, int E,
                               int i0, int count, int* dist1, int* nxt1,
                               cudaStream_t stream, int* launched) {
  if (count <= 0) return (int)cudaGetLastError();
  li_rank<<<amt_blocks(count), AMT_THREADS, 0, stream>>>(dist0, nxt0, E, i0,
                                                         count, dist1, nxt1);
  AMT_LAUNCHED;
  return (int)cudaGetLastError();
}

// elem_index of the rows [r0, r0+count): int32 [count]
AMT_API int amt_linearize_final(const int* first_child, const bool* is_elem,
                                const int* obj_dense, const int* dist, int P,
                                int r0, int count, int* elem_index,
                                cudaStream_t stream, int* launched) {
  if (count <= 0) return (int)cudaGetLastError();
  li_final<<<amt_blocks(count), AMT_THREADS, 0, stream>>>(
      first_child, is_elem, obj_dense, dist, P, r0, count, elem_index);
  AMT_LAUNCHED;
  return (int)cudaGetLastError();
}
