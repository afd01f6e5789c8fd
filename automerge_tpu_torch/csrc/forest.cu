// forest: the RGA sibling forest (is_elem, parent_row, first_child,
// next_sib) over node space N = 2P+3, around the radix sort of
// radix_sort.cu.
//
// Replaces automerge_tpu/ops/merge.py forest (:551-592). Node space:
// [0, P) element rows, [P, 2P+2) object roots (P + obj_dense), N-1 the
// sentinel (it takes the children whose reference is missing). Children
// of a node run in descending row (= descending Lamport) order. Only the
// element rows have siblings, and a record store has none (0 of 851,968
// rows at the record fan-in), so only they are sorted:
//   1. fo_links writes is_elem and parent_row for every row, and one
//      packed int64 key per element row, (parent << 32) | (P-1-row),
//      compacted: a block counts its elements by ballots, takes its
//      offset by one atomicAdd on the device-side count, and writes its
//      keys there. The blocks' order does not matter: the keys are
//      distinct (the row is in the low word) and then fully sorted.
//   2. the radix sort orders the count keys (a length read on the
//      device, so the host never waits for it; kernels/forest.py
//      sibling_digits names the digits the layout lets vary);
//   3. fo_finish (a grid of four blocks an SM striding over the count):
//      each sorted key links its row to the next key's row when that has
//      the same parent (next_sib), and the first key of a parent's run,
//      its largest child, is the parent's first_child.
// first_child and next_sib start at -1 by one memset of [2, N]: no fill
// kernels, no atomicMax.
//
// Bound: bytes. Inputs action, elem_ref, obj_dense (4P each), insert
// (1P) read once; is_elem (1P), parent_row (4P), first_child and
// next_sib (4N each) written once. The keys (8 bytes an element written,
// sorted, read back) and the sort's passes are what the design pays
// beyond that.
#include "common.cuh"

#define FO_WARPS (AMT_THREADS / 32)
#define FO_FINISH_BLOCKS (132 * 4)  // four blocks on each of the H100's SMs

__device__ __forceinline__ int fo_count(const int* n_elem, int P) {
  int n = *n_elem;
  return n < 0 ? 0 : (n < P ? n : P);
}

__global__ void __launch_bounds__(AMT_THREADS)
fo_links(const int* __restrict__ action, const bool* __restrict__ insert,
         const int* __restrict__ elem_ref, const int* __restrict__ obj_dense,
         int P, int N, bool* __restrict__ is_elem, int* __restrict__ parent_row,
         long long* __restrict__ keys, int* __restrict__ n_elem) {
  __shared__ int s_warp[FO_WARPS];
  __shared__ int s_base;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int r = blockIdx.x * blockDim.x + threadIdx.x;
  bool keyed = false;
  int pr = N - 1;
  if (r < P) {
    bool ie = insert[r] && action[r] != AMT_PAD_ACTION;
    if (ie) {
      int er = elem_ref[r];
      pr = er == AMT_ELEM_HEAD ? P + obj_dense[r] : (er >= 0 ? er : N - 1);
    }
    is_elem[r] = ie;
    parent_row[r] = pr;
    // a parent outside the node space is dropped, as XLA drops the scatter
    keyed = ie && pr >= 0 && pr < N;
  }
  unsigned ballot = __ballot_sync(0xffffffffu, keyed);
  if (lane == 0) s_warp[warp] = __popc(ballot);
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
#pragma unroll
    for (int w = 0; w < FO_WARPS; ++w) {
      int c = s_warp[w];
      s_warp[w] = total;
      total += c;
    }
    s_base = total ? atomicAdd(n_elem, total) : 0;
  }
  __syncthreads();
  if (keyed)
    keys[s_base + s_warp[warp] + __popc(ballot & ((1u << lane) - 1))] =
        ((long long)pr << 32) | (long long)(unsigned)(P - 1 - r);
}

__global__ void __launch_bounds__(AMT_THREADS)
fo_finish(const long long* __restrict__ sorted, int P, int N,
          const int* __restrict__ n_elem, int* __restrict__ first_child,
          int* __restrict__ next_sib) {
  const int n = fo_count(n_elem, P);
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    long long k = sorted[i];
    int sp = (int)(k >> 32);
    int row = P - 1 - (int)(k & 0xffffffffLL);
    if (i == 0 || (int)(sorted[i - 1] >> 32) != sp) first_child[sp] = row;
    if (i + 1 < n) {
      long long k2 = sorted[i + 1];
      if ((int)(k2 >> 32) == sp) next_sib[row] = P - 1 - (int)(k2 & 0xffffffffLL);
    }
  }
}

// Links pass: is_elem [P] bool and parent_row [P] for every row; the
// element rows' sibling keys into keys [0, *n_elem), n_elem a device int
// zeroed here; nodes [2, N] (first_child, next_sib) set to -1 here.
AMT_API int amt_forest_links(const int* action, const bool* insert,
                             const int* elem_ref, const int* obj_dense, int P,
                             bool* is_elem, int* parent_row, int* nodes,
                             long long* keys, int* n_elem,
                             cudaStream_t stream, int* launched) {
  if (P < 0) return (int)cudaErrorInvalidValue;
  long long N = 2LL * P + 3;
  cudaError_t e = cudaMemsetAsync(nodes, 0xff, 2 * N * sizeof(int), stream);
  if (e == cudaSuccess) e = cudaMemsetAsync(n_elem, 0, sizeof(int), stream);
  if (e != cudaSuccess) return (int)e;
  if (P == 0) return (int)cudaGetLastError();
  fo_links<<<amt_blocks(P), AMT_THREADS, 0, stream>>>(
      action, insert, elem_ref, obj_dense, P, (int)N, is_elem, parent_row,
      keys, n_elem);
  AMT_LAUNCHED;
  return (int)cudaGetLastError();
}

// Finish pass over the sorted keys [0, *n_elem) into nodes [2, N].
AMT_API int amt_forest_finish(const long long* sorted, int P, const int* n_elem,
                              int* nodes, cudaStream_t stream, int* launched) {
  if (P <= 0) return (int)cudaGetLastError();
  int N = 2 * P + 3;
  // the count is known only on the card: a grid of a few blocks an SM
  // strides over it, so that few blocks start only to find no key
  int blocks = amt_blocks(P) < FO_FINISH_BLOCKS ? amt_blocks(P) : FO_FINISH_BLOCKS;
  fo_finish<<<blocks, AMT_THREADS, 0, stream>>>(sorted, P, N, n_elem, nodes,
                                               nodes + N);
  AMT_LAUNCHED;
  return (int)cudaGetLastError();
}
