// forest: the RGA sibling forest (is_elem, parent_row, first_child,
// next_sib) over node space N = 2P+3, around the radix sort of
// radix_sort.cu.
//
// Replaces automerge_tpu/ops/merge.py forest (:551-592). Node space:
// [0, P) element rows, [P, 2P+2) object roots (P + obj_dense), N-1 the
// sentinel. Children of a node run in descending row (= descending
// Lamport) order, so first_child is an atomicMax of child rows. next_sib
// needs the siblings in (parent ascending, row descending) order: the
// links pass writes one packed int64 key per row,
// (sib_parent << 32) | (P-1-row), non-elements taking sib_parent = N so
// they sort last; the radix sort orders the keys (stably, over the
// digits the layout lets vary: kernels/forest.py sibling_digits); one
// pass over adjacent sorted keys then links each row to the next row
// with the same parent.
//
// Bound: bytes. Inputs action, elem_ref, obj_dense (4P each), insert
// (1P) read once; is_elem (1P), parent_row (4P), first_child and
// next_sib (4N each) written once. The keys (8P written, sorted, read
// back) and the sort's passes are what the design pays beyond that.
#include "common.cuh"

__global__ void fo_links(const int* __restrict__ action,
                         const bool* __restrict__ insert,
                         const int* __restrict__ elem_ref,
                         const int* __restrict__ obj_dense, int P, int N,
                         bool* __restrict__ is_elem,
                         int* __restrict__ parent_row,
                         int* __restrict__ first_child,
                         long long* __restrict__ keys) {
  int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= P) return;
  bool ie = insert[r] && action[r] != AMT_PAD_ACTION;
  int er = elem_ref[r];
  int S = N - 1;
  int pr = S;
  if (ie) pr = er == AMT_ELEM_HEAD ? P + obj_dense[r] : (er >= 0 ? er : S);
  is_elem[r] = ie;
  parent_row[r] = pr;
  if (ie && pr >= 0 && pr < N) atomicMax(&first_child[pr], r);
  long long sp = ie ? (long long)pr : (long long)N;
  keys[r] = (sp << 32) | (long long)(unsigned)(P - 1 - r);
}

__global__ void fo_next_sib(const long long* __restrict__ sorted, int P, int N,
                            int* __restrict__ next_sib) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= P) return;
  long long k = sorted[i];
  long long sp = k >> 32;
  if (sp >= N) return;  // non-elements: the reference writes -1 to N-1
  int row = P - 1 - (int)(k & 0xffffffffLL);
  int nxt = -1;
  if (i + 1 < P) {
    long long k2 = sorted[i + 1];
    if ((k2 >> 32) == sp) nxt = P - 1 - (int)(k2 & 0xffffffffLL);
  }
  next_sib[row] = nxt;
}

// Links pass: is_elem [P] bool, parent_row [P], first_child [N] and the
// sibling keys [P] int64; next_sib [N] is filled with -1 for the
// next-sibling pass.
AMT_API int amt_forest_links(const int* action, const bool* insert,
                             const int* elem_ref, const int* obj_dense, int P,
                             bool* is_elem, int* parent_row, int* first_child,
                             int* next_sib, long long* keys,
                             cudaStream_t stream, int* launched) {
  if (P <= 0) return (int)cudaGetLastError();
  long long N = 2LL * P + 3;
  amt_fill_i32<<<amt_blocks(N), AMT_THREADS, 0, stream>>>(first_child, -1, N);
  AMT_LAUNCHED;
  amt_fill_i32<<<amt_blocks(N), AMT_THREADS, 0, stream>>>(next_sib, -1, N);
  AMT_LAUNCHED;
  fo_links<<<amt_blocks(P), AMT_THREADS, 0, stream>>>(
      action, insert, elem_ref, obj_dense, P, (int)N, is_elem, parent_row,
      first_child, keys);
  AMT_LAUNCHED;
  return (int)cudaGetLastError();
}

// Next-sibling pass over the sorted keys [P].
AMT_API int amt_forest_next_sib(const long long* sorted, int P, int* next_sib,
                                cudaStream_t stream, int* launched) {
  if (P <= 0) return (int)cudaGetLastError();
  fo_next_sib<<<amt_blocks(P), AMT_THREADS, 0, stream>>>(sorted, P, 2 * P + 3,
                                                        next_sib);
  AMT_LAUNCHED;
  return (int)cudaGetLastError();
}
