// mesh_reduce: the reduction of the sharded merge's collectives.
//
// Replaces the arithmetic of jax.lax.psum / jax.lax.pmax in
// automerge_tpu/parallel/sharding.py (:139, :154-162, :341-342 psum;
// :138 pmax). The port's collectives (automerge_tpu_torch/parallel/
// collectives.py) copy each shard's partial table into one [n, L] stack
// on every distinct device of the mesh; this kernel folds the stack's n
// rows into one row of L: a sum with int32 wraparound (uint32 adds, as
// XLA's int32 psum wraps), or a max. One thread per column, the n rows
// read in order, so the result is exact.
//
// Bound: bytes. The stack (4nL) read once, the row (4L) written once.
#include "common.cuh"

template <bool kMax>
__global__ void mr_fold(const int* __restrict__ stack, int n, long long L,
                        int* __restrict__ out) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= L) return;
  if (kMax) {
    int m = stack[i];
    for (int s = 1; s < n; ++s) m = max(m, stack[s * L + i]);
    out[i] = m;
  } else {
    unsigned acc = 0u;
    for (int s = 0; s < n; ++s) acc += (unsigned)stack[s * L + i];
    out[i] = (int)acc;
  }
}

// stack: int32 [n, L]; out: int32 [L]; op: 0 sum, 1 max
AMT_API int amt_mesh_reduce(const int* stack, int n, long long L, int op,
                            int* out, cudaStream_t stream, int* launched) {
  if (n <= 0 || L <= 0) return (int)cudaGetLastError();
  if (op == 1)
    mr_fold<true><<<amt_blocks(L), AMT_THREADS, 0, stream>>>(stack, n, L, out);
  else
    mr_fold<false><<<amt_blocks(L), AMT_THREADS, 0, stream>>>(stack, n, L, out);
  AMT_LAUNCHED;
  return (int)cudaGetLastError();
}
