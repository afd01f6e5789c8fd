// mesh_reduce: the reduction of the sharded merge's collectives.
//
// Replaces the arithmetic of jax.lax.psum / jax.lax.pmax in
// automerge_tpu/parallel/sharding.py (:139, :154-162, :341-342 psum;
// :138 pmax). The port's collectives (automerge_tpu_torch/parallel/
// collectives.py) hand this kernel the n shards' partial tables where they
// lie on the card (only other cards' tables are copied in first); it folds
// them into one table of L values: a sum with int32 wraparound (uint32
// adds, as XLA's int32 psum wraps), or a signed max. Both are exact in any
// order.
//
// Bound: bytes. The n tables (4nL) read once, the result (4L) written
// once. The tables were just written by succ_partial / winners_partial and
// are dead after the fold.
//
// Design:
//  - the n pointers travel by value in the kernel's parameters (MrParts,
//    at most MR_CAP, the wrapper's CAP; past it the wrapper folds in
//    passes, groups of MR_CAP into partials): no pointer table
//    and no [n, L] stack on the card;
//  - four columns a thread, one 16-byte load from each table, all n loads
//    issued before the fold (the template's kN >= n bounds the registers),
//    one 16-byte store; a scalar path for the last L % 4 columns and for
//    tables or an output not 16-byte aligned (a winner table t[1] of a
//    [2, G] allocation sits 4G bytes in);
//  - the tables are read with evict-first loads, leaving L2 to the
//    result, which the next kernels read;
//  - a grid-stride loop over a grid of MR_BLOCKS_PER_SM blocks an SM.
#include "common.cuh"

#define MR_CAP 8
#define MR_BLOCKS_PER_SM 4

struct MrParts {
  const int* p[MR_CAP];
};

template <bool kMax>
__device__ __forceinline__ int mr_op(int a, int b) {
  return kMax ? max(a, b) : (int)((unsigned)a + (unsigned)b);
}

template <bool kMax>
__device__ __forceinline__ int4 mr_op4(int4 a, int4 b) {
  return make_int4(mr_op<kMax>(a.x, b.x), mr_op<kMax>(a.y, b.y),
                   mr_op<kMax>(a.z, b.z), mr_op<kMax>(a.w, b.w));
}

// kN: a power of two >= n, the loads a thread keeps in flight.
// groups: the 4-column groups taken by the vector path (0 when a table or
// out is not 16-byte aligned); the columns from 4 * groups on are scalar.
template <int kN, bool kMax>
__global__ void mr_fold(MrParts parts, int n, long long L, long long groups,
                        int* __restrict__ out) {
  long long stride = (long long)gridDim.x * blockDim.x;
  long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  for (long long g = t; g < groups; g += stride) {
    int4 v[kN];
#pragma unroll
    for (int s = 0; s < kN; ++s)
      if (s < n) v[s] = amt_load_first(reinterpret_cast<const int4*>(parts.p[s]) + g);
    int4 acc = v[0];
#pragma unroll
    for (int s = 1; s < kN; ++s)
      if (s < n) acc = mr_op4<kMax>(acc, v[s]);
    reinterpret_cast<int4*>(out)[g] = acc;
  }
  for (long long i = 4 * groups + t; i < L; i += stride) {
    int v[kN];
#pragma unroll
    for (int s = 0; s < kN; ++s)
      if (s < n) v[s] = amt_load_first(parts.p[s] + i);
    int acc = v[0];
#pragma unroll
    for (int s = 1; s < kN; ++s)
      if (s < n) acc = mr_op<kMax>(acc, v[s]);
    out[i] = acc;
  }
}

template <int kN>
static void mr_launch(const MrParts& parts, int n, long long L, long long groups,
                      bool max_op, int* out, int blocks, cudaStream_t stream) {
  if (max_op)
    mr_fold<kN, true><<<blocks, AMT_THREADS, 0, stream>>>(parts, n, L, groups, out);
  else
    mr_fold<kN, false><<<blocks, AMT_THREADS, 0, stream>>>(parts, n, L, groups, out);
}

// parts: n (1..MR_CAP) device pointers of int32 [L] tables, a host array;
// out: int32 [L]; op: 0 sum, 1 max; sms: the card's SM count
AMT_API int amt_mesh_reduce(const long long* parts, int n, long long L, int op,
                            int* out, int sms, cudaStream_t stream,
                            int* launched) {
  if (L <= 0) return (int)cudaGetLastError();
  MrParts p = {};
  bool wide = amt_aligned(out, 16);
  for (int s = 0; s < n; ++s) {
    p.p[s] = reinterpret_cast<const int*>(parts[s]);
    wide = wide && amt_aligned(p.p[s], 16);
  }
  long long groups = wide ? L / 4 : 0;
  int blocks = amt_grid(groups + (L - 4 * groups), sms, MR_BLOCKS_PER_SM);
  bool max_op = op == 1;
  if (n <= 1) mr_launch<1>(p, n, L, groups, max_op, out, blocks, stream);
  else if (n <= 2) mr_launch<2>(p, n, L, groups, max_op, out, blocks, stream);
  else if (n <= 4) mr_launch<4>(p, n, L, groups, max_op, out, blocks, stream);
  else mr_launch<MR_CAP>(p, n, L, groups, max_op, out, blocks, stream);
  AMT_LAUNCHED;
  return (int)cudaGetLastError();
}
