// Shared helpers of the port's kernels (plain C interface, loaded with
// ctypes; see automerge_tpu_torch/kernels/_build.py).
//
// Index semantics follow XLA's, which the JAX reference relies on: a
// gather index outside [0, n) is clamped into it, a scatter index outside
// [0, n) is dropped. Every index in these kernels is non-negative by
// construction (row ids, parent nodes, group ids), so clamping and
// dropping only ever see the high end.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define AMT_API extern "C" __attribute__((visibility("default")))

// Every entry point takes, last, a host int that it raises by one for each
// kernel it launches (AMT_LAUNCHED after each launch): the wrappers add it
// to their launch counts once the entry point has returned without error.
#define AMT_LAUNCHED (++*launched)

// op action codes (ops/oplog.py, ops/merge.py)
#define AMT_PUT 1
#define AMT_DELETE 3
#define AMT_INCREMENT 5
#define AMT_MARK 7
#define AMT_PAD_ACTION 15
#define AMT_TAG_COUNTER 8
#define AMT_ELEM_HEAD (-1)

static const int AMT_THREADS = 256;

static inline int amt_blocks(long long n) {
  return (int)((n + AMT_THREADS - 1) / AMT_THREADS);
}

__device__ __forceinline__ int amt_clamp(int i, int n) {
  return i < 0 ? 0 : (i >= n ? n - 1 : i);
}

// The blocks of a grid-stride launch over `work` items, one a thread:
// enough for all of them, at most `per_sm` blocks on each of `sms` SMs
// (the wrapper reads the card's SM count).
static inline int amt_grid(long long work, int sms, int per_sm) {
  long long cap = (long long)(sms > 0 ? sms : 1) * per_sm;
  long long want = (work + AMT_THREADS - 1) / AMT_THREADS;
  return (int)(want < 1 ? 1 : (want < cap ? want : cap));
}

__host__ __device__ __forceinline__ bool amt_aligned(const void* p, unsigned n) {
  return ((uintptr_t)p & (n - 1)) == 0;
}

// A load that evicts first (ld.global.cs): for values read once and dead
// after, so that L2 keeps what the next kernels read. A host C++ compiler
// (scripts/check_cuda_syntax.py) has no __ldcs and sees a plain load.
template <class T>
__device__ __forceinline__ T amt_load_first(const T* p) {
#ifdef __CUDACC__
  return __ldcs(p);
#else
  return *p;
#endif
}
