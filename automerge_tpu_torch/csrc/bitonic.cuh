// The bitonic sorting network over int64 keys, shared by forest.cu (the
// sibling keys) and sort_winners.cu (the winner group keys). Each file
// gets its own copy of the kernel: the sources build without relocatable
// device code.
#pragma once

#include "common.cuh"

#define AMT_KEY_MAX 0x7fffffffffffffffLL

// one compare-exchange step of the bitonic network (stage k, distance j)
static __global__ void amt_bitonic_step(long long* __restrict__ keys, int M,
                                        int j, int k) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= M) return;
  int l = i ^ j;
  if (l <= i) return;
  long long a = keys[i];
  long long b = keys[l];
  bool ascending = (i & k) == 0;
  if ((a > b) == ascending) {
    keys[i] = b;
    keys[l] = a;
  }
}

// Sorts keys[0:M] ascending in place, M a power of two: one launch per
// step, log2(M)(log2(M)+1)/2 in all.
static void amt_bitonic_steps(long long* keys, int M, cudaStream_t stream,
                              int* launched) {
  for (int k = 2; k <= M; k <<= 1)
    for (int j = k >> 1; j > 0; j >>= 1) {
      amt_bitonic_step<<<amt_blocks(M), AMT_THREADS, 0, stream>>>(keys, M, j, k);
      AMT_LAUNCHED;
    }
}
