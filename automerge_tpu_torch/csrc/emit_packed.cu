// emit_packed: the packed transport's one flat int32 output vector.
//
// Replaces automerge_tpu/ops/merge.py _emit (:1181) with _bitpack
// (:1165), the tail of the packed transport's kernel _runs_fn (:1198).
// The requested outputs are laid one after another in the flat vector:
//   * a bit output (visible as is, conflicts as conflicts > 1) as
//     ceil(n / 32) words, bit b of word w being row 32w + b (the rows past
//     n are 0), each word bitcast to int32;
//   * any other output as its n int32 values (a bool output as 0/1), the
//     per-object stats already cut to obj_cap by the caller.
// One launch covers every segment: each segment takes a multiple of 32
// threads (one per row, rounded up), so a warp never spans two segments;
// in a bit segment each warp forms its word with __ballot_sync and lane 0
// stores it. The segment table is passed by value (kernel parameters).
//
// Bound: bytes. Each output is read once (1 or 4 bytes per row) and the
// flat vector written once (4 bytes per int32 value, 4 per 32 rows of a
// bit output).
#include "common.cuh"

#define AMT_EMIT_MAX 16

enum { EMIT_BITS_BOOL = 0, EMIT_BITS_GT = 1, EMIT_COPY_I32 = 2, EMIT_COPY_BOOL = 3 };

struct EmitSeg {
  const void* src;
  long long lane0;  // first thread of the segment
  int kind;
  int thresh;  // EMIT_BITS_GT: the bit is src[r] > thresh
  int n;       // rows
  int out0;    // first int32 of the segment in the flat vector
};

struct EmitPlan {
  int nseg;
  long long lanes;  // threads of all segments, a multiple of 32
  EmitSeg seg[AMT_EMIT_MAX];
};

__global__ void emit_segments(const EmitPlan plan, int* __restrict__ out) {
  long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  // whole warps only: lanes is a multiple of 32, and so is blockDim
  if (t >= plan.lanes) return;
  int s = 0;
  while (s + 1 < plan.nseg && t >= plan.seg[s + 1].lane0) ++s;
  const EmitSeg& g = plan.seg[s];
  int r = (int)(t - g.lane0);
  bool in = r < g.n;
  if (g.kind == EMIT_BITS_BOOL || g.kind == EMIT_BITS_GT) {
    bool bit = false;
    if (in)
      bit = g.kind == EMIT_BITS_BOOL ? ((const bool*)g.src)[r]
                                     : ((const int*)g.src)[r] > g.thresh;
    unsigned word = __ballot_sync(0xffffffffu, bit);
    if ((threadIdx.x & 31) == 0) out[g.out0 + (r >> 5)] = (int)word;
  } else if (in) {
    out[g.out0 + r] = g.kind == EMIT_COPY_I32
                          ? ((const int*)g.src)[r]
                          : (int)((const bool*)g.src)[r];
  }
}

// srcs, kinds, threshs, ns: host arrays of nseg entries (nseg <= 16), in
// the order of the flat vector; out: int32, as long as the segments'
// words and values together (the wrapper computes the same length).
AMT_API int amt_emit_packed(const void* const* srcs, const int* kinds,
                            const int* threshs, const int* ns, int nseg,
                            int* out, cudaStream_t stream, int* launched) {
  if (nseg < 0 || nseg > AMT_EMIT_MAX) return (int)cudaErrorInvalidValue;
  EmitPlan plan;
  plan.nseg = nseg;
  long long lanes = 0, off = 0;
  for (int s = 0; s < nseg; ++s) {
    if (ns[s] < 0 || kinds[s] < EMIT_BITS_BOOL || kinds[s] > EMIT_COPY_BOOL)
      return (int)cudaErrorInvalidValue;
    long long words = ((long long)ns[s] + 31) / 32;
    plan.seg[s] = EmitSeg{srcs[s], lanes, kinds[s], threshs[s], ns[s], (int)off};
    lanes += words * 32;
    off += kinds[s] <= EMIT_BITS_GT ? words : (long long)ns[s];
  }
  plan.lanes = lanes;
  if (lanes == 0) return (int)cudaGetLastError();
  emit_segments<<<amt_blocks(lanes), AMT_THREADS, 0, stream>>>(plan, out);
  AMT_LAUNCHED;
  return (int)cudaGetLastError();
}
