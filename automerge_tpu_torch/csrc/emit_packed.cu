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
//
// Bound: bytes. Each output is read once (1 or 4 bytes per row) and the
// flat vector written once (4 bytes per int32 value, 4 per 32 rows of a
// bit output).
//
// Design:
//  - the plan (kinds, thresholds, lengths, offsets in the flat vector,
//    each segment's first block and the grid) is computed once by the
//    wrapper for a (fetch, obj_cap, shapes) and passed by value; each
//    segment owns a range of blocks, and a block's segment is a function
//    of blockIdx alone (a branch-free count of the block starts at or
//    below it, uniform across the block): no row searches;
//  - a bit output: one thread forms one whole word from its 32 rows, a
//    bool output's as two 16-byte loads, conflicts' as eight, packed with
//    bit arithmetic (no ballot); consecutive threads read consecutive 32-
//    or 128-byte chunks;
//  - a copy output: one thread stores 16 aligned bytes of the flat
//    vector (its first thread the 0-3 values before the segment's first
//    aligned word): a segment's offset is rarely a multiple of 4;
//  - an int32 source need not be 16-byte aligned (the winner and
//    conflicts of scatter_winners sit 2G + 2(P + 2) words into one
//    allocation, a stats table cut to obj_cap may be a view): a thread
//    still reads whole aligned 16-byte chunks, one more than its values
//    fill, and takes its values at the source's offset in them (a
//    template argument, so they stay in registers). Each chunk holds one
//    of the thread's own rows, so it lies in that row's allocation; a
//    bool source off 16 (bits) or 4 (copies) bytes is read byte by byte;
//  - every input is read once, with evict-first loads.
#include "common.cuh"

#define AMT_EMIT_MAX 16
#define EMIT_META 5  // int32s of a segment in the wrapper's plan

enum { EMIT_BITS_BOOL = 0, EMIT_BITS_GT = 1, EMIT_COPY_I32 = 2, EMIT_COPY_BOOL = 3 };

struct EmitSeg {
  const void* src;
  int kind;
  int thresh;  // EMIT_BITS_GT: the bit is src[r] > thresh
  int n;       // rows
  int out0;    // first int32 of the segment in the flat vector
  int head;    // a copy's values before its first 16-byte-aligned word
  int shift;   // int32: the first wide load's row, in int32s past a 16-byte
               // boundary; bool: 0 where aligned for the wide loads, else 1
};

struct EmitPlan {
  int nseg;
  int block0[AMT_EMIT_MAX];  // the first block of each segment
  EmitSeg seg[AMT_EMIT_MAX];
};

// the low bits of four bool bytes, byte k to bit k (the products of the
// four bits land on distinct bits, so nothing carries into bits 28-31)
__device__ __forceinline__ unsigned emit_nibble(unsigned x) {
  return ((x & 0x01010101u) * 0x10204080u) >> 28;
}

// the N int32 from p, p M int32s past a 16-byte boundary: the aligned
// 16-byte chunks that hold them, each holding one of them
template <int M, int N>
__device__ __forceinline__ void emit_ints_at(const int* p, int (&v)[N]) {
  constexpr int kChunks = (M + N + 3) / 4;
  const int4* q = reinterpret_cast<const int4*>(p - M);
  int w[4 * kChunks];
#pragma unroll
  for (int k = 0; k < kChunks; ++k) {
    int4 c = amt_load_first(q + k);
    w[4 * k] = c.x;
    w[4 * k + 1] = c.y;
    w[4 * k + 2] = c.z;
    w[4 * k + 3] = c.w;
  }
#pragma unroll
  for (int i = 0; i < N; ++i) v[i] = w[M + i];
}

template <int N>
__device__ __forceinline__ void emit_ints(const int* p, int shift, int (&v)[N]) {
  switch (shift) {
    case 0: emit_ints_at<0>(p, v); break;
    case 1: emit_ints_at<1>(p, v); break;
    case 2: emit_ints_at<2>(p, v); break;
    default: emit_ints_at<3>(p, v); break;
  }
}

// word w of a bit segment: rows 32w .. 32w + 31
__device__ __forceinline__ void emit_word(const EmitSeg& g, int w,
                                          int* __restrict__ out) {
  long long r0 = 32LL * w;
  unsigned word = 0;
  if (r0 + 32 <= g.n && g.kind == EMIT_BITS_GT) {
    int v[32];
    emit_ints((const int*)g.src + r0, g.shift, v);
#pragma unroll
    for (int b = 0; b < 32; ++b) word |= (unsigned)(v[b] > g.thresh) << b;
  } else if (r0 + 32 <= g.n && g.shift == 0) {
    const uint4* p =
        reinterpret_cast<const uint4*>((const unsigned char*)g.src + r0);
    uint4 a = amt_load_first(p), b = amt_load_first(p + 1);
    word = emit_nibble(a.x) | emit_nibble(a.y) << 4 | emit_nibble(a.z) << 8 |
           emit_nibble(a.w) << 12 | emit_nibble(b.x) << 16 |
           emit_nibble(b.y) << 20 | emit_nibble(b.z) << 24 |
           emit_nibble(b.w) << 28;
  } else {
    int rows = (int)min(32LL, (long long)g.n - r0);
    for (int b = 0; b < rows; ++b) {
      bool bit = g.kind == EMIT_BITS_BOOL
                     ? amt_load_first((const unsigned char*)g.src + r0 + b) != 0
                     : amt_load_first((const int*)g.src + r0 + b) > g.thresh;
      word |= (unsigned)bit << b;
    }
  }
  out[g.out0 + w] = (int)word;
}

__device__ __forceinline__ int emit_value(const EmitSeg& g, long long r) {
  return g.kind == EMIT_COPY_I32
             ? amt_load_first((const int*)g.src + r)
             : (int)amt_load_first((const unsigned char*)g.src + r);
}

// chunk t of a copy segment: t = 0 the head values [0, head), t >= 1 the
// four values from head + 4 (t - 1), 16-byte aligned in the flat vector
__device__ __forceinline__ void emit_chunk(const EmitSeg& g, long long t,
                                           int* __restrict__ out) {
  int* dst = out + g.out0;
  long long w0 = t == 0 ? 0 : g.head + 4 * (t - 1);
  long long w1 = t == 0 ? g.head : min(w0 + 4, (long long)g.n);
  if (t > 0 && w1 - w0 == 4) {
    int4 v;
    if (g.kind == EMIT_COPY_I32) {
      int u[4];
      emit_ints((const int*)g.src + w0, g.shift, u);
      v = make_int4(u[0], u[1], u[2], u[3]);
    } else {
      const unsigned char* s = (const unsigned char*)g.src + w0;
      unsigned x = g.shift == 0
                       ? amt_load_first(reinterpret_cast<const unsigned*>(s))
                         : (unsigned)amt_load_first(s) |
                               (unsigned)amt_load_first(s + 1) << 8 |
                               (unsigned)amt_load_first(s + 2) << 16 |
                               (unsigned)amt_load_first(s + 3) << 24;
      v = make_int4((int)(x & 0xffu), (int)((x >> 8) & 0xffu),
                    (int)((x >> 16) & 0xffu), (int)(x >> 24));
    }
    *reinterpret_cast<int4*>(dst + w0) = v;
    return;
  }
  for (long long w = w0; w < w1; ++w) dst[w] = emit_value(g, w);
}

__global__ void __launch_bounds__(AMT_THREADS)
    emit_segments(const __grid_constant__ EmitPlan plan, int* __restrict__ out) {
  int b = blockIdx.x;
  int s = 0;
#pragma unroll
  for (int k = 1; k < AMT_EMIT_MAX; ++k)
    s += (k < plan.nseg && b >= plan.block0[k]) ? 1 : 0;
  const EmitSeg& g = plan.seg[s];
  long long t = (long long)(b - plan.block0[s]) * AMT_THREADS + threadIdx.x;
  if (g.kind <= EMIT_BITS_GT) {
    if (t < ((long long)g.n + 31) / 32) emit_word(g, (int)t, out);
  } else if (g.n > 0 && t <= ((long long)g.n - g.head + 3) / 4) {
    emit_chunk(g, t, out);
  }
}

// the threads a segment of n rows needs: a word each of a bit output, a
// head and a chunk of four values each of a copy (whatever the head)
static long long emit_threads(int kind, long long n) {
  if (kind <= EMIT_BITS_GT) return (n + 31) / 32;
  return n == 0 ? 0 : (n + 3) / 4 + 1;
}

// srcs: nseg source pointers (nseg <= 16), in the order of the flat
// vector; meta: the wrapper's plan, EMIT_META int32s a segment (kind,
// threshold, rows, offset in the flat vector, first block), then the
// grid's blocks; out: int32 [flat], the segments' words and values
// together. Every segment is checked to fit its blocks and the vector.
AMT_API int amt_emit_packed(const void* const* srcs, const int* meta, int nseg,
                            long long flat, int* out, cudaStream_t stream,
                            int* launched) {
  if (nseg < 1 || nseg > AMT_EMIT_MAX) return (int)cudaErrorInvalidValue;
  int blocks = meta[EMIT_META * nseg];
  EmitPlan plan = {};
  plan.nseg = nseg;
  for (int s = 0; s < nseg; ++s) {
    const int* m = meta + EMIT_META * s;
    int kind = m[0], n = m[2], out0 = m[3], block0 = m[4];
    int block1 = s + 1 < nseg ? meta[EMIT_META * (s + 1) + 4] : blocks;
    if (kind < EMIT_BITS_BOOL || kind > EMIT_COPY_BOOL || n < 0 || out0 < 0 ||
        block0 < 0 || block1 < block0)
      return (int)cudaErrorInvalidValue;
    long long len = kind <= EMIT_BITS_GT ? ((long long)n + 31) / 32 : n;
    if (out0 + len > flat ||
        (long long)(block1 - block0) * AMT_THREADS < emit_threads(kind, n))
      return (int)cudaErrorInvalidValue;
    EmitSeg g{srcs[s], kind, m[1], n, out0, 0, 0};
    if (kind >= EMIT_COPY_I32) {
      // values until the flat vector's next 16-byte boundary
      int* dst = out + out0;
      g.head = (int)((16 - ((uintptr_t)dst & 15)) & 15) / 4;
      if (g.head > n) g.head = n;
    }
    if (kind == EMIT_BITS_GT || kind == EMIT_COPY_I32) {
      if (!amt_aligned(g.src, 4)) return (int)cudaErrorInvalidValue;
      g.shift = (int)((((uintptr_t)g.src >> 2) + g.head) & 3);
    } else {
      g.shift = amt_aligned((const unsigned char*)g.src + g.head,
                            kind == EMIT_BITS_BOOL ? 16 : 4) ? 0 : 1;
    }
    plan.seg[s] = g;
    plan.block0[s] = block0;
  }
  if (blocks == 0) return (int)cudaGetLastError();
  emit_segments<<<blocks, AMT_THREADS, 0, stream>>>(plan, out);
  AMT_LAUNCHED;
  return (int)cudaGetLastError();
}
