// succ_vis: pred-edge successor counting + the visibility mask.
//
// Replaces automerge_tpu/ops/merge.py succ_resolution (:59) and
// visibility (:91). XLA lowers the first to one fused (P,3) int32
// scatter-add over the pred edges and the second to one pass per row.
//
// Bound: bytes. Inputs pred_src/pred_tgt (8Q) and action, value_tag,
// covered (9P) are read once, value_i32 only at the sources of increment
// edges; succ/inc/counter_inc/visible (13P) written once. The work is a
// row stream plus a scatter of a few percent of P (the fan-ins' edges
// reach at most 9 into one row), so atomic contention is low.
//
// Design: two launches in stream order, no fill and no second row pass.
//  1. sv_rows<false>, four rows a thread (16-byte loads of action, a
//     4-byte load of covered, 16-byte stores of the three zeroed counts
//     and a 4-byte store of visible; a scalar path for the tail and for
//     columns that are not so aligned, e.g. views at an odd offset):
//     succ = inc = counter_inc = 0 and visible = valid && covered &&
//     !never, as if no edge counted. value_tag is not needed here.
//  2. sv_edges<true>, one thread per pred edge, dropped unless
//     0 <= tgt < P and covered[src] (src clamped, as XLA gathers): a
//     non-increment source adds 1 to succ[tgt] and stores visible[tgt] =
//     false; an increment source adds 1 to inc[tgt] and value_i32[src]
//     to counter_inc[tgt], and stores visible[tgt] = false unless tgt is
//     a counter put (types.rs:712-720; action and value_tag read at tgt
//     only for increment edges).
// Exact: every store to visible in pass 2 writes false, so their order
// does not matter; the counts are non-negative and at most Q < 2^31, so
// succ + inc == 0 exactly when both are 0, i.e. when no edge stored;
// int32 adds commute and wrap as XLA's do.
#include "common.cuh"

__device__ __forceinline__ bool sv_shown(int a, bool covered) {
  // valid, covered, not a delete/increment/mark
  return a != AMT_PAD_ACTION && covered && a != AMT_DELETE &&
         a != AMT_INCREMENT && a != AMT_MARK;
}

__device__ __forceinline__ bool sv_alive(int a, int tag, int s, int i) {
  // counter puts survive increment successors (types.rs:712-720);
  // int32 sum with wraparound, as in the reference
  bool is_counter = a == AMT_PUT && tag == AMT_TAG_COUNTER;
  return is_counter ? s == 0 : (int)((unsigned)s + (unsigned)i) == 0;
}

// COUNTS = false: the row pass of amt_succ_vis (zero the counts, visible
// before the edges). COUNTS = true: amt_visibility, the whole rule over
// given succ/inc (read, not written).
template <bool COUNTS>
__global__ void sv_rows(const int* __restrict__ action,
                        const int* __restrict__ value_tag,
                        const bool* __restrict__ covered, int P,
                        int* __restrict__ succ, int* __restrict__ inc,
                        int* __restrict__ counter_inc,
                        bool* __restrict__ visible) {
  long long r0 = 4LL * ((long long)blockIdx.x * blockDim.x + threadIdx.x);
  if (r0 >= P) return;
  bool wide = r0 + 4 <= P && amt_aligned(action, 16) && amt_aligned(succ, 16) &&
              amt_aligned(inc, 16) && amt_aligned(covered, 4) &&
              amt_aligned(visible, 4) &&
              (COUNTS ? amt_aligned(value_tag, 16) : amt_aligned(counter_inc, 16));
  if (wide) {
    int4 a = *reinterpret_cast<const int4*>(action + r0);
    unsigned cov = *reinterpret_cast<const unsigned*>(covered + r0);
    int av[4] = {a.x, a.y, a.z, a.w};
    unsigned vis = 0;
    if (COUNTS) {
      int4 t = *reinterpret_cast<const int4*>(value_tag + r0);
      int4 s = *reinterpret_cast<const int4*>(succ + r0);
      int4 i = *reinterpret_cast<const int4*>(inc + r0);
      int tv[4] = {t.x, t.y, t.z, t.w}, sv[4] = {s.x, s.y, s.z, s.w},
          iv[4] = {i.x, i.y, i.z, i.w};
#pragma unroll
      for (int k = 0; k < 4; ++k)
        vis |= (unsigned)(sv_shown(av[k], (cov >> (8 * k)) & 0xff) &&
                          sv_alive(av[k], tv[k], sv[k], iv[k]))
               << (8 * k);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        vis |= (unsigned)sv_shown(av[k], (cov >> (8 * k)) & 0xff) << (8 * k);
      int4 zero = make_int4(0, 0, 0, 0);
      *reinterpret_cast<int4*>(succ + r0) = zero;
      *reinterpret_cast<int4*>(inc + r0) = zero;
      *reinterpret_cast<int4*>(counter_inc + r0) = zero;
    }
    *reinterpret_cast<unsigned*>(visible + r0) = vis;
    return;
  }
  long long end = r0 + 4 < P ? r0 + 4 : P;
  for (long long r = r0; r < end; ++r) {
    int a = action[r];
    bool v = sv_shown(a, covered[r]);
    if (COUNTS) {
      v = v && sv_alive(a, value_tag[r], succ[r], inc[r]);
    } else {
      succ[r] = 0;
      inc[r] = 0;
      counter_inc[r] = 0;
    }
    visible[r] = v;
  }
}

// VIS = true: amt_succ_vis's edge pass (after sv_rows<false>); VIS =
// false: amt_succ_partial, the counts alone into a zeroed accumulator.
template <bool VIS>
__global__ void sv_edges(const int* __restrict__ action,
                         const int* __restrict__ value_tag,
                         const int* __restrict__ value_i32,
                         const bool* __restrict__ covered,
                         const int* __restrict__ pred_src,
                         const int* __restrict__ pred_tgt, int P, int Q,
                         int* __restrict__ succ, int* __restrict__ inc,
                         int* __restrict__ counter_inc,
                         bool* __restrict__ visible) {
  int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= Q) return;
  int tgt = pred_tgt[e];
  int src = amt_clamp(pred_src[e], P);
  // tgt < 0: unresolved pred (masked); tgt >= P: XLA drops the scatter
  if (tgt < 0 || tgt >= P || !covered[src]) return;
  if (action[src] == AMT_INCREMENT) {
    atomicAdd(&inc[tgt], 1);
    atomicAdd(&counter_inc[tgt], value_i32[src]);
    if (VIS && !(action[tgt] == AMT_PUT && value_tag[tgt] == AMT_TAG_COUNTER))
      visible[tgt] = false;
  } else {
    atomicAdd(&succ[tgt], 1);
    if (VIS) visible[tgt] = false;
  }
}

static inline int sv_row_blocks(int P) { return amt_blocks((P + 3LL) / 4); }

// out: int32 [3 * stride + stride / 4], stride = P rounded up to a
// multiple of 4 (so each row starts 16-byte aligned): the rows succ, inc,
// counter_inc at 0, stride, 2 * stride, then visible (bool [P]) as bytes
AMT_API int amt_succ_vis(const int* action, const int* value_tag,
                         const int* value_i32, const bool* covered,
                         const int* pred_src, const int* pred_tgt, int P,
                         int Q, int* out, cudaStream_t stream, int* launched) {
  if (P <= 0) return (int)cudaGetLastError();
  long long stride = (P + 3LL) & ~3LL;
  int* succ = out;
  int* inc = out + stride;
  int* counter_inc = out + 2 * stride;
  bool* visible = reinterpret_cast<bool*>(out + 3 * stride);
  sv_rows<false><<<sv_row_blocks(P), AMT_THREADS, 0, stream>>>(
      action, value_tag, covered, P, succ, inc, counter_inc, visible);
  AMT_LAUNCHED;
  if (Q > 0) {
    sv_edges<true><<<amt_blocks(Q), AMT_THREADS, 0, stream>>>(
        action, value_tag, value_i32, covered, pred_src, pred_tgt, P, Q, succ,
        inc, counter_inc, visible);
    AMT_LAUNCHED;
  }
  return (int)cudaGetLastError();
}

// The sharded merge's two halves of amt_succ_vis
// (automerge_tpu/parallel/sharding.py _sharded_merge, :340-345): each
// shard counts its slice of the pred edges into a [3, P] accumulator of
// its own (pad edges with tgt -1 dropped), the collectives sum the
// shards' accumulators, and amt_visibility applies the rule to the sums
// on each device.
AMT_API int amt_succ_partial(const int* action, const int* value_i32,
                             const bool* covered, const int* pred_src,
                             const int* pred_tgt, int P, int Q, int* acc,
                             cudaStream_t stream, int* launched) {
  if (P <= 0) return (int)cudaGetLastError();
  cudaError_t err = cudaMemsetAsync(acc, 0, 3LL * P * sizeof(int), stream);
  if (err != cudaSuccess) return (int)err;
  if (Q > 0) {
    sv_edges<false><<<amt_blocks(Q), AMT_THREADS, 0, stream>>>(
        action, nullptr, value_i32, covered, pred_src, pred_tgt, P, Q, acc,
        acc + P, acc + 2LL * P, nullptr);
    AMT_LAUNCHED;
  }
  return (int)cudaGetLastError();
}

// succ, inc: int32 [P] (the summed accumulator's first two rows)
AMT_API int amt_visibility(const int* action, const int* value_tag,
                           const bool* covered, const int* succ,
                           const int* inc, int P, bool* visible,
                           cudaStream_t stream, int* launched) {
  if (P <= 0) return (int)cudaGetLastError();
  sv_rows<true><<<sv_row_blocks(P), AMT_THREADS, 0, stream>>>(
      action, value_tag, covered, P, const_cast<int*>(succ),
      const_cast<int*>(inc), nullptr, visible);
  AMT_LAUNCHED;
  return (int)cudaGetLastError();
}
