// succ_vis: pred-edge successor counting + the visibility mask.
//
// Replaces automerge_tpu/ops/merge.py succ_resolution (:59) and
// visibility (:91). XLA lowers the first to one fused (P,3) int32
// scatter-add; here one thread per pred edge does int32 atomicAdds into a
// [3, P] accumulator (succ, inc, counter_inc: SoA, so each row's three
// counts stay contiguous per array for the visibility pass). Integer adds
// commute and wrap like XLA's int32, so the result is exact and
// independent of the atomics' order. A second launch evaluates the
// visibility rule per row.
//
// Bound: bytes. Inputs pred_src/pred_tgt (8Q) and action, value_tag,
// covered (9P) are read once, value_i32 only at the sources of increment
// edges; succ/inc/counter_inc/visible (13P) written once; the random atomics and gathers by src are what the
// simple design pays beyond that.
#include "common.cuh"

__global__ void succ_edges(const int* __restrict__ action,
                           const int* __restrict__ value_i32,
                           const bool* __restrict__ covered,
                           const int* __restrict__ pred_src,
                           const int* __restrict__ pred_tgt, int P, int Q,
                           int* __restrict__ succ, int* __restrict__ inc,
                           int* __restrict__ counter_inc) {
  int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= Q) return;
  int tgt = pred_tgt[e];
  int src = amt_clamp(pred_src[e], P);
  // tgt < 0: unresolved pred (masked); tgt >= P: XLA drops the scatter
  if (tgt < 0 || tgt >= P || !covered[src]) return;
  if (action[src] == AMT_INCREMENT) {
    atomicAdd(&inc[tgt], 1);
    atomicAdd(&counter_inc[tgt], value_i32[src]);
  } else {
    atomicAdd(&succ[tgt], 1);
  }
}

__global__ void vis_rows(const int* __restrict__ action,
                         const int* __restrict__ value_tag,
                         const bool* __restrict__ covered,
                         const int* __restrict__ succ,
                         const int* __restrict__ inc, int P,
                         bool* __restrict__ visible) {
  int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= P) return;
  int a = action[r];
  bool valid = a != AMT_PAD_ACTION;
  bool never = a == AMT_DELETE || a == AMT_INCREMENT || a == AMT_MARK;
  bool is_counter = a == AMT_PUT && value_tag[r] == AMT_TAG_COUNTER;
  int s = succ[r];
  // int32 sum with wraparound, as in the reference
  int si = (int)((unsigned)s + (unsigned)inc[r]);
  // counter puts survive increment successors (types.rs:712-720)
  bool alive = is_counter ? s == 0 : si == 0;
  visible[r] = valid && covered[r] && !never && alive;
}

// acc: int32 [3, P] (succ, inc, counter_inc); visible: bool [P]
AMT_API int amt_succ_vis(const int* action, const int* value_tag,
                         const int* value_i32, const bool* covered,
                         const int* pred_src, const int* pred_tgt, int P,
                         int Q, int* acc, bool* visible,
                         cudaStream_t stream, int* launched) {
  if (P <= 0) return (int)cudaGetLastError();
  int* succ = acc;
  int* inc = acc + P;
  int* counter_inc = acc + 2 * (long long)P;
  amt_fill_i32<<<amt_blocks(3LL * P), AMT_THREADS, 0, stream>>>(acc, 0, 3LL * P);
  AMT_LAUNCHED;
  if (Q > 0) {
    succ_edges<<<amt_blocks(Q), AMT_THREADS, 0, stream>>>(
        action, value_i32, covered, pred_src, pred_tgt, P, Q, succ, inc,
        counter_inc);
    AMT_LAUNCHED;
  }
  vis_rows<<<amt_blocks(P), AMT_THREADS, 0, stream>>>(
      action, value_tag, covered, succ, inc, P, visible);
  AMT_LAUNCHED;
  return (int)cudaGetLastError();
}

// The sharded merge's two halves of amt_succ_vis
// (automerge_tpu/parallel/sharding.py _sharded_merge, :340-345): each
// shard counts its slice of the pred edges into a [3, P] accumulator of
// its own (succ_edges over Q edges, pad edges with tgt -1 dropped), the
// collectives sum the shards' accumulators, and amt_visibility applies
// the rule to the sums on each device.
AMT_API int amt_succ_partial(const int* action, const int* value_i32,
                             const bool* covered, const int* pred_src,
                             const int* pred_tgt, int P, int Q, int* acc,
                             cudaStream_t stream, int* launched) {
  if (P <= 0) return (int)cudaGetLastError();
  amt_fill_i32<<<amt_blocks(3LL * P), AMT_THREADS, 0, stream>>>(acc, 0, 3LL * P);
  AMT_LAUNCHED;
  if (Q > 0) {
    succ_edges<<<amt_blocks(Q), AMT_THREADS, 0, stream>>>(
        action, value_i32, covered, pred_src, pred_tgt, P, Q, acc, acc + P,
        acc + 2 * (long long)P);
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
  vis_rows<<<amt_blocks(P), AMT_THREADS, 0, stream>>>(
      action, value_tag, covered, succ, inc, P, visible);
  AMT_LAUNCHED;
  return (int)cudaGetLastError();
}
