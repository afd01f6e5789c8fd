// linearize_condensed: document-order element indices by chain
// condensation, all on the device.
//
// Replaces automerge_tpu/ops/merge.py device_linearize_condensed
// (:303-494). The insert rows are laid out in actor order (aorder: slot k
// holds row aorder[k], pad slots P); there a typing chain is a contiguous
// stretch of slots, each the first child of the slot before. The passes:
//   1. lc_init zeroes kpos, t_row and the run starts (the reference's
//      scatter fills);
//   2. lc_slots, one thread per slot: kpos[row] = k, the row's facts
//      gathered (elem_ref, next_sib, whether it is its parent's first
//      child), the run break and sibling flag, then a block-local
//      inclusive scan in shared memory with warp shuffles of (breaks,
//      max of flagged slots): the run index and the last sibling-bearing
//      slot so far; block totals out. lc_scan_totals scans the block
//      totals in one block and writes the run count and the element
//      count; lc_fixup adds each block's prefix and scatters the run
//      starts. Runs are contiguous, so "the last flagged slot so far lies
//      in my run" is the reference's 4-tuple segmented scan (:378-393);
//   3. run tables over rcap runs: lengths from adjacent starts, then the
//      sibling climb (pointer doubling over (done, ans, jump)) and Wyllie
//      ranking of the run successor chain (sentinel run rcap), each
//      ceil_log2(rcap)+1 rounds, one launch per round on ping-pong
//      buffers (an in-place jump[jump] would race);
//   4. lc_broadcast: t_row[aorder[k]] = dist[run] - offset in the run;
//      lc_final: elem_index = t_row[start(obj)] - t_row[row], the start
//      read from the object's root (:490-494). The reference's obj_cap
//      arm (:481-488) reads the same roots through a table; it exists
//      there to pack the winner key, so it is not ported.
// The reference scatters where it could gather (random gathers are slow
// on a TPU); here every slot and run gathers what it needs. Every gather
// index is clamped, as XLA clamps; rows outside aorder keep kpos 0, as
// in the reference. The run count goes to a device scalar: the wrapper
// raises when it exceeds rcap (the reference assumes it fits).
//
// Bound: bytes. first_child and next_sib over the rows [0, P) (4P each),
// is_elem (1P), elem_ref, obj_dense, aorder (4P each) and first_child at
// the object roots read once, elem_index (4P) written once. The simple
// design pays 2*(ceil_log2(rcap)+1) launches of rcap-sized rounds and
// about ten slot- or row-sized passes beyond that.
#include "common.cuh"

#define LC_SCAN 1024  // slots per scan block, one per thread
#define LC_FULL 0xffffffffu

enum { LC_BRK = 1, LC_FLAG = 2, LC_VALID = 4 };

// Inclusive scan over the block's threads of (s: sum, m: max); every
// thread gets the block totals in ts, tm. All threads of the block call it.
__device__ void lc_block_scan(int& s, int& m, int& ts, int& tm, int* sh_s,
                              int* sh_m) {
  int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int nw = blockDim.x >> 5;
  for (int o = 1; o < 32; o <<= 1) {
    int us = __shfl_up_sync(LC_FULL, s, o);
    int um = __shfl_up_sync(LC_FULL, m, o);
    if (lane >= o) {
      s += us;
      m = max(m, um);
    }
  }
  if (lane == 31) {
    sh_s[warp] = s;
    sh_m[warp] = m;
  }
  __syncthreads();
  if (warp == 0) {
    int ws = lane < nw ? sh_s[lane] : 0;
    int wm = lane < nw ? sh_m[lane] : -1;
    for (int o = 1; o < 32; o <<= 1) {
      int us = __shfl_up_sync(LC_FULL, ws, o);
      int um = __shfl_up_sync(LC_FULL, wm, o);
      if (lane >= o) {
        ws += us;
        wm = max(wm, um);
      }
    }
    sh_s[lane] = ws;
    sh_m[lane] = wm;
  }
  __syncthreads();
  if (warp > 0) {
    s += sh_s[warp - 1];
    m = max(m, sh_m[warp - 1]);
  }
  ts = sh_s[nw - 1];
  tm = sh_m[nw - 1];
  __syncthreads();  // sh_* may be reused by the next call
}

__global__ void lc_init(int P, int rcap, int* __restrict__ kpos,
                        int* __restrict__ t_row, int* __restrict__ run_start) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < P) {
    kpos[i] = 0;
    t_row[i] = 0;
  }
  if (i < rcap) run_start[i] = 0;
}

__global__ void __launch_bounds__(LC_SCAN)
    lc_slots(const int* __restrict__ first_child,
             const int* __restrict__ next_sib, const bool* __restrict__ is_elem,
             const int* __restrict__ elem_ref, const int* __restrict__ aorder,
             int P, int* __restrict__ kpos, int* __restrict__ sib_k,
             int* __restrict__ run_of, int* __restrict__ last,
             unsigned char* __restrict__ flags, int* __restrict__ bsum,
             int* __restrict__ bmax, int* __restrict__ bval) {
  __shared__ int sh_s[32], sh_m[32];
  int k = blockIdx.x * blockDim.x + threadIdx.x;
  int brk = 0, fl = 0, valid = 0;
  if (k < P) {
    int row = aorder[k];
    valid = row < P;
    int er = 0, sib = 0, cont = 0;
    if (valid) {
      int rc = amt_clamp(row, P);
      kpos[rc] = k;
      if (is_elem[rc]) {
        er = elem_ref[rc];
        sib = next_sib[rc];
        // rc continues a chain iff it is its parent element's first child
        bool is_cont = er >= 0 && er < P && is_elem[er] && first_child[er] == rc;
        cont = (is_cont ? 2 : 0) | (sib != -1 ? 1 : 0);
      }
    }
    int prev = k == 0 ? P : aorder[k - 1];
    brk = valid && !(cont >= 2 && er == prev);
    fl = valid && (cont & 1);
    sib_k[k] = sib;
    flags[k] = (brk ? LC_BRK : 0) | (fl ? LC_FLAG : 0) | (valid ? LC_VALID : 0);
  }
  int s = brk, m = fl ? k : -1, ts, tm;
  lc_block_scan(s, m, ts, tm, sh_s, sh_m);
  int nval = __syncthreads_count(valid);
  if (k < P) {
    run_of[k] = s;
    last[k] = m;
  }
  if (threadIdx.x == 0) {
    bsum[blockIdx.x] = ts;
    bmax[blockIdx.x] = tm;
    bval[blockIdx.x] = nval;
  }
}

// One block: the block totals become inclusive prefixes in place; totals
// gets (run count, element count).
__global__ void __launch_bounds__(LC_SCAN)
    lc_scan_totals(int nb, int* __restrict__ bsum, int* __restrict__ bmax,
                   const int* __restrict__ bval, int* __restrict__ totals) {
  __shared__ int sh_s[32], sh_m[32];
  __shared__ int sh_v;
  if (threadIdx.x == 0) sh_v = 0;
  __syncthreads();
  int carry_s = 0, carry_m = -1;
  for (int base = 0; base < nb; base += blockDim.x) {
    int i = base + threadIdx.x;
    int s = i < nb ? bsum[i] : 0, m = i < nb ? bmax[i] : -1, ts, tm;
    if (i < nb && bval[i]) atomicAdd(&sh_v, bval[i]);
    lc_block_scan(s, m, ts, tm, sh_s, sh_m);
    if (i < nb) {
      bsum[i] = s + carry_s;
      bmax[i] = max(m, carry_m);
    }
    carry_s += ts;
    carry_m = max(carry_m, tm);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    totals[0] = carry_s;
    totals[1] = sh_v;
  }
}

__global__ void __launch_bounds__(LC_SCAN)
    lc_fixup(int P, int rcap, const int* __restrict__ bsum,
             const int* __restrict__ bmax,
             const unsigned char* __restrict__ flags, int* __restrict__ run_of,
             int* __restrict__ last, int* __restrict__ run_start) {
  int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= P) return;
  int b = blockIdx.x;
  int r = run_of[k] + (b ? bsum[b - 1] : 0) - 1;
  run_of[k] = r;
  last[k] = max(last[k], b ? bmax[b - 1] : -1);
  if ((flags[k] & LC_BRK) && r < rcap) run_start[r] = k;
}

// A at slot j from within its run: the next sibling of the last
// sibling-bearing slot of [start of j's run, j], if there is one.
__device__ __forceinline__ bool lc_ans_at(const int* __restrict__ run_of,
                                          const int* __restrict__ run_start,
                                          const int* __restrict__ last,
                                          const int* __restrict__ sib_k, int j,
                                          int P, int rcap, int* ans) {
  int r = run_of[j];
  int start = r >= 0 ? run_start[amt_clamp(r, rcap)] : 0;
  int l = last[j];
  bool found = l >= start;
  *ans = found ? sib_k[amt_clamp(l, P)] : -1;
  return found;
}

__global__ void lc_runs_init(const int* __restrict__ elem_ref,
                             const int* __restrict__ aorder,
                             const int* __restrict__ kpos,
                             const int* __restrict__ run_of,
                             const int* __restrict__ last,
                             const int* __restrict__ sib_k,
                             const int* __restrict__ run_start,
                             const int* __restrict__ totals, int P, int rcap,
                             int* __restrict__ run_len, int* __restrict__ ans,
                             unsigned char* __restrict__ done,
                             int* __restrict__ jump) {
  int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= rcap) return;
  int cnt = totals[0];
  bool live = r < cnt;
  int rs = run_start[r];
  int next = r + 1 < rcap ? run_start[r + 1] : 0;
  int re = r + 1 < cnt ? next : totals[1];
  run_len[r] = live ? re - rs : 0;
  // the run asks for A at its head's parent (object roots end the climb)
  int head = aorder[amt_clamp(rs, P)];
  int par = live ? elem_ref[amt_clamp(head, P)] : -1;
  bool par_elem = par >= 0;
  int pk = kpos[amt_clamp(par, P)];
  int a;
  bool found = lc_ans_at(run_of, run_start, last, sib_k, pk, P, rcap, &a);
  done[r] = !par_elem || found;
  ans[r] = (par_elem && found) ? a : -1;
  jump[r] = par_elem ? amt_clamp(run_of[pk], rcap) : r;
}

__global__ void lc_climb(const int* __restrict__ ans0,
                         const unsigned char* __restrict__ done0,
                         const int* __restrict__ jump0, int rcap,
                         int* __restrict__ ans1, unsigned char* __restrict__ done1,
                         int* __restrict__ jump1) {
  int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= rcap) return;
  int j = amt_clamp(jump0[r], rcap);
  bool d = done0[r];
  bool take = !d && done0[j];
  ans1[r] = take ? ans0[j] : ans0[r];
  done1[r] = d || take;
  jump1[r] = jump0[j];
}

// The run successor: the tail's first child (a later run's head), else A
// at the tail (its run prefix, else the run's climb answer).
__global__ void lc_succ(const int* __restrict__ first_child,
                        const int* __restrict__ aorder,
                        const int* __restrict__ kpos,
                        const int* __restrict__ run_of,
                        const int* __restrict__ last,
                        const int* __restrict__ sib_k,
                        const int* __restrict__ run_start,
                        const int* __restrict__ run_len,
                        const int* __restrict__ ans_r,
                        const int* __restrict__ totals, int P, int rcap,
                        int* __restrict__ dist, int* __restrict__ nxt) {
  int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r > rcap) return;
  if (r == rcap) {  // the end of every chain
    dist[r] = 0;
    nxt[r] = rcap;
    return;
  }
  bool live = r < totals[0];
  int tail = amt_clamp(run_start[r] + run_len[r] - 1, P);
  int fc = first_child[amt_clamp(aorder[tail], P)];
  int a;
  bool found = lc_ans_at(run_of, run_start, last, sib_k, tail, P, rcap, &a);
  int a_tail = found ? a : ans_r[r];
  int nrow = live ? (fc >= 0 ? fc : a_tail) : -1;
  nxt[r] = nrow >= 0 ? amt_clamp(run_of[kpos[amt_clamp(nrow, P)]], rcap) : rcap;
  dist[r] = live ? run_len[r] : 0;
}

__global__ void lc_rank(const int* __restrict__ dist0,
                        const int* __restrict__ nxt0, int E,
                        int* __restrict__ dist1, int* __restrict__ nxt1) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= E) return;
  int j = amt_clamp(nxt0[i], E);
  dist1[i] = dist0[i] + dist0[j];
  nxt1[i] = nxt0[j];
}

// Nodes from slot k (inclusive) to the end: its run's minus its offset,
// written to k's row.
__global__ void lc_broadcast(const int* __restrict__ aorder,
                             const int* __restrict__ run_of,
                             const int* __restrict__ run_start,
                             const int* __restrict__ dist, int P, int rcap,
                             int* __restrict__ t_row) {
  int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= P) return;
  int row = aorder[k];
  if (row >= P) return;  // a pad slot
  int r = amt_clamp(run_of[k], rcap);
  t_row[amt_clamp(row, P)] = dist[r] - (k - run_start[r]);
}

__global__ void lc_final(const int* __restrict__ first_child,
                         const bool* __restrict__ is_elem,
                         const int* __restrict__ obj_dense,
                         const int* __restrict__ t_row, int P,
                         int* __restrict__ elem_index) {
  int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= P) return;
  int out = -1;
  // the chain start: the first child of the row's object root
  int start = first_child[amt_clamp(P + obj_dense[r], 2 * P + 3)];
  if (is_elem[r] && start >= 0) out = t_row[amt_clamp(start, P)] - t_row[r];
  elem_index[r] = out;
}

// first_child/next_sib: int32 [N = 2P+3]; is_elem bool [P]; elem_ref,
// obj_dense, aorder: int32 [P].
// scratch: int32 [5P + 8(rcap+1) + 3 nb + 2], nb = ceil(P / LC_SCAN):
// kpos, sib_k, run_of, last, t_row; run_start, run_len, ans x2, jump x2
// (then nxt x2), dist x2; the block totals; (run count, element count)
// last. flag_buf: uint8 [P + 2 rcap] (slot flags, done x2).
// rounds = ceil_log2(rcap) + 1.
AMT_API int amt_linearize_condensed(const int* first_child, const int* next_sib,
                                    const bool* is_elem, const int* elem_ref,
                                    const int* obj_dense, const int* aorder,
                                    int P, int rcap, int rounds,
                                    int* scratch, unsigned char* flag_buf,
                                    int* elem_index, cudaStream_t stream,
                                    int* launched) {
  if (P <= 0 || rcap <= 0) return (int)cudaErrorInvalidValue;
  long long R1 = (long long)rcap + 1;
  int nb = (P + LC_SCAN - 1) / LC_SCAN;
  int* kpos = scratch;
  int* sib_k = kpos + P;
  int* run_of = sib_k + P;
  int* last = run_of + P;
  int* t_row = last + P;
  int* rt = t_row + P;
  int* run_start = rt;
  int* run_len = rt + R1;
  int* ans[2] = {rt + 2 * R1, rt + 3 * R1};
  int* jump[2] = {rt + 4 * R1, rt + 5 * R1};
  int* dist[2] = {rt + 6 * R1, rt + 7 * R1};
  int* bsum = rt + 8 * R1;
  int* bmax = bsum + nb;
  int* bval = bmax + nb;
  int* totals = bval + nb;
  unsigned char* flags = flag_buf;
  unsigned char* done[2] = {flag_buf + P, flag_buf + P + rcap};

  lc_init<<<amt_blocks(P > rcap ? P : rcap), AMT_THREADS, 0, stream>>>(
      P, rcap, kpos, t_row, run_start);
  AMT_LAUNCHED;
  lc_slots<<<nb, LC_SCAN, 0, stream>>>(first_child, next_sib, is_elem,
                                       elem_ref, aorder, P, kpos, sib_k,
                                       run_of, last, flags, bsum, bmax, bval);
  AMT_LAUNCHED;
  lc_scan_totals<<<1, LC_SCAN, 0, stream>>>(nb, bsum, bmax, bval, totals);
  AMT_LAUNCHED;
  lc_fixup<<<nb, LC_SCAN, 0, stream>>>(P, rcap, bsum, bmax, flags, run_of,
                                       last, run_start);
  AMT_LAUNCHED;
  int rblocks = amt_blocks(rcap);
  lc_runs_init<<<rblocks, AMT_THREADS, 0, stream>>>(
      elem_ref, aorder, kpos, run_of, last, sib_k, run_start, totals, P, rcap,
      run_len, ans[0], done[0], jump[0]);
  AMT_LAUNCHED;
  int cur = 0;
  for (int t = 0; t < rounds; ++t, cur ^= 1) {
    lc_climb<<<rblocks, AMT_THREADS, 0, stream>>>(ans[cur], done[cur],
                                                  jump[cur], rcap,
                                                  ans[cur ^ 1], done[cur ^ 1],
                                                  jump[cur ^ 1]);
    AMT_LAUNCHED;
  }
  // the climb answers are final; the jump buffers now carry nxt
  int* nxt[2] = {jump[0], jump[1]};
  int eblocks = amt_blocks(R1);
  lc_succ<<<eblocks, AMT_THREADS, 0, stream>>>(
      first_child, aorder, kpos, run_of, last, sib_k, run_start, run_len,
      ans[cur], totals, P, rcap, dist[0], nxt[0]);
  AMT_LAUNCHED;
  cur = 0;
  for (int t = 0; t < rounds; ++t, cur ^= 1) {
    lc_rank<<<eblocks, AMT_THREADS, 0, stream>>>(dist[cur], nxt[cur], (int)R1,
                                                 dist[cur ^ 1], nxt[cur ^ 1]);
    AMT_LAUNCHED;
  }
  lc_broadcast<<<amt_blocks(P), AMT_THREADS, 0, stream>>>(
      aorder, run_of, run_start, dist[cur], P, rcap, t_row);
  AMT_LAUNCHED;
  lc_final<<<amt_blocks(P), AMT_THREADS, 0, stream>>>(
      first_child, is_elem, obj_dense, t_row, P, elem_index);
  AMT_LAUNCHED;
  return (int)cudaGetLastError();
}
