// linearize_condensed: document-order element indices by chain
// condensation, all on the device.
//
// Replaces automerge_tpu/ops/merge.py device_linearize_condensed
// (:303-494). The insert rows are laid out in actor order (aorder: slot k
// holds row aorder[k], pad slots P); there a typing chain is a contiguous
// stretch of slots, each the first child of the slot before: a run. The
// reference climbs the runs' parents and ranks the run list by two
// doubling loops of ceil_log2(rcap)+1 rounds each. Here the runs become
// a condensed Euler tour (K7's tour over rows, linearize.cu, with each
// run's slots folded together) whose successors are all local, ranked by
// K7's ruling set (tour.cuh), in eight launches whatever rcap:
//   0. one memset: kpos and the scan tiles' states to -1;
//   1. lc_slots, four slots a thread (4,096 a tile): kpos[row] = k and
//      the slot's facts (the run break, the sibling flag, the next sibling
//      or parent), then one scan of (breaks, exit nodes, the last break
//      slot) carried across tiles by decoupled look-back (tiles numbered in
//      the order they start, so a tile only waits on running ones; a
//      tile's state and sums one 16-byte word, so no fence between them;
//      32 tiles read at once): each slot's run, its exit node and its
//      run's start; the last tile writes the run and exit-node counts. It
//      also clears lc_succ's marks and the ruler counters;
//   2. lc_succ builds the tour. In K7's tour enter(v) goes to enter(first
//      child), else to exit(v); exit(v) to enter(next sibling), else to
//      exit(parent). Over a run v1..vk the enter slots are consecutive:
//      one enter node (id: the run's index) of weight k. Its exit slots
//      fall through from vk down to the first member that has a next
//      sibling, which goes to that sibling's run: so the exit slots cut
//      into segments, one exit node (weight 0) each, bottoming at a
//      sibling-bearing slot or at the head. Every sibling-bearing slot and
//      every head is an exit node, and the node holding exit(k) is the
//      last of them at or before k: its index is the scan's count, so no
//      lookup is needed. The enter node goes to the tail's first child's
//      run, else to the tail's exit node; a sibling-bearing exit node to
//      its sibling's run; a head's exit node to the exit node holding its
//      parent's slot (none for parents < 0: object roots end the climb).
//      That is the reference's climb answer (:419-435) without the climb:
//      its "A within the parent's run prefix" is that exit node's own
//      successor, and "else the parent run's climb" is the head's exit
//      node of the parent's run. A sibling names a run head, so the tour
//      has at most 3R nodes. lc_succ also marks each node its successor
//      names and picks the level-1 rulers (one in max(4, cbrt(M / 6144))
//      of the M nodes, from the count on the device);
//   3. lt_walk1 over the tour (walkers: the rulers and the nodes no
//      successor names; a grid for 3 rcap nodes, more taken in turn),
//      4-7. lt_rank_levels (levels 2 and 3, the block, the sums to each
//      level-1 ruler), as K7's, but each level keeps at most one ruler in
//      four: a small tour (typing's, ~40k nodes) then sends a few hundred
//      rulers to the block, not 6,144 (the walks are short, the block's
//      time falls from ~19 to ~5 us);
//   8. lc_final: elem_index = T(start(obj)) - T(row), T of a slot being
//      its run's enter rank less its offset in the run (the reference's
//      broadcast, :463-479), computed where it is read; the start is read
//      from the object's root (:490-494); rows outside aorder have T 0.
// The reference's reading is kept: every gather index clamped (as XLA
// clamps), rows outside aorder read slot 0 (kpos 0) where the reference
// gathers kpos, a slot continues its run iff its row is its parent
// element's first child and the parent's is the slot before. The run
// count goes to scratch[0]: the wrapper raises when it exceeds rcap (the
// reference assumes it fits), and lc_succ builds nothing then. The
// reference's obj_cap arm (:481-488) reads the same roots through a
// table; it exists there to pack the winner key, so it is not ported.
//
// Bound: bytes. is_elem and aorder read in full (5P); elem_ref, next_sib
// and obj_dense at the element rows, first_child at their parents and at
// the object roots; elem_index (4P) written. The design writes and reads
// a 16-byte record a slot and about 32 bytes a tour node more, in L2 at
// the fan-ins' sizes; its walks are dependent L2 loads, as K7's.
#include "tour.cuh"

#define LC_THREADS 1024  // a scan tile's threads
#define LC_ITEMS 4  // its slots a thread, striped: k = base + j * LC_THREADS + t
#define LC_TILE (LC_THREADS * LC_ITEMS)
#define LC_FULL 0xffffffffu
#define LC_MIN_STRIDE 4  // one ruler in at least 4 at every level

enum { LC_VALID = 1, LC_BRK = 2, LC_FLAG = 4 };
enum { LC_AGGREGATE = 1, LC_PREFIX = 2 };  // a tile's published state

// Inclusive scan over the block's threads of (a: sum, b: sum, m: max);
// every thread gets the block totals ta, tb, tm. All threads call it.
__device__ void lc_block_scan(int& a, int& b, int& m, int& ta, int& tb, int& tm,
                              int* sh) {
  int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int nw = blockDim.x >> 5;
  for (int o = 1; o < 32; o <<= 1) {
    int ua = __shfl_up_sync(LC_FULL, a, o);
    int ub = __shfl_up_sync(LC_FULL, b, o);
    int um = __shfl_up_sync(LC_FULL, m, o);
    if (lane >= o) {
      a += ua;
      b += ub;
      m = max(m, um);
    }
  }
  if (lane == 31) {
    sh[warp] = a;
    sh[32 + warp] = b;
    sh[64 + warp] = m;
  }
  __syncthreads();
  if (warp == 0) {
    int wa = lane < nw ? sh[lane] : 0;
    int wb = lane < nw ? sh[32 + lane] : 0;
    int wm = lane < nw ? sh[64 + lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      int ua = __shfl_up_sync(LC_FULL, wa, o);
      int ub = __shfl_up_sync(LC_FULL, wb, o);
      int um = __shfl_up_sync(LC_FULL, wm, o);
      if (lane >= o) {
        wa += ua;
        wb += ub;
        wm = max(wm, um);
      }
    }
    sh[lane] = wa;
    sh[32 + lane] = wb;
    sh[64 + lane] = wm;
  }
  __syncthreads();
  if (warp > 0) {
    a += sh[warp - 1];
    b += sh[32 + warp - 1];
    m = max(m, sh[64 + warp - 1]);
  }
  ta = sh[nw - 1];
  tb = sh[32 + nw - 1];
  tm = sh[64 + nw - 1];
  __syncthreads();
}

// A tile's published state {status, breaks, exit nodes, last break slot}
// (status -1, then LC_AGGREGATE with the tile's own sums, then LC_PREFIX
// with the sums of every slot up to its end), read and written as one
// 16-byte word, so that no fence is needed between status and sums.
__device__ __forceinline__ int4 lc_load_state(const int4* p) {
  int4 v;
  asm volatile("ld.volatile.global.v4.s32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void lc_store_state(int4* p, int4 v) {
  asm volatile("st.volatile.global.v4.s32 [%0], {%1, %2, %3, %4};" ::"l"(p),
               "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

// The tile's exclusive prefix (ea, eb, em) from the tiles before it, by
// warp 0: its aggregate (ta, tb, tm) published first, then the states of
// 32 tiles before it read at once, back to the nearest with its inclusive
// prefix out; its own prefix published last. Tiles are numbered in the
// order they start, so every tile waited on is running or done.
__device__ void lc_look_back(int tile, int ta, int tb, int tm, int4* state,
                             int& ea, int& eb, int& em) {
  int lane = threadIdx.x & 31;
  if (lane == 0 && tile > 0)
    lc_store_state(state + tile, make_int4(LC_AGGREGATE, ta, tb, tm));
  ea = eb = em = 0;
  for (int top = tile - 1; top >= 0; top -= 32) {
    int j = top - lane;
    int4 v = make_int4(LC_PREFIX, 0, 0, 0);
    if (j >= 0) {
      do {
        v = lc_load_state(state + j);
      } while (v.x < LC_AGGREGATE);
    }
    unsigned pm = __ballot_sync(LC_FULL, j >= 0 && v.x == LC_PREFIX);
    int stop = pm ? __ffs(pm) - 1 : 31;  // the nearest tile with its prefix
    if (j < 0 || lane > stop) v = make_int4(0, 0, 0, 0);
    for (int o = 16; o > 0; o >>= 1) {
      v.y += __shfl_xor_sync(LC_FULL, v.y, o);
      v.z += __shfl_xor_sync(LC_FULL, v.z, o);
      v.w = max(v.w, __shfl_xor_sync(LC_FULL, v.w, o));
    }
    ea += v.y;
    eb += v.z;
    em = max(em, v.w);
    if (pm) break;
  }
  if (lane == 0)
    lc_store_state(state + tile, make_int4(LC_PREFIX, ea + ta, eb + tb, max(em, tm)));
}

// ticket: the last tile taken (starts at -1); state[t]: tile t's state
// (starts at -1, see lc_load_state). srec[k] = {run, exit
// node index, run start, next sibling if the slot bears one else the
// row's elem_ref}; totals = {runs, exit nodes}. A tile is LC_TILE slots,
// LC_ITEMS a thread, scanned chunk by chunk (LC_THREADS slots a chunk).
__global__ void __launch_bounds__(LC_THREADS)
    lc_slots(const int* __restrict__ first_child,
             const int* __restrict__ next_sib, const bool* __restrict__ is_elem,
             const int* __restrict__ elem_ref, const int* __restrict__ aorder,
             int P, int nb, int* __restrict__ kpos, int* ticket, int4* state,
             int4* __restrict__ srec, unsigned char* __restrict__ flags,
             int* __restrict__ totals, int* __restrict__ counters,
             unsigned char* __restrict__ marks, long long n_marks) {
  __shared__ int sh[96];
  __shared__ int tile_sh, pre_a, pre_b, pre_m;
  if (threadIdx.x == 0) tile_sh = atomicAdd(ticket, 1) + 1;
  __syncthreads();
  int tile = tile_sh;
  int base = tile * LC_TILE + threadIdx.x;
  int brk[LC_ITEMS], fl[LC_ITEMS], valid[LC_ITEMS], w[LC_ITEMS];
#pragma unroll
  for (int j = 0; j < LC_ITEMS; ++j) {
    int k = base + j * LC_THREADS;
    brk[j] = fl[j] = valid[j] = w[j] = 0;
    if (k < P) {
      int row = aorder[k];
      valid[j] = row < P;
      if (valid[j]) {
        int rc = amt_clamp(row, P);
        kpos[rc] = k;
        int er = elem_ref[rc];
        bool ie = is_elem[rc];
        int sib = ie ? next_sib[rc] : 0;
        // rc continues a chain iff it is its parent element's first child
        // and the parent's slot is the one before
        bool cont = ie && er >= 0 && er < P && is_elem[er] && first_child[er] == rc;
        int prev = k == 0 ? P : aorder[k - 1];
        brk[j] = !(cont && er == prev);
        fl[j] = ie && sib != -1;
        w[j] = fl[j] ? sib : er;
      }
    }
  }
  // (breaks, exit nodes, the last break slot): chunk by chunk over the
  // tile, then over the tiles before it
  int a[LC_ITEMS], b[LC_ITEMS], m[LC_ITEMS];
  int ca = 0, cb = 0, cm = 0;
#pragma unroll
  for (int j = 0; j < LC_ITEMS; ++j) {
    int ta, tb, tm;
    a[j] = brk[j];
    b[j] = brk[j] | fl[j];
    m[j] = brk[j] ? base + j * LC_THREADS : 0;
    lc_block_scan(a[j], b[j], m[j], ta, tb, tm, sh);
    a[j] += ca;
    b[j] += cb;
    m[j] = max(m[j], cm);
    ca += ta;
    cb += tb;
    cm = max(cm, tm);
  }
  if (threadIdx.x < 32) {
    int ea, eb, em;
    lc_look_back(tile, ca, cb, cm, state, ea, eb, em);
    if (threadIdx.x == 0) {
      pre_a = ea;
      pre_b = eb;
      pre_m = em;
      if (tile == nb - 1) {
        totals[0] = ea + ca;
        totals[1] = eb + cb;
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < LC_ITEMS; ++j) {
    int k = base + j * LC_THREADS;
    if (k < P) {
      srec[k] = make_int4(pre_a + a[j] - 1, pre_b + b[j] - 1, max(pre_m, m[j]), w[j]);
      flags[k] = (valid[j] ? LC_VALID : 0) | (brk[j] ? LC_BRK : 0) |
                 (fl[j] ? LC_FLAG : 0);
    }
  }
  int t = tile * LC_THREADS + threadIdx.x;
  for (long long i = t; i < n_marks; i += (long long)nb * LC_THREADS) marks[i] = 0;
  if (t < 4) counters[t] = 0;
}

// the slot of a row (0 for a row outside aorder, as the reference's kpos)
__device__ __forceinline__ int lc_slot(const int* __restrict__ kpos, int row, int P) {
  return max(kpos[amt_clamp(row, P)], 0);
}

// the level-1 ruler threshold for a tour of M nodes: one node in
// max(4, round(cbrt(M / LT_R3_TARGET))), so that the three levels'
// strides are equal (kernels/linearize.py ruler_stride, on the device)
__device__ __forceinline__ unsigned lc_threshold(int M) {
  int stride = max(LC_MIN_STRIDE, (int)lrint(cbrt((double)M / (double)LT_R3_TARGET)));
  return (unsigned)(4294967296ULL / (unsigned long long)stride);
}

// The tour: node[id] = {successor, level-1 ruler id or -1}; wlen[run] the
// enter node's weight; marks[id] = 1 where a successor names the node.
// One thread a slot: a run's tail writes its enter node, a head or a
// sibling-bearing slot its exit node.
__global__ void __launch_bounds__(AMT_THREADS)
    lc_succ(const int* __restrict__ first_child, const int* __restrict__ aorder,
            const int* __restrict__ kpos, const int4* __restrict__ srec,
            const unsigned char* __restrict__ flags,
            const int* __restrict__ totals, int P, int rcap, int r1cap,
            int2* __restrict__ node, int* __restrict__ wlen,
            unsigned char* __restrict__ marks, unsigned char* __restrict__ pred2,
            int* __restrict__ counters) {
  int R = totals[0];
  if (R > rcap) return;  // the wrapper raises (every thread returns)
  int M = R + totals[1];
  int k = blockIdx.x * blockDim.x + threadIdx.x;
  int f = k < P ? flags[k] : 0;
  int e_id = -1, e_succ = -1, len = 0, x_id = -1, x_succ = -1;
  bool tail = (f & LC_VALID) &&
              !(k + 1 < P && (flags[k + 1] & (LC_VALID | LC_BRK)) == LC_VALID);
  if (tail || (f & (LC_BRK | LC_FLAG))) {  // most slots of a chain are neither
    int4 sr = srec[k];
    if (tail && sr.x >= 0) {
      e_id = sr.x;
      len = k - sr.z + 1;
      int fc = first_child[amt_clamp(aorder[k], P)];
      e_succ = fc >= 0 ? max(srec[lc_slot(kpos, fc, P)].x, 0) : R + max(sr.y, 0);
    }
    if (f & (LC_BRK | LC_FLAG)) {
      x_id = R + sr.y;
      if (f & LC_FLAG)
        x_succ = sr.w >= 0 ? max(srec[lc_slot(kpos, sr.w, P)].x, 0) : -1;
      else
        x_succ = sr.w >= 0 ? R + max(srec[lc_slot(kpos, sr.w, P)].y, 0) : -1;
    }
  }
  unsigned t1 = lc_threshold(M);
  bool re = e_id >= 0 && lt_weyl((unsigned)e_id) < t1;
  bool rx = x_id >= 0 && lt_weyl((unsigned)x_id) < t1;
  int id = lt_block_ids((int)re + (int)rx, &counters[0]);
  if (e_id >= 0) {
    int rid = -1;
    if (re) {
      if (id < r1cap) rid = id;
      ++id;
    }
    node[e_id] = make_int2(e_succ, rid);
    wlen[e_id] = len;
    if (e_succ >= 0) marks[e_succ] = 1;
    if (rid >= 0) pred2[rid] = 0;
  }
  if (x_id >= 0) {
    int rid = rx && id < r1cap ? id : -1;
    node[x_id] = make_int2(x_succ, rid);
    if (x_succ >= 0) marks[x_succ] = 1;
    if (rid >= 0) pred2[rid] = 0;
  }
}

// the condensed tour for lt_walk1: its sizes read from the device (no
// node when the runs exceed rcap); a ruler or a node no successor names
// walks; enter nodes (ids below R) weigh their runs, exit nodes 0
struct LcTour {
  const int2* __restrict__ node;
  const int* __restrict__ wlen;
  const unsigned char* __restrict__ marks;
  const int* __restrict__ totals;
  int rcap;
  int R, M;
  __device__ __forceinline__ LcTour bind() const {
    LcTour t = *this;
    t.R = totals[0];
    t.M = t.R > rcap ? 0 : t.R + totals[1];
    return t;
  }
  __device__ __forceinline__ int nodes() const { return M; }
  __device__ __forceinline__ int2 rec(int s) const { return node[s]; }
  __device__ __forceinline__ bool walks(int s, int rid) const {
    return rid >= 0 || !marks[s];
  }
  __device__ __forceinline__ int weight(int s) const { return s < R ? wlen[s] : 0; }
};

// T of a row: its run's enter rank less its offset in the run; 0 for a
// row outside aorder
__device__ __forceinline__ unsigned lc_t(int row, const int* __restrict__ kpos,
                                         const int4* __restrict__ srec, int R,
                                         const int2* __restrict__ op1,
                                         const int2* __restrict__ tw1,
                                         const int* __restrict__ D1, int cap,
                                         int r1cap) {
  int k = kpos[row];
  if (k < 0) return 0;
  int4 sr = srec[k];
  unsigned d = sr.x >= 0 && sr.x < R ? lt_dist(sr.x, op1, tw1, D1, cap, r1cap) : 0u;
  return d - (unsigned)(k - sr.z);
}

__global__ void lc_final(const int* __restrict__ first_child,
                         const bool* __restrict__ is_elem,
                         const int* __restrict__ obj_dense,
                         const int* __restrict__ kpos,
                         const int4* __restrict__ srec,
                         const int* __restrict__ totals, int P, int cap,
                         const int2* __restrict__ op1, const int2* __restrict__ tw1,
                         const int* __restrict__ D1, int r1cap,
                         int* __restrict__ elem_index) {
  int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= P) return;
  // the chain start: the first child of the row's object root
  int start = first_child[amt_clamp(P + obj_dense[r], 2 * P + 3)];
  if (!is_elem[r] || start < 0) {
    elem_index[r] = -1;
    return;
  }
  int R = totals[0];
  unsigned ts = lc_t(amt_clamp(start, P), kpos, srec, R, op1, tw1, D1, cap, r1cap);
  unsigned tr = lc_t(r, kpos, srec, R, op1, tw1, D1, cap, r1cap);
  elem_index[r] = (int)(ts - tr);
}

static long long lc_round4(long long words) { return (words + 3) / 4 * 4; }

// int32 words of the scratch (kernels/linearize_condensed.py
// scratch_words): totals 4; the tiles' states 4 nb, the ticket 4 and
// kpos P (one fill); srec 4P; wlen rcap; for cap = rcap + P
// tour nodes node, op1, tw1 2 each; then the levels' state
static long long lc_scratch_words(long long P, long long rcap, long long r1cap) {
  long long nb = (P + LC_TILE - 1) / LC_TILE, cap = rcap + P;
  return 4 + 4 * nb + 4 + lc_round4(P) + 4 * P + lc_round4(rcap) +
         lc_round4(6 * cap) + lt_levels_words(r1cap);
}

// first_child/next_sib: int32 [N = 2P+3]; is_elem bool [P]; elem_ref,
// obj_dense, aorder: int32 [P]; r1cap >= 1: the most level-1 rulers kept;
// scratch: int32 [scratch_words] >= lc_scratch_words(P, rcap, r1cap),
// 16-byte aligned; scratch[0] gets the run count, scratch[1] the exit
// nodes; flag_buf: uint8 [flag_bytes] >= P + rcap + P. P, rcap < 2^29.
AMT_API int amt_linearize_condensed(const int* first_child, const int* next_sib,
                                    const bool* is_elem, const int* elem_ref,
                                    const int* obj_dense, const int* aorder,
                                    int P, int rcap, int r1cap, int* scratch,
                                    long long scratch_words,
                                    unsigned char* flag_buf,
                                    long long flag_bytes, int* elem_index,
                                    cudaStream_t stream, int* launched) {
  if (P <= 0 || rcap <= 0 || r1cap < 1 || P >= (1 << 29) || rcap >= (1 << 29))
    return (int)cudaErrorInvalidValue;
  long long cap = (long long)rcap + P;
  if (scratch_words < lc_scratch_words(P, rcap, r1cap) || flag_bytes < P + cap)
    return (int)cudaErrorInvalidValue;
  int nb = (P + LC_TILE - 1) / LC_TILE;
  int* at = scratch;
  int* totals = at;        at += 4;
  int4* state = (int4*)at; at += 4LL * nb;
  int* ticket = at;        at += 4;
  int* kpos = at;          at += lc_round4(P);
  int4* srec = (int4*)at;  at += 4LL * P;
  int* wlen = at;          at += lc_round4(rcap);
  int2* node = (int2*)at;  at += 2 * cap;
  int2* op1 = (int2*)at;   at += 2 * cap;
  int2* tw1 = (int2*)at;
  at = (int*)node + lc_round4(6 * cap);  // the levels 16-byte aligned
  LtLevels lv = lt_carve_levels(at, r1cap);
  unsigned char* flags = flag_buf;
  unsigned char* marks = flag_buf + P;

  cudaError_t e = cudaMemsetAsync(state, 0xFF, sizeof(int) * (4LL * nb + 4 + P), stream);
  if (e != cudaSuccess) return (int)e;
  lc_slots<<<nb, LC_THREADS, 0, stream>>>(first_child, next_sib, is_elem,
                                          elem_ref, aorder, P, nb, kpos, ticket,
                                          state, srec, flags, totals, lv.counters,
                                          marks, cap);
  AMT_LAUNCHED;
  lc_succ<<<amt_blocks(P), AMT_THREADS, 0, stream>>>(
      first_child, aorder, kpos, srec, flags, totals, P, rcap, r1cap, node, wlen,
      marks, lv.pred2, lv.counters);
  AMT_LAUNCHED;
  // a sibling names a run head, so a forest's tour has at most 3 rcap
  // nodes: the grid covers those, and takes any more in turn
  lt_walk1<<<amt_blocks(cap < 3LL * rcap ? cap : 3LL * rcap), AMT_THREADS, 0,
             stream>>>(LcTour{node, wlen, marks, totals, rcap, 0, 0}, (int)cap,
                       r1cap, LC_MIN_STRIDE, lv.counters, op1, tw1, lv.node2,
                       lv.pred2, lv.pred3);
  AMT_LAUNCHED;
  int err = lt_rank_levels(lv, r1cap, LC_MIN_STRIDE, stream, launched);
  if (err) return err;
  lc_final<<<amt_blocks(P), AMT_THREADS, 0, stream>>>(
      first_child, is_elem, obj_dense, kpos, srec, totals, P, (int)cap, op1, tw1,
      lv.D1, r1cap, elem_index);
  AMT_LAUNCHED;
  return (int)cudaGetLastError();
}
