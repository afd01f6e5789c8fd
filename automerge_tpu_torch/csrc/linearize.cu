// linearize: document-order element indices, all on the device.
//
// Replaces automerge_tpu/ops/merge.py device_linearize (:216-285):
// elem_index[r] = dist[start] - dist[r], where dist[x] counts the nodes of
// the preorder successor chain from element row x to its end (first child,
// else A(x): the next sibling of x or of its nearest element ancestor)
// and start is the first child of r's object root. The reference finds
// A(x) by pointer doubling over the parent chain and dist by Wyllie
// ranking, 2 * (ceil_log2(P + 1) + 1) rounds of gathers over all nodes.
//
// amt_linearize does the same O(P) work in eight launches, whatever P:
//   1. lt_clear zeroes the counters;
//   2. lt_succ gives each element row v two slots of an Euler tour, enter
//      2v and exit 2v+1. enter(v) goes to enter(first child), else to
//      exit(v); exit(v) to enter(next sibling), else to exit(parent) when
//      the parent is an element, else the list ends. Every successor is
//      local: the threading loop is gone. The list heads are read off the
//      forest's layout, and the level-1 rulers picked: element slots
//      whose Weyl hash falls under t1 (one in the host's stride, about
//      cbrt(2P / LT_R3_TARGET)), numbered by one atomicAdd a block
//      (thousands on one address would queue);
//   3. lt_walk1: every ruler and every list head walks its sublist to the
//      next ruler, writing each slot's walker and weighted prefix (enter
//      slots weigh 1, exit slots 0), then its total and the ruler it
//      reached. Each ruler picks itself as a level-2 ruler by a second
//      hash, one in sqrt(R1 / LT_R3_TARGET), keeping its level-1 id;
//   4. lt_walk_rulers, level 2: the same over the list of the level-1
//      rulers, weighted by their totals, picking the level-3 rulers with
//      the same chance (about LT_R3_TARGET, one atomicAdd a block);
//   5. lt_walk_rulers, level 3: the same over the level-2 rulers;
//   6. lt_rank_block: one block ranks the level-3 rulers in shared memory
//      (a fourth walk there, then Wyllie's doubling over its own rulers);
//   7. lt_push: each level-1 ruler's rank, summed down levels 3 and 2;
//   8. lt_final: dist of a slot is its walker's total less its prefix,
//      plus the rank of the ruler it reached; elem_index follows.
// Each level's walks take about stride * ln(rulers) dependent loads, so
// three levels of stride ~5 beat two of stride ~11; the block's walk in
// shared memory costs a fraction of one in L2.
// dist[x] is the weight from enter(x) to the end of its list: the enter
// slots of the nodes of x's chain, which is what the reference counts.
// The edge cases keep the reference's reading: first_child > P counts
// as none, first_child == P or < -1 (and next_sib >= P or < -1) end the
// chain, an element whose elem_ref < 0 or whose parent is no element
// climbs to no sibling, and the start index is clamped. The rows that are
// no elements take no part: no element's chain passes through one, and
// elem_index reads dist at element rows only.
//
// Bound: bytes. first_child and next_sib over the rows [0, P) (8P),
// elem_ref, obj_dense (8P), is_elem (1P) and first_child at the object
// roots the elements reach are read once, elem_index (4P) written once;
// the root and sentinel slots [P, N) are otherwise never read. The
// design writes and reads a 16-byte record per row and 16 bytes per slot
// more (about 60P bytes, in L2 at the fan-ins' P), and its time is set
// by the longest walk of each level, dependent L2 loads.
//
// The sharded merge (automerge_tpu/parallel/sharding.py) drives the
// reference's loops round by round instead; its range entries below keep
// them: li_init, li_thread (one threading round), li_rank_init, li_rank
// (one Wyllie round) and li_final. Every round reads only the previous
// round's state (the reference's loop body is a pure function of it), so
// the state lives in ping-pong buffers: an in-place `jump = jump[jump]`
// would race.
#include "common.cuh"

__global__ void li_init(const int* __restrict__ first_child,
                        const int* __restrict__ next_sib,
                        const bool* __restrict__ is_elem,
                        const int* __restrict__ elem_ref, int P, int Epad,
                        int* __restrict__ ans, bool* __restrict__ done,
                        int* __restrict__ jump, int* __restrict__ fc_e) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= Epad) return;
  if (i > P) {  // padding past the sentinel: a fixed point of the loops
    ans[i] = -1;
    done[i] = true;
    jump[i] = P;
    fc_e[i] = -1;
    return;
  }
  int ns = -1, fc = -1, pe = P;
  bool ie = false;
  if (i < P) {
    ns = next_sib[i];
    fc = first_child[i];
    if (fc > P) fc = -1;  // child refs are always < P
    ie = is_elem[i];
    int er = elem_ref[i];
    if (ie && er >= 0) pe = er;
  }
  bool has_sib = ns != -1;
  done[i] = has_sib || !ie || pe == P;
  ans[i] = (has_sib && ie) ? ns : -1;
  jump[i] = pe;
  fc_e[i] = fc;
}

// one round over the nodes [i0, i0+count) of the E-node state; the
// outputs are written from index 0
__global__ void li_thread(const int* __restrict__ ans0,
                          const bool* __restrict__ done0,
                          const int* __restrict__ jump0, int E, int i0,
                          int count, int* __restrict__ ans1,
                          bool* __restrict__ done1, int* __restrict__ jump1) {
  int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= count) return;
  int i = i0 + k;
  int j = amt_clamp(jump0[i], E);
  bool d = done0[i];
  bool take = !d && done0[j];
  ans1[k] = take ? ans0[j] : ans0[i];
  done1[k] = d || take;
  jump1[k] = jump0[j];
}

__global__ void li_rank_init(const int* __restrict__ fc_e,
                             const int* __restrict__ ans, int P, int Epad,
                             int* __restrict__ dist, int* __restrict__ nxt) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= Epad) return;
  if (i > P) {  // padding: dist 0, nxt the sentinel
    nxt[i] = P;
    dist[i] = 0;
    return;
  }
  int s = fc_e[i] != -1 ? fc_e[i] : ans[i];
  nxt[i] = (s < 0 || i == P) ? P : s;
  dist[i] = i == P ? 0 : 1;
}

__global__ void li_rank(const int* __restrict__ dist0,
                        const int* __restrict__ nxt0, int E, int i0,
                        int count, int* __restrict__ dist1,
                        int* __restrict__ nxt1) {
  int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= count) return;
  int i = i0 + k;
  int j = amt_clamp(nxt0[i], E);
  dist1[k] = (int)((unsigned)dist0[i] + (unsigned)dist0[j]);
  nxt1[k] = nxt0[j];
}

__global__ void li_final(const int* __restrict__ first_child,
                         const bool* __restrict__ is_elem,
                         const int* __restrict__ obj_dense,
                         const int* __restrict__ dist, int P, int r0,
                         int count, int* __restrict__ elem_index) {
  int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= count) return;
  int r = r0 + k;
  int N = 2 * P + 3;
  // chain start per row: its object root's first child
  int start = first_child[amt_clamp(P + obj_dense[r], N)];
  elem_index[k] = (is_elem[r] && start >= 0)
                      ? dist[amt_clamp(start, P)] - dist[r]
                      : -1;
}

// -- the single-device entry: an Euler tour ranked by a ruling set -------------

#define LT_END (-1)
#define LT_HEAD (-2)      // node1's ruler field: a list head that is no ruler
#define LT_INACTIVE (-3)  // node1's ruler field: a row that is no element
#define LT_FULL 0xffffffffu
#define LT_WARPS (AMT_THREADS / 32)
// the level-3 rulers, ranked by one block in shared memory
#define LT_R3_CAP 10240
#define LT_R3_TARGET 6144u
#define LT_BLOCK 1024
// the block's own rulers (level 4) among them, ranked by doubling
#define LT_R4_CAP 2048
#define LT_R4_TARGET 1024u

// one in stride of the slots s (a Weyl sequence: consecutive slots, as a
// typed chain visits them, are spread evenly)
__device__ __forceinline__ unsigned lt_weyl(unsigned s) { return s * 0x9E3779B9u; }

// independent hashes of a ruler's slot (murmur3's finalizer) for the
// rulers of the levels above
__device__ __forceinline__ unsigned lt_mix(unsigned h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}
#define LT_SEED2 0u
#define LT_SEED3 0x5BD1E995u
#define LT_SEED4 0x27D4EB2Fu

// a ruler of the next level when hash * count < num (num / 2^32 / count
// is the chance)
__device__ __forceinline__ bool lt_pick(unsigned slot, unsigned seed, int count,
                                        unsigned long long num) {
  return (unsigned long long)lt_mix(slot ^ seed) * (unsigned)count < num;
}

// the chance of a level-1 (level-2) ruler to be one of the next level,
// sqrt(LT_R3_TARGET / R1) each, as num for lt_pick over r1 rulers
__device__ __forceinline__ unsigned long long lt_level_num(int r1) {
  return (unsigned long long)(sqrt((double)LT_R3_TARGET * (double)r1) *
                              4294967296.0);
}

__global__ void lt_clear(int* __restrict__ counters) {
  if (threadIdx.x < 4) counters[threadIdx.x] = 0;
}

// Ids for the threads of a block that ask (want = 0, 1 or 2 each), from
// one atomicAdd on *counter a block: thousands on one address would
// queue. Every thread of the block calls it.
__device__ int lt_block_ids(int want, int* counter) {
  __shared__ int warp_base[LT_WARPS];
  int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = want;
  for (int o = 1; o < 32; o <<= 1) {
    int y = __shfl_up_sync(LT_FULL, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) warp_base[warp] = incl;
  __syncthreads();
  if (threadIdx.x == 0) {
    int sum = 0;
    for (int w = 0; w < LT_WARPS; ++w) {
      int c = warp_base[w];
      warp_base[w] = sum;
      sum += c;
    }
    int base = sum > 0 ? atomicAdd(counter, sum) : 0;
    for (int w = 0; w < LT_WARPS; ++w) warp_base[w] += base;
  }
  __syncthreads();
  return warp_base[warp] + incl - want;
}

// Element row v -> node1[v] = {succ(enter v), its ruler id, succ(exit v),
// its ruler id}: -1 ends a list; a ruler id is -1 for none, LT_HEAD for
// an enter slot that starts a list. A row that is no element has no
// slots (LT_INACTIVE): no element's chain passes through it.
//
// The heads are read off the forest, which links an element's children
// as a sibling list under its parent row (first_child the highest row,
// next_sib down the rows; the children of the object root P + obj, and
// of the node N - 1 for elem_ref < -1, alike): enter(v) has a
// predecessor when v's parent is an element (its enter goes to its first
// child, the others' from their previous siblings' exits), else only
// when v is not its parent's first child. An exit always has one (its
// own enter, or its last child's exit).
__global__ void __launch_bounds__(AMT_THREADS)
lt_succ(const int* __restrict__ first_child, const int* __restrict__ next_sib,
        const bool* __restrict__ is_elem, const int* __restrict__ elem_ref,
        const int* __restrict__ obj_dense, int P, unsigned t1, int r1cap,
        int4* __restrict__ node1, unsigned char* __restrict__ pred2,
        int* __restrict__ counters) {
  int v = blockIdx.x * blockDim.x + threadIdx.x;
  bool ie = v < P && is_elem[v];
  int se = LT_END, sx = LT_END;
  bool head = false;
  if (ie) {
    int fc = first_child[v];
    if (fc >= 0 && fc < P)
      se = 2 * fc;
    else if (fc == -1 || fc > P)
      se = 2 * v + 1;
    int er = elem_ref[v];
    bool elem_parent = er >= 0 && er < P && is_elem[er];
    int ns = next_sib[v];
    if (ns != -1) {
      if (ns >= 0 && ns < P) sx = 2 * ns;
    } else if (elem_parent) {
      sx = 2 * er + 1;
    }
    if (!elem_parent) {
      int N = 2 * P + 3;
      long long parent = er == -1 ? (long long)P + obj_dense[v] : er >= 0 ? er : N - 1;
      head = parent < 0 || parent >= N || first_child[parent] == v;
    }
  }
  bool re = ie && lt_weyl(2u * v) < t1;
  bool rx = ie && lt_weyl(2u * v + 1u) < t1;
  int id = lt_block_ids((int)re + (int)rx, &counters[0]);
  if (v >= P) return;
  if (!ie) {
    node1[v] = make_int4(LT_END, LT_INACTIVE, LT_END, LT_INACTIVE);
    return;
  }
  int rid_e = head ? LT_HEAD : -1, rid_x = -1;
  if (re) {
    if (id < r1cap) rid_e = id;
    ++id;
  }
  if (rx && id < r1cap) rid_x = id;
  node1[v] = make_int4(se, rid_e, sx, rid_x);
  if (rid_e >= 0) pred2[rid_e] = 0;
  if (rid_x >= 0) pred2[rid_x] = 0;
}

// Level 1. Slot s walks when it is a ruler or a list head; node1 is read
// per slot as {succ, ruler id}; op1[slot] = {walker, prefix}, tw1[walker]
// = {total, ruler reached or -1}. A ruler also writes node2[its id] =
// {next ruler, total, its id again if it is a level-2 ruler else -1, its
// slot}: a level-2 ruler keeps its level-1 id, so no atomic is needed.
__global__ void lt_walk1(const int2* __restrict__ node1, int slots, int r1cap,
                         const int* __restrict__ counters,
                         int2* __restrict__ op1, int2* __restrict__ tw1,
                         int4* __restrict__ node2,
                         unsigned char* __restrict__ pred2,
                         unsigned char* __restrict__ pred3) {
  int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= slots) return;
  int2 nd = node1[s];
  int rid = nd.y;
  if (rid < 0 && rid != LT_HEAD) return;
  int cur = s, acc = 0, end = -1;
  for (int step = 0; step < slots; ++step) {  // bounded: a cycle cannot hang
    op1[cur] = make_int2(s, acc);
    acc += !(cur & 1);
    int nx = nd.x;
    if (nx < 0) break;
    nd = node1[nx];
    if (nd.y >= 0) {
      end = nd.y;
      break;
    }
    cur = nx;
  }
  tw1[s] = make_int2(acc, end);
  if (rid < 0) return;
  if (end >= 0) pred2[end] = 1;
  int r1 = min(counters[0], r1cap);
  bool up = lt_pick((unsigned)s, LT_SEED2, r1, lt_level_num(r1));
  if (up) pred3[rid] = 0;
  node2[rid] = make_int4(end, acc, up ? rid : -1, s);
}

// Levels 2 and 3: the same walk over the rulers of the level below, all
// indexed by their level-1 id (level 3 skips those that are no level-2
// ruler: member[r].z < 0); node = {next, weight, ruler id of this level
// or -1, slot}; op[node] = {walker, prefix}, tw[walker] = {total, ruler
// reached or -1}; a ruler writes node_out[its id] = {next ruler, total,
// next-level id, slot}. Level 2 also marks pred_out and picks the level-3
// rulers (ids from one atomicAdd a block, at most LT_R3_CAP); level 3
// picks none.
__global__ void __launch_bounds__(AMT_THREADS)
lt_walk_rulers(const int4* __restrict__ node, const int4* __restrict__ member,
               const unsigned char* __restrict__ pred, int r1cap,
               int* __restrict__ counters, int2* __restrict__ op,
               int2* __restrict__ tw, int4* __restrict__ node_out,
               unsigned char* __restrict__ pred_out) {
  int r = blockIdx.x * blockDim.x + threadIdx.x;
  int r1 = min(counters[0], r1cap);
  bool walks = r < r1 && (member == nullptr || member[r].z >= 0);
  int4 nd = make_int4(-1, 0, -1, 0);
  if (walks) {
    nd = node[r];
    walks = nd.z >= 0 || !pred[r];
  }
  int rid = nd.z, slot = nd.w;
  int acc = 0, end = -1;
  if (walks) {
    int cur = r;
    for (int step = 0; step < r1; ++step) {
      op[cur] = make_int2(r, acc);
      acc = (int)((unsigned)acc + (unsigned)nd.y);
      int nx = nd.x;
      if (nx < 0) break;
      nd = node[nx];
      if (nd.z >= 0) {
        end = nd.z;
        break;
      }
      cur = nx;
    }
    tw[r] = make_int2(acc, end);
  }
  bool ruler = walks && rid >= 0;
  int next = -1;
  if (pred_out != nullptr) {  // level 2
    bool up = ruler && lt_pick((unsigned)slot, LT_SEED3, r1, lt_level_num(r1));
    int id = lt_block_ids((int)up, &counters[2]);
    if (up && id < LT_R3_CAP) next = id;
    if (ruler && end >= 0) pred_out[end] = 1;
  }
  if (ruler) node_out[rid] = make_int4(end, acc, next, slot);
}

// The level-3 rulers (at most LT_R3_CAP) ranked by one block in shared
// memory: D3[x] = weight from ruler x to the end of its list. The block
// walks them as the levels below do (its own rulers, about LT_R4_TARGET,
// and the list heads walk; shared-memory loads cost a tenth of L2's),
// ranks its rulers by Wyllie's doubling, then sums. A node's record
// carries its next node and that node's block-ruler id, so that a step
// of a walk is one load.
__global__ void __launch_bounds__(LT_BLOCK)
lt_rank_block(const int4* __restrict__ node4, const int* __restrict__ counters,
              int* __restrict__ D3) {
  extern __shared__ int2 lt_smem[];
  int2* rec = lt_smem;                // {next | (its rid4 + 1) << 16, weight}
  int2* walk = rec + LT_R3_CAP;       // {walker, prefix}; a walker: {total, end}
  int2* dn = walk + LT_R3_CAP;        // [2][LT_R4_CAP] {rank, next}, ping-pong
  short* rid4 = (short*)(dn + 2 * LT_R4_CAP);
  unsigned char* pred = (unsigned char*)(rid4 + LT_R3_CAP);
  __shared__ int r4_count;
  int r3 = min(counters[2], LT_R3_CAP);
  if (threadIdx.x == 0) r4_count = 0;
  __syncthreads();
  for (int i = threadIdx.x; i < r3; i += LT_BLOCK) {
    int4 v = node4[i];
    rec[i] = make_int2(v.x, v.y);
    pred[i] = 0;
    bool up = lt_pick((unsigned)v.w, LT_SEED4, r3, (unsigned long long)LT_R4_TARGET << 32);
    unsigned m = __ballot_sync(__activemask(), up);
    int id = -1;
    if (up) {  // one shared atomic a warp
      int leader = __ffs(m) - 1;
      int base = 0;
      if ((int)(threadIdx.x & 31) == leader) base = atomicAdd(&r4_count, __popc(m));
      base = __shfl_sync(m, base, leader);
      id = base + __popc(m & ((1u << (threadIdx.x & 31)) - 1u));
      if (id >= LT_R4_CAP) id = -1;
    }
    rid4[i] = (short)id;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < r3; i += LT_BLOCK) {
    int j = rec[i].x;
    if (j >= 0) {
      pred[j] = 1;
      rec[i].x = j | (rid4[j] + 1) << 16;
    }
  }
  __syncthreads();
  int r4 = min(r4_count, LT_R4_CAP);
  for (int i = threadIdx.x; i < r3; i += LT_BLOCK) {
    int id = rid4[i];
    if (id < 0 && pred[i]) continue;
    int cur = i, acc = 0, end = -1;
    for (int step = 0; step < r3; ++step) {
      int2 rc = rec[cur];
      walk[cur] = make_int2(i, acc);
      acc = (int)((unsigned)acc + (unsigned)rc.y);
      if (rc.x < 0) break;
      int j = rc.x & 0xffff, up = rc.x >> 16;
      if (up > 0) {
        end = up - 1;
        break;
      }
      cur = j;
    }
    // no other walk reads a walker's own record
    rec[i] = make_int2(acc, end);
    if (id >= 0) dn[id] = make_int2(acc, end);
  }
  __syncthreads();
  int cur = 0;  // the half of dn that holds the current round
  for (int round = 0; round < 32 - __clz(LT_R4_CAP); ++round) {
    const int2* d0 = dn + cur * LT_R4_CAP;
    int2* d1 = dn + (cur ^ 1) * LT_R4_CAP;
    int active = 0;
    for (int i = threadIdx.x; i < r4; i += LT_BLOCK) {
      int2 a = d0[i];
      if (a.y >= 0) {
        int2 b = d0[a.y];
        a = make_int2((int)((unsigned)a.x + (unsigned)b.x), b.y);
        active = 1;
      }
      d1[i] = a;
    }
    cur ^= 1;
    if (!__syncthreads_or(active)) break;
  }
  const int2* dr = dn + cur * LT_R4_CAP;
  for (int i = threadIdx.x; i < r3; i += LT_BLOCK) {
    int2 wk = walk[i];
    int2 tot = rec[wk.x];
    unsigned d = (unsigned)tot.x - (unsigned)wk.y;
    if (tot.y >= 0) d += (unsigned)dr[tot.y].x;
    D3[i] = (int)d;
  }
}

// D1[r]: the weight from level-1 ruler r to the end of its list, through
// levels 2 and 3 and the block's ranks; indices clamped, so a ruler no
// walk reached (only on a cycle) reads garbage, never out of bounds
__global__ void lt_push(const int2* __restrict__ op2, const int2* __restrict__ tw2,
                        const int2* __restrict__ op3, const int2* __restrict__ tw3,
                        const int* __restrict__ D3, const int* __restrict__ counters,
                        int r1cap, int* __restrict__ D1) {
  int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= min(counters[0], r1cap)) return;
  int2 a = op2[r];
  int2 t = tw2[amt_clamp(a.x, r1cap)];
  unsigned d = (unsigned)t.x - (unsigned)a.y;
  if (t.y >= 0) {
    a = op3[min(t.y, r1cap - 1)];
    t = tw3[amt_clamp(a.x, r1cap)];
    d += (unsigned)t.x - (unsigned)a.y;
    if (t.y >= 0) d += (unsigned)D3[min(t.y, LT_R3_CAP - 1)];
  }
  D1[r] = (int)d;
}

// the weight from slot s to the end of its list: its walker's total less
// its prefix, plus that of the level-1 ruler the walker reached
__device__ __forceinline__ unsigned lt_dist(int s, const int2* __restrict__ op1,
                                            const int2* __restrict__ tw1,
                                            const int* __restrict__ D1, int slots,
                                            int r1cap) {
  int2 a = op1[s];
  int2 t = tw1[amt_clamp(a.x, slots)];
  unsigned d = (unsigned)t.x - (unsigned)a.y;
  return t.y < 0 ? d : d + (unsigned)D1[min(t.y, r1cap - 1)];
}

__global__ void lt_final(const int* __restrict__ first_child,
                         const bool* __restrict__ is_elem,
                         const int* __restrict__ obj_dense, int P,
                         const int2* __restrict__ op1, const int2* __restrict__ tw1,
                         const int* __restrict__ D1, int r1cap,
                         int* __restrict__ elem_index) {
  int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= P) return;
  int start = first_child[amt_clamp(P + obj_dense[r], 2 * P + 3)];
  if (!is_elem[r] || start < 0) {
    elem_index[r] = -1;
    return;
  }
  int slots = 2 * P;
  unsigned ds = lt_dist(2 * amt_clamp(start, P), op1, tw1, D1, slots, r1cap);
  unsigned dr = lt_dist(2 * r, op1, tw1, D1, slots, r1cap);
  elem_index[r] = (int)(ds - dr);
}

static long long lt_marks(long long bytes) { return (bytes + 15) / 16 * 4; }

// int32 words of amt_linearize's scratch (kernels/linearize.py
// scratch_words): node1, op1, tw1 4P each; for levels 2 and 3 (r1cap
// rulers each at most) node 4, op and tw 2 each a ruler; D1 1 a level-1
// ruler (rounded up to 4 words); node4 4 and D3 1 a level-3 ruler; 4
// counters; then the byte marks pred2 and pred3 [r1cap], each rounded up
// to 16 bytes
static long long lt_scratch_words(long long P, long long r1cap) {
  return 12 * P + 16 * r1cap + (r1cap + 3) / 4 * 4 + 5LL * LT_R3_CAP + 4 +
         2 * lt_marks(r1cap);
}

static const int LT_BLOCK_SMEM = (2 * LT_R3_CAP + 2 * LT_R4_CAP) * (int)sizeof(int2) +
                                 LT_R3_CAP * (int)sizeof(short) + LT_R3_CAP;

// first_child/next_sib: int32 [N = 2P+3], the forest's (the heads are
// read off its layout); elem_index: int32 [P]; t1: the level-1 ruler
// threshold (about 2^32 / stride); r1cap >= 1: the most level-1 rulers
// kept (a slot past it is simply no ruler); scratch: int32
// [scratch_words] >= lt_scratch_words(P, r1cap). P < 2^29.
AMT_API int amt_linearize(const int* first_child, const int* next_sib,
                          const bool* is_elem, const int* elem_ref,
                          const int* obj_dense, int P, unsigned t1, int r1cap,
                          int* scratch, long long scratch_words,
                          int* elem_index, cudaStream_t stream, int* launched) {
  if (P < 0 || P >= (1 << 29) || r1cap < 1) return (int)cudaErrorInvalidValue;
  if (scratch_words < lt_scratch_words(P, r1cap)) return (int)cudaErrorInvalidValue;
  if (P == 0) return (int)cudaGetLastError();
  int slots = 2 * P;
  int* at = scratch;
  int4* node1 = (int4*)at;  at += 4LL * P;
  int2* op1 = (int2*)at;    at += 4LL * P;
  int2* tw1 = (int2*)at;    at += 4LL * P;
  int4* node2 = (int4*)at;  at += 4LL * r1cap;
  int2* op2 = (int2*)at;    at += 2LL * r1cap;
  int2* tw2 = (int2*)at;    at += 2LL * r1cap;
  int4* node3 = (int4*)at;  at += 4LL * r1cap;
  int2* op3 = (int2*)at;    at += 2LL * r1cap;
  int2* tw3 = (int2*)at;    at += 2LL * r1cap;
  int* D1 = at;             at += (r1cap + 3) / 4 * 4;  // node4 16-byte aligned
  int4* node4 = (int4*)at;  at += 4LL * LT_R3_CAP;
  int* D3 = at;             at += LT_R3_CAP;
  int* counters = at;       at += 4;
  unsigned char* pred2 = (unsigned char*)at;
  unsigned char* pred3 = pred2 + 4 * lt_marks(r1cap);
  lt_clear<<<1, 32, 0, stream>>>(counters);
  AMT_LAUNCHED;
  // pred2 and pred3 are zeroed where a ruler gets its id
  lt_succ<<<amt_blocks(P), AMT_THREADS, 0, stream>>>(
      first_child, next_sib, is_elem, elem_ref, obj_dense, P, t1, r1cap, node1,
      pred2, counters);
  AMT_LAUNCHED;
  lt_walk1<<<amt_blocks(slots), AMT_THREADS, 0, stream>>>(
      (const int2*)node1, slots, r1cap, counters, op1, tw1, node2, pred2, pred3);
  AMT_LAUNCHED;
  lt_walk_rulers<<<amt_blocks(r1cap), AMT_THREADS, 0, stream>>>(
      node2, nullptr, pred2, r1cap, counters, op2, tw2, node3, pred3);
  AMT_LAUNCHED;
  lt_walk_rulers<<<amt_blocks(r1cap), AMT_THREADS, 0, stream>>>(
      node3, node2, pred3, r1cap, counters, op3, tw3, node4, nullptr);
  AMT_LAUNCHED;
  cudaError_t e = cudaFuncSetAttribute(
      lt_rank_block, cudaFuncAttributeMaxDynamicSharedMemorySize, LT_BLOCK_SMEM);
  if (e != cudaSuccess) return (int)e;
  lt_rank_block<<<1, LT_BLOCK, LT_BLOCK_SMEM, stream>>>(node4, counters, D3);
  AMT_LAUNCHED;
  lt_push<<<amt_blocks(r1cap), AMT_THREADS, 0, stream>>>(
      op2, tw2, op3, tw3, D3, counters, r1cap, D1);
  AMT_LAUNCHED;
  lt_final<<<amt_blocks(P), AMT_THREADS, 0, stream>>>(
      first_child, is_elem, obj_dense, P, op1, tw1, D1, r1cap, elem_index);
  AMT_LAUNCHED;
  return (int)cudaGetLastError();
}

// -- the sharded merge's range entries ----------------------------------------
//
// automerge_tpu/parallel/sharding.py runs both doubling loops with each
// shard advancing its slice of the state and an all_gather re-replicating
// it between rounds (_sharded_linearize :166-252 over the E-padded node
// space, _sharded_linearize_condensed :287-317 over the R2 chain tables).
// Each entry reads the full gathered state and writes one slice.

// ans/jump/fc_e: int32 [Epad]; done: bool [Epad]; Epad >= P + 1, the
// nodes past the sentinel P fixed points (done, jump = P, dist 0, nxt P)
AMT_API int amt_linearize_init(const int* first_child, const int* next_sib,
                               const bool* is_elem, const int* elem_ref,
                               int P, int Epad, int* ans, bool* done,
                               int* jump, int* fc_e, cudaStream_t stream,
                               int* launched) {
  if (Epad <= 0) return (int)cudaGetLastError();
  li_init<<<amt_blocks(Epad), AMT_THREADS, 0, stream>>>(
      first_child, next_sib, is_elem, elem_ref, P, Epad, ans, done, jump, fc_e);
  AMT_LAUNCHED;
  return (int)cudaGetLastError();
}

// one threading round over the nodes [i0, i0+count) of the E-node state
AMT_API int amt_linearize_thread(const int* ans0, const bool* done0,
                                 const int* jump0, int E, int i0, int count,
                                 int* ans1, bool* done1, int* jump1,
                                 cudaStream_t stream, int* launched) {
  if (count <= 0) return (int)cudaGetLastError();
  li_thread<<<amt_blocks(count), AMT_THREADS, 0, stream>>>(
      ans0, done0, jump0, E, i0, count, ans1, done1, jump1);
  AMT_LAUNCHED;
  return (int)cudaGetLastError();
}

// dist/nxt: int32 [Epad] from the threaded answers ans [Epad]
AMT_API int amt_linearize_rank_init(const int* fc_e, const int* ans, int P,
                                    int Epad, int* dist, int* nxt,
                                    cudaStream_t stream, int* launched) {
  if (Epad <= 0) return (int)cudaGetLastError();
  li_rank_init<<<amt_blocks(Epad), AMT_THREADS, 0, stream>>>(fc_e, ans, P,
                                                             Epad, dist, nxt);
  AMT_LAUNCHED;
  return (int)cudaGetLastError();
}

// one ranking round over the nodes [i0, i0+count) of the E-node state
AMT_API int amt_linearize_rank(const int* dist0, const int* nxt0, int E,
                               int i0, int count, int* dist1, int* nxt1,
                               cudaStream_t stream, int* launched) {
  if (count <= 0) return (int)cudaGetLastError();
  li_rank<<<amt_blocks(count), AMT_THREADS, 0, stream>>>(dist0, nxt0, E, i0,
                                                         count, dist1, nxt1);
  AMT_LAUNCHED;
  return (int)cudaGetLastError();
}

// elem_index of the rows [r0, r0+count): int32 [count]
AMT_API int amt_linearize_final(const int* first_child, const bool* is_elem,
                                const int* obj_dense, const int* dist, int P,
                                int r0, int count, int* elem_index,
                                cudaStream_t stream, int* launched) {
  if (count <= 0) return (int)cudaGetLastError();
  li_final<<<amt_blocks(count), AMT_THREADS, 0, stream>>>(
      first_child, is_elem, obj_dense, dist, P, r0, count, elem_index);
  AMT_LAUNCHED;
  return (int)cudaGetLastError();
}
