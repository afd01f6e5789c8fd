// The ruling set that ranks an Euler tour, shared by linearize.cu (the
// tour of the element rows, K7) and linearize_condensed.cu (the tour of
// the chain runs, K8).
//
// A tour is a set of lists over its nodes: each node names its successor
// (-1 ends a list) and has a weight; a node's rank is the weight from it
// to the end of its list. Level-1 rulers (the nodes whose Weyl hash falls
// under a threshold) and the list heads walk their sublists to the next
// ruler (lt_walk1, templated on the tour). The level-1 rulers' own list
// is walked the same way two levels up, one block ranks the few thousand
// rulers left in shared memory, and a pass sums the levels back down to
// every level-1 ruler (lt_rank_levels, defined in linearize.cu: its
// kernels exist once). lt_dist then gives a node's rank from its walk and
// its ruler's. The levels' state is carved from the caller's scratch
// (lt_carve_levels); the counters start at 0 and the byte marks need no
// fill (a ruler clears its own where it gets its id).
#pragma once

#include "common.cuh"

#define LT_END (-1)
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
// sqrt(LT_R3_TARGET / R1) each, as num for lt_pick over r1 rulers; with
// min_stride > 0 at most one in min_stride (a small tour then sends a
// few hundred rulers to the block, not LT_R3_TARGET)
__device__ __forceinline__ unsigned long long lt_level_num(int r1, int min_stride) {
  unsigned long long num = (unsigned long long)(sqrt((double)LT_R3_TARGET * (double)r1) *
                                                4294967296.0);
  if (min_stride > 0) {
    unsigned long long cap = ((unsigned long long)r1 << 32) / (unsigned)min_stride;
    num = num < cap ? num : cap;
  }
  return num;
}

// Ids for the threads of a block that ask (want = 0, 1 or 2 each), from
// one atomicAdd on *counter a block: thousands on one address would
// queue. Every thread of the block calls it.
static __device__ int lt_block_ids(int want, int* counter) {
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

// Level 1, over any tour: tour.bind() (called once a thread, where a tour
// reads its sizes from the device) gives an object with the node count
// (nodes()), a node's record {succ, ruler id} (rec(s)), whether a node
// walks (walks(s, ruler id): a ruler or a list head) and its weight
// (weight(s)). Node s walks
// when the tour says so; op1[node] = {walker, prefix}, tw1[walker] =
// {total, ruler reached or -1}; no walk takes more than `bound` steps,
// so a cycle cannot hang. A ruler also writes node2[its id] = {next
// ruler, total, its id again if it is a level-2 ruler else -1, its
// node}: a level-2 ruler keeps its level-1 id, so no atomic is needed.
template <class Tour>
__global__ void lt_walk1(Tour tour_args, int bound, int r1cap, int min_stride,
                         const int* __restrict__ counters,
                         int2* __restrict__ op1, int2* __restrict__ tw1,
                         int4* __restrict__ node2,
                         unsigned char* __restrict__ pred2,
                         unsigned char* __restrict__ pred3) {
  auto tour = tour_args.bind();
  int n = tour.nodes();
  for (int s = blockIdx.x * blockDim.x + threadIdx.x; s < n;
       s += gridDim.x * blockDim.x) {
    int2 nd = tour.rec(s);
    int rid = nd.y;
    if (!tour.walks(s, rid)) continue;
    int cur = s, acc = 0, end = -1;
    for (int step = 0; step < bound; ++step) {
      op1[cur] = make_int2(s, acc);
      acc += tour.weight(cur);
      int nx = nd.x;
      if (nx < 0) break;
      nd = tour.rec(nx);
      if (nd.y >= 0) {
        end = nd.y;
        break;
      }
      cur = nx;
    }
    tw1[s] = make_int2(acc, end);
    if (rid < 0) continue;
    if (end >= 0) pred2[end] = 1;
    int r1 = min(counters[0], r1cap);
    bool up = lt_pick((unsigned)s, LT_SEED2, r1, lt_level_num(r1, min_stride));
    if (up) pred3[rid] = 0;
    node2[rid] = make_int4(end, acc, up ? rid : -1, s);
  }
}

// the weight from slot s to the end of its list: its walker's total less
// its prefix, plus that of the level-1 ruler the walker reached
static __device__ __forceinline__ unsigned lt_dist(int s, const int2* __restrict__ op1,
                                            const int2* __restrict__ tw1,
                                            const int* __restrict__ D1, int slots,
                                            int r1cap) {
  int2 a = op1[s];
  int2 t = tw1[amt_clamp(a.x, slots)];
  unsigned d = (unsigned)t.x - (unsigned)a.y;
  return t.y < 0 ? d : d + (unsigned)D1[min(t.y, r1cap - 1)];
}

static long long lt_marks(long long bytes) { return (bytes + 15) / 16 * 4; }

// the state of levels 2 and 3 and the block: for at most r1cap rulers
// each, node 4, op and tw 2 words each a ruler; D1 1 a level-1 ruler
// (rounded up to 4 words); node4 4 and D3 1 a level-3 ruler; 4 counters
// (counters[0]: level-1 rulers, [2]: level-3 rulers); then the byte marks
// pred2 and pred3 [r1cap], each rounded up to 16 bytes
struct LtLevels {
  int4* node2;
  int2* op2;
  int2* tw2;
  int4* node3;
  int2* op3;
  int2* tw3;
  int* D1;
  int4* node4;
  int* D3;
  int* counters;
  unsigned char* pred2;
  unsigned char* pred3;
};

static long long lt_levels_words(long long r1cap) {
  return 16 * r1cap + (r1cap + 3) / 4 * 4 + 5LL * LT_R3_CAP + 4 + 2 * lt_marks(r1cap);
}

// the levels' state from `at` (16-byte aligned) on, lt_levels_words(r1cap)
// words
static LtLevels lt_carve_levels(int* at, long long r1cap) {
  LtLevels lv;
  lv.node2 = (int4*)at;  at += 4 * r1cap;
  lv.op2 = (int2*)at;    at += 2 * r1cap;
  lv.tw2 = (int2*)at;    at += 2 * r1cap;
  lv.node3 = (int4*)at;  at += 4 * r1cap;
  lv.op3 = (int2*)at;    at += 2 * r1cap;
  lv.tw3 = (int2*)at;    at += 2 * r1cap;
  lv.D1 = at;            at += (r1cap + 3) / 4 * 4;  // node4 16-byte aligned
  lv.node4 = (int4*)at;  at += 4LL * LT_R3_CAP;
  lv.D3 = at;            at += LT_R3_CAP;
  lv.counters = at;      at += 4;
  lv.pred2 = (unsigned char*)at;
  lv.pred3 = lv.pred2 + 4 * lt_marks(r1cap);
  return lv;
}

// After lt_walk1: levels 2 and 3, the block, and D1 for every level-1
// ruler; four launches (linearize.cu); min_stride as lt_walk1's
int lt_rank_levels(const LtLevels& lv, int r1cap, int min_stride,
                   cudaStream_t stream, int* launched);
