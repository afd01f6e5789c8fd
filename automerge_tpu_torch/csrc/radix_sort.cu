// radix_sort: a stable ascending LSD radix sort of int64 keys, 8-bit
// digits, in onesweep form.
//
// Replaces the sort in automerge_tpu/ops/merge.py forest (:582),
// jax.lax.sort((sib_parent, -rows), num_keys=2, is_stable=True), on the
// one packed int64 key per row that forest.cu writes. A digit is 8 bits
// of the key with bit 63 flipped, so that signed keys order as unsigned
// words. The caller names the digits to sort; one it leaves out must hold
// the same value in every key (the forest knows its keys' layout from P).
// Deciding this on the host keeps the pass count, and so which ping-pong
// buffer ends with the result, known before any launch. Then:
//   1. rs_histogram counts every sorted digit of every key at once, in
//      shared memory, then into the global [8][256] counts. A pass
//      permutes the keys, so one histogram serves every pass.
//   2. rs_onesweep, one launch per digit, reading one buffer and writing
//      the other (the first pass reads the input). Each block takes a
//      tile of RS_TILE keys, its tile id from an atomic counter: a
//      tile's predecessors then already run, so its look-back cannot wait
//      on a block that never starts. Each warp ranks its 32 x RS_KPT keys
//      in order (__match_any_sync on the digit, popc over the lower
//      lanes, a per-warp count in shared memory); the warps' counts are
//      scanned in warp order, so the rank within the tile keeps the
//      input order. The tile publishes its per-digit counts, then looks
//      back over the earlier tiles' published words, RS_WINDOW of them a
//      round trip (decoupled look-back: an aggregate adds and goes on, an
//      inclusive prefix ends the walk, an unpublished word is read again)
//      and publishes its own prefix. The keys go through shared
//      memory in the tile's sorted order, so each digit's keys leave as
//      one contiguous run: global start of the digit (a scan of the
//      histogram) + the earlier tiles' count + the position in the run.
// Every pass is stable, so the sort is. The counts, the tile counters and
// the look-back words are zeroed by one memset in the entry point.
// The length may also be read on the device (n_dev: the forest's element
// count, which its links pass writes): the grid is sized for the
// capacity n, the histogram counts only [0, *n_dev), and a block whose
// tiles would start at or past *n_dev exits before it takes a tile id,
// so the tiles that do run are exactly the first ones and no look-back
// waits on a block that left. The host never reads the count.
//
// Bound: bytes. The keys are read once and written once (8n each). The
// design reads and writes them once per digit and reads them once more
// for the histogram: 16n per pass plus 8n, and the look-back words
// (1 KiB a tile a pass) in L2.
#include "common.cuh"

#define RS_THREADS 256
#define RS_WARPS (RS_THREADS / 32)
#define RS_KPT 16                      // keys per thread of a tile
#define RS_TILE (RS_THREADS * RS_KPT)  // 4096 keys, 32 KiB
#define RS_RADIX 256
#define RS_FULL 0xffffffffu
#define RS_SIGN 0x8000000000000000ULL
#define RS_HIST_BLOCKS 256
#define RS_WINDOW 8  // look-back words read per round trip
// a look-back word: the count in the low 30 bits (n < 2^30), flags above
#define RS_AGG 0x40000000u     // this tile's own count
#define RS_PREFIX 0x80000000u  // the count of this and every earlier tile
#define RS_VALUE 0x3fffffffu

static_assert(RS_THREADS == RS_RADIX, "one thread per digit value");

// the keys to sort: n, or the device-side count clamped to [0, n]
__device__ __forceinline__ int rs_count(int n, const int* n_dev) {
  if (n_dev == nullptr) return n;
  int c = *n_dev;
  return c < 0 ? 0 : (c < n ? c : n);
}

__device__ __forceinline__ unsigned rs_digit(long long k, int shift) {
  return (unsigned)(((unsigned long long)k ^ RS_SIGN) >> shift) & 0xffu;
}

__global__ void __launch_bounds__(RS_THREADS)
rs_histogram(const long long* __restrict__ keys, int cap,
             const int* __restrict__ n_dev, int mask,
             unsigned* __restrict__ hist) {
  __shared__ unsigned sh[8 * RS_RADIX];
  const int n = rs_count(cap, n_dev);
  for (int i = threadIdx.x; i < 8 * RS_RADIX; i += RS_THREADS) sh[i] = 0;
  __syncthreads();
  for (long long i = (long long)blockIdx.x * RS_THREADS + threadIdx.x; i < n;
       i += (long long)gridDim.x * RS_THREADS) {
    unsigned long long u = (unsigned long long)keys[i] ^ RS_SIGN;
#pragma unroll
    for (int d = 0; d < 8; ++d)
      if (mask >> d & 1) atomicAdd(&sh[d * RS_RADIX + ((u >> (8 * d)) & 0xff)], 1u);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 8 * RS_RADIX; i += RS_THREADS)
    if (sh[i]) atomicAdd(&hist[i], sh[i]);
}

// Exclusive scan of v over the block's threads in thread order. Every
// thread of the block calls it.
__device__ __forceinline__ unsigned rs_block_excl(unsigned v, unsigned* sh) {
  int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned x = v;
  for (int o = 1; o < 32; o <<= 1) {
    unsigned y = __shfl_up_sync(RS_FULL, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) sh[warp] = x;
  __syncthreads();
  unsigned before = 0;
  for (int w = 0; w < warp; ++w) before += sh[w];
  return before + x - v;
}

// One stable counting pass over the digit at bits [shift, shift + 8):
// in -> out. hist: this digit's 256 counts over all keys; lookback: the
// pass's [tiles][256] words, zeroed; counter: the pass's tile counter,
// zeroed.
__global__ void __launch_bounds__(RS_THREADS)
rs_onesweep(const long long* __restrict__ in, long long* __restrict__ out,
            int cap, const int* __restrict__ n_dev, int shift,
            const unsigned* __restrict__ hist, unsigned* lookback,
            int* counter) {
  __shared__ long long s_keys[RS_TILE];
  __shared__ unsigned s_whist[RS_WARPS][RS_RADIX];
  __shared__ unsigned s_tstart[RS_RADIX];
  __shared__ int s_gbase[RS_RADIX];
  __shared__ unsigned s_scan[2][RS_WARPS];
  __shared__ int s_tile;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int n = rs_count(cap, n_dev);
  if ((long long)blockIdx.x * RS_TILE >= n) return;  // a tile past the keys
  if (t == 0) s_tile = atomicAdd(counter, 1);
  for (int i = t; i < RS_WARPS * RS_RADIX; i += RS_THREADS)
    (&s_whist[0][0])[i] = 0;
  __syncthreads();
  const int tile = s_tile;
  const long long base = (long long)tile * RS_TILE;
  const int count = (int)min((long long)RS_TILE, (long long)n - base);

  // 1. each key's rank among the earlier keys of its warp with its digit
  // (the loads first, all in flight together)
  long long k[RS_KPT];
  unsigned rank[RS_KPT];
  const unsigned lower = (1u << lane) - 1;
  const int wbase = warp * 32 * RS_KPT;
#pragma unroll
  for (int j = 0; j < RS_KPT; ++j) {
    int i = wbase + j * 32 + lane;
    k[j] = i < count ? in[base + i] : 0;
  }
#pragma unroll
  for (int j = 0; j < RS_KPT; ++j) {
    bool ok = wbase + j * 32 + lane < count;
    unsigned d = ok ? rs_digit(k[j], shift) : RS_RADIX;
    unsigned peers = __match_any_sync(RS_FULL, d);
    unsigned before = ok ? s_whist[warp][d] : 0;
    rank[j] = before + __popc(peers & lower);
    __syncwarp();
    if (ok && lane == __ffs(peers) - 1) s_whist[warp][d] = before + __popc(peers);
    __syncwarp();
  }
  __syncthreads();

  // 2. digit t: each warp's start among the tile's keys of digit t (in
  // warp order), and the tile's count, published at once
  unsigned tc = 0;
  for (int w = 0; w < RS_WARPS; ++w) {
    unsigned c = s_whist[w][t];
    s_whist[w][t] = tc;
    tc += c;
  }
  volatile unsigned* mine = lookback + (size_t)tile * RS_RADIX;
  mine[t] = (tile == 0 ? RS_PREFIX : RS_AGG) | tc;

  // 3. digit t's start within the tile and among all keys
  unsigned tstart = rs_block_excl(tc, s_scan[0]);
  unsigned gstart = rs_block_excl(hist[t], s_scan[1]);
  s_tstart[t] = tstart;
  __syncthreads();

  // 4. the tile's keys into shared memory in their sorted order
#pragma unroll
  for (int j = 0; j < RS_KPT; ++j) {
    if (wbase + j * 32 + lane < count) {
      unsigned d = rs_digit(k[j], shift);
      s_keys[s_tstart[d] + s_whist[warp][d] + rank[j]] = k[j];
    }
  }

  // 5. decoupled look-back: digit t's count in all earlier tiles, read
  // RS_WINDOW predecessors at a time (independent loads, one round trip)
  unsigned excl = 0;
  if (tile > 0) {
    const volatile unsigned* lb = lookback;
    for (int p = tile - 1;;) {
      unsigned v[RS_WINDOW];
#pragma unroll
      for (int i = 0; i < RS_WINDOW; ++i)
        v[i] = p - i >= 0 ? lb[(size_t)(p - i) * RS_RADIX + t] : RS_PREFIX;
      int used = 0;
      bool found = false;
#pragma unroll
      for (int i = 0; i < RS_WINDOW; ++i) {
        if (found || used < i || !(v[i] & (RS_AGG | RS_PREFIX))) continue;
        excl += v[i] & RS_VALUE;  // beyond tile 0: RS_PREFIX | 0
        found = v[i] & RS_PREFIX;
        used = i + 1;
      }
      if (found) break;
      p -= used;  // from the first word not yet published
    }
    mine[t] = RS_PREFIX | (excl + tc);
  }
  s_gbase[t] = (int)(gstart + excl) - (int)tstart;
  __syncthreads();

  // 6. out: each digit's keys one contiguous run
  for (int i = t; i < count; i += RS_THREADS) {
    long long key = s_keys[i];
    out[s_gbase[rs_digit(key, shift)] + i] = key;
  }
}

static long long rs_scratch_words(int n, int digits) {
  long long tiles = (n + (long long)RS_TILE - 1) / RS_TILE;
  return 8LL * RS_RADIX + 8 + (long long)digits * tiles * RS_RADIX;
}

// Sorts in[0:n) ascending and stably by the digits set in digit_mask (bit
// d: key bits [8d, 8d + 8) with bit 63 flipped); with n_dev, in[0:*n_dev)
// (clamped to [0, n]), buffers sized for n, and the rest of each buffer
// left as it was. in is only read; pass p (of the popcount(digit_mask)
// passes, ascending digits) writes buf0 when p is even, buf1 when odd.
// scratch: scratch_words uint32, at least rs_scratch_words
// (kernels/radix_sort.py scratch_words), zeroed here.
AMT_API int amt_radix_sort(const long long* in, long long* buf0, long long* buf1,
                           int n, int digit_mask, unsigned* scratch,
                           long long scratch_words, const int* n_dev,
                           cudaStream_t stream, int* launched) {
  if (n < 0 || n >= (1 << 30) || digit_mask <= 0 || digit_mask > 0xff)
    return (int)cudaErrorInvalidValue;
  int digits = __builtin_popcount(digit_mask);
  long long words = rs_scratch_words(n, digits);
  if (scratch_words < words) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaGetLastError();
  int tiles = (n + RS_TILE - 1) / RS_TILE;
  unsigned* hist = scratch;                                // [8][256]
  int* counters = (int*)(scratch + 8 * RS_RADIX);          // [8]
  unsigned* lookback = scratch + 8 * RS_RADIX + 8;         // [digits][tiles][256]
  cudaError_t e = cudaMemsetAsync(scratch, 0, words * sizeof(unsigned), stream);
  if (e != cudaSuccess) return (int)e;
  rs_histogram<<<tiles < RS_HIST_BLOCKS ? tiles : RS_HIST_BLOCKS, RS_THREADS, 0,
                 stream>>>(in, n, n_dev, digit_mask, hist);
  AMT_LAUNCHED;
  const long long* src = in;
  long long* bufs[2] = {buf0, buf1};
  int p = 0;
  for (int d = 0; d < 8; ++d) {
    if (!(digit_mask >> d & 1)) continue;
    rs_onesweep<<<tiles, RS_THREADS, 0, stream>>>(
        src, bufs[p & 1], n, n_dev, 8 * d, hist + d * RS_RADIX,
        lookback + (size_t)p * tiles * RS_RADIX, counters + p);
    AMT_LAUNCHED;
    src = bufs[p & 1];
    ++p;
  }
  return (int)cudaGetLastError();
}
