// The sorted join of op ids to rows (from automerge_tpu/native/
// merge_cols.cpp): the log resolves its element and pred references
// against the Lamport-sorted id column with it.

#include <cstdint>
#include <thread>
#include <vector>

extern "C" {

// Sorted join: out[i] = position of q[i] in sorted[0..n) if present, else
// ``missing``. The extraction hot path resolves op-id references (elem /
// pred targets) against the Lamport-sorted id column with this. Packed op
// ids (counter << ACTOR_BITS | rank) are near-uniform over their value
// range in real logs, so a few interpolation probes narrow the window
// before the binary search — ~3-4 memory touches instead of log2(n) on a
// cold array. Degenerate distributions just fall through to binary
// search over the narrowed (or full) window. The query range splits
// across threads when the host has them.
long long am_join_rows_i64(const int64_t* sorted, int64_t n, const int64_t* q,
                           int64_t m, int32_t missing, int32_t* out) {
  // direct-mapped memo: real query streams are highly repetitive (RGA
  // anchors and typing chains reference a small working set of targets),
  // so most lookups resolve to one probe of a 64k-entry cache instead of
  // a search. The empty marker is INT64_MIN — no packed id reaches it, so
  // ANY query key (including 0, which both callers do pass) is safe.
  // Per-thread tables — a shared memo's two-field entries would tear
  // under concurrent writes — and only for ranges big enough to amortize
  // the table's zero-init (small incremental joins skip it).
  constexpr int64_t kCacheBits = 16;
  constexpr int64_t kEmpty = INT64_MIN;
  // gate on the TOTAL query count (a per-chunk gate would disable the
  // memo for mid-size joins exactly when the thread split is active)
  const bool use_memo = m >= (int64_t)1 << (kCacheBits - 2);
  auto run = [&](int64_t lo, int64_t hi) {
    std::vector<int64_t> memo_key;
    std::vector<int32_t> memo_val;
    if (use_memo) {
      memo_key.assign((size_t)1 << kCacheBits, kEmpty);
      memo_val.assign((size_t)1 << kCacheBits, 0);
    }
    for (int64_t i = lo; i < hi; i++) {
      const int64_t key = q[i];
      size_t slot = 0;
      // key == kEmpty must never consult the memo: a never-written slot
      // would false-hit on the empty marker
      if (use_memo && key != kEmpty) {
        slot = (size_t)((uint64_t)(key * 0x9E3779B97F4A7C15ull) >>
                        (64 - kCacheBits));
        if (memo_key[slot] == key) {
          out[i] = memo_val[slot];
          continue;
        }
      }
      int64_t a = 0, b = n;
      // interpolation steps keep the lower_bound invariant (answer in
      // [a, b]): p is clamped into [a, b-1], then the same narrowing rule
      // as the binary step applies. ~1.7x over plain binary here
      // (lockstep-prefetch and branchless variants measured slower).
      for (int probe = 0; probe < 4 && b - a > 64; probe++) {
        const int64_t va = sorted[a], vb = sorted[b - 1];
        if (vb <= va || key <= va || key >= vb) break;
        int64_t p = a + (int64_t)((double)(key - va) / (double)(vb - va) *
                                  (double)(b - 1 - a));
        if (p < a) p = a;
        if (p > b - 1) p = b - 1;
        if (sorted[p] < key)
          a = p + 1;
        else
          b = p;
      }
      while (a < b) {
        const int64_t mid = (a + b) >> 1;
        if (sorted[mid] < key)
          a = mid + 1;
        else
          b = mid;
      }
      const int32_t r = (a < n && sorted[a] == key) ? (int32_t)a : missing;
      out[i] = r;
      if (use_memo && key != kEmpty) {
        memo_key[slot] = key;
        memo_val[slot] = r;
      }
    }
  };
  const unsigned hw = std::thread::hardware_concurrency();
  const int64_t nt =
      m >= 16384 ? (int64_t)(hw > 8 ? 8 : (hw ? hw : 1)) : 1;
  if (nt <= 1) {
    run(0, m);
    return 0;
  }
  std::vector<std::thread> ts;
  const int64_t step = (m + nt - 1) / nt;
  for (int64_t t = 0; t < nt; t++) {
    const int64_t lo = t * step, hi = lo + step < m ? lo + step : m;
    if (lo >= hi) break;
    ts.emplace_back(run, lo, hi);
  }
  for (auto& t : ts) t.join();
  return 0;
}

}  // extern "C"
