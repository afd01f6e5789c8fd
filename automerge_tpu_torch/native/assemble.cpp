// Log assembly: per-change cached op columns -> final Lamport-ordered,
// reference-resolved device columns, in one native pass.
//
// This is the merge path's answer to the reference's per-op
// seek-and-insert loop (automerge.rs:1258-1280): instead of decoding the
// change chunks into a tree, each change keeps its decoded chunk-local
// column arrays (attached at commit time or on first decode), and a merge
// assembles N ops with
//   1. a counting sort over (counter, actor-rank) that exploits the runs
//      of CONSECUTIVE counters every change carries by construction
//      (ids are start_op..start_op+n-1), so Lamport ordering is O(N)
//      instead of O(N log N);
//   2. column gathers through the emit permutation (no intermediate
//      concatenation);
//   3. change-SPAN reference resolution: an op id (ctr, rank) is located
//      by binary search over the ~C-entry change table plus an inverse-
//      permutation lookup — not by joining against the N-row id column.
//      (C ~ 1k..10k entries stays L1/L2-resident; the old sorted join
//      walked a 376k-row array per query.)
//
// Returns 0 on success, 1 when the caller must recompute the object
// table host-side (an object id that is not a make op in this log —
// partial histories), negative on input it cannot place (the caller
// raises; ops/assemble.py checks what a parsed change can carry first).

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

constexpr int32_t ELEM_HEAD = -1;
constexpr int32_t ELEM_MAP = -2;
constexpr int32_t ELEM_MISSING = -3;
constexpr int32_t TAG_UNKNOWN = 10;

// make actions (object-creating ops; reference types.rs action indices
// 0/2/4/6) as a bitmask test
inline bool is_make_action(int32_t a) {
  return a >= 0 && a < 8 && ((1u << a) & 0b01010101u);
}

struct Span {
  int64_t key;      // rank << 43 | start_op  (rank < 2^20, ctr < 2^43)
  int64_t start;    // start_op
  int64_t n;        // ops in change
  int64_t row_off;  // concat-order row offset of the change
};

}  // namespace

extern "C" {

// col_ptrs layout per change (row-major, 18 entries):
//   0 action   i32[n]     1 obj_ctr  i64[n]   2 obj_actor i32[n]
//   3 obj_has  u8[n]      4 key_sid  i32[n]   5 elem_ctr  i64[n]
//   6 elem_actor i32[n]   7 insert   u8[n]    8 expand    u8[n]
//   9 vcode    i32[n]    10 vlen     i64[n]  11 voff      i64[n]
//  12 value_int i64[n]   13 width    i32[n]  14 mark_sid  i32[n]
//  15 pred_num i32[n]    16 pred_ctr i64[q]  17 pred_actor i32[q]
//  18 hot: 24-byte AoS record {elem_ctr i64, voff u32, vlen u32,
//     elem_actor i32, action u8, vcode u8, insert u8, pad} — the
//     gather-heavy columns interleaved so a permuted row read touches
//     one cache line, not seven per-change streams (and at 24B, 2.6
//     rows per line instead of 1.6)
//
// g_flags/g_vals (18 slots, indexed like the columns): globally-constant
// columns the caller proved identical across every change — the
// assembler FILLS those outputs sequentially and skips their gathers
// (real logs are dominated by such columns: one target object, no
// marks, constant widths/payloads). Slot semantics:
//   [1]=1: obj_key := g_vals[1] (already rank-translated), obj_dense
//          resolved once;  [4]=1: key_sid const -1 (prop := -1);
//   [4]=2: prop := g_vals[4] (global id), elem_ref := ELEM_MAP;
//   [7,8,9,10,12,13]: plain value fills; [11]: voff fill (only valid
//   when the value heap is empty); [14]: mark_idx := g_vals[14].
long long am_assemble_log(
    const int64_t* n_ops, const int64_t* q_ops, const int64_t* start_op,
    const int64_t* author_rank, const int64_t* tab_off,
    const int64_t* tab_size, const int64_t* prop_off,
    const int64_t* prop_size, const int64_t* mark_off,
    const int64_t* mark_size, const int64_t* raw_base,
    const int64_t* col_ptrs, int64_t n_changes, const int64_t* tab_all,
    const int32_t* prop_remap_all, const int32_t* mark_remap_all,
    int32_t actor_bits, const int64_t* g_flags, const int64_t* g_vals,
    // per-change constant shortcuts (see assemble.py _per_change_const):
    // c_obj_key[c] >= 0: every row of change c targets that packed object
    // (-1 = varies); c_sid_arr[c] == -1: all rows seq-keyed, >= 0: one
    // global map prop, -2 = varies
    const int64_t* c_obj_key, const int64_t* c_sid_arr,
    // outputs, length N
    int64_t* id_key, int64_t* obj_key, int32_t* prop, int32_t* action,
    uint8_t* insert, uint8_t* expand, int32_t* value_tag,
    int64_t* value_int, int32_t* width, int32_t* mark_idx, int32_t* vcode,
    int64_t* voff, int64_t* vlen, int32_t* elem_ref, int32_t* obj_dense,
    int64_t n_total,
    // outputs, length Q
    int32_t* pred_src, int32_t* pred_tgt, int64_t q_total,
    // obj_table capacity must be >= #make ops + 1; out_meta[0] = n_objs
    int64_t* obj_table, int64_t* out_meta) {
  const int64_t C = n_changes;
  const int64_t N = n_total;
  const int64_t AB = actor_bits;
  if (N == 0) {
    obj_table[0] = 0;
    out_meta[0] = 1;
    return 0;
  }

  auto cp = [&](int64_t c, int k) -> const void* {
    return (const void*)(uintptr_t)col_ptrs[c * 19 + k];
  };

  // concat-order row offsets + validation
  std::vector<int64_t> row_off(C + 1), pred_off(C + 1);
  int64_t min_ctr = INT64_MAX, max_ctr = INT64_MIN;
  {
    int64_t acc = 0, qacc = 0;
    for (int64_t c = 0; c < C; c++) {
      row_off[c] = acc;
      pred_off[c] = qacc;
      if (n_ops[c] < 0 || q_ops[c] < 0 || start_op[c] < 1) return -1;
      acc += n_ops[c];
      qacc += q_ops[c];
      if (n_ops[c]) {
        min_ctr = std::min(min_ctr, start_op[c]);
        max_ctr = std::max(max_ctr, start_op[c] + n_ops[c] - 1);
      }
      if (author_rank[c] < 0 || author_rank[c] >= ((int64_t)1 << AB))
        return -2;
    }
    row_off[C] = acc;
    pred_off[C] = qacc;
    if (acc != N || qacc != q_total) return -3;
  }

  // ---- 1. Lamport ordering ------------------------------------------------
  // src[j] = concat-order row that lands at sorted position j;
  // newrow[old] = sorted position of concat-order row `old`.
  std::vector<int32_t> src(N), newrow(N);
  std::vector<int32_t> src_c(N);  // owning change per sorted row
  const int64_t range = max_ctr - min_ctr + 1;
  // order changes by author rank so same-counter buckets fill in rank
  // order (ranks are unique per actor; one actor's changes never overlap
  // in counter range, so within a bucket each change appears once)
  std::vector<int32_t> by_rank(C);
  for (int64_t c = 0; c < C; c++) by_rank[c] = (int32_t)c;
  std::stable_sort(by_rank.begin(), by_rank.end(),
                   [&](int32_t a, int32_t b) {
                     return author_rank[a] < author_rank[b];
                   });
  if (range <= std::max<int64_t>(4 * N, 1 << 22)) {
    // counting sort over the counter range (the common, regular case);
    // i32 buckets halve the table's cache traffic (counts and positions
    // both fit: N < 2^31)
    // counts via an interval diff array (each change covers a consecutive
    // counter range): O(C + range) instead of O(N) scattered increments
    std::vector<int32_t> bucket(range + 1, 0);
    for (int64_t c = 0; c < C; c++) {
      if (!n_ops[c]) continue;
      bucket[start_op[c] - min_ctr]++;
      bucket[start_op[c] + n_ops[c] - min_ctr]--;
    }
    int32_t cover = 0, acc = 0;
    for (int64_t b = 0; b < range; b++) {
      cover += bucket[b];
      bucket[b] = acc;
      acc += cover;
    }
    if (range * C <= 8 * N && C > 64) {
      // many changes sharing a narrow counter range (the map+counter
      // fan-in shape: 10k actors x 1k ops over the same counters): the
      // per-change placement loop writes src at a C-change stride — one
      // cache miss per row over a multi-hundred-MB window. Place in
      // BLOCKS of changes instead: each (block, counter) pair touches a
      // contiguous src segment and a block-local newrow window, keeping
      // the working set L2-resident. Blocks run in rank order, so each
      // counter bucket still fills in rank order.
      constexpr int64_t BLK = 256;
      for (int64_t blk = 0; blk < C; blk += BLK) {
        const int64_t be = std::min(blk + BLK, C);
        for (int64_t b = 0; b < range; b++) {
          for (int64_t k = blk; k < be; k++) {
            const int64_t c = by_rank[k];
            const int64_t i = b - (start_op[c] - min_ctr);
            if (i < 0 || i >= n_ops[c]) continue;
            const int32_t pos = bucket[b]++;
            const int64_t base = row_off[c];
            src[pos] = (int32_t)(base + i);
            src_c[pos] = (int32_t)c;
            newrow[base + i] = pos;
          }
        }
      }
    } else {
      for (int64_t ci = 0; ci < C; ci++) {
        const int64_t c = by_rank[ci];
        const int64_t base = row_off[c], s0 = start_op[c] - min_ctr;
        for (int64_t i = 0; i < n_ops[c]; i++) {
          const int32_t pos = bucket[s0 + i]++;
          src[pos] = (int32_t)(base + i);
          src_c[pos] = (int32_t)c;
          newrow[base + i] = pos;
        }
      }
    }
  } else {
    // degenerate counter distribution: comparator sort on packed keys
    std::vector<int64_t> keys(N);
    for (int64_t c = 0; c < C; c++)
      for (int64_t i = 0; i < n_ops[c]; i++)
        keys[row_off[c] + i] =
            ((start_op[c] + i) << AB) | author_rank[c];
    std::vector<int32_t> owner(N);
    for (int64_t c = 0; c < C; c++)
      for (int64_t i = 0; i < n_ops[c]; i++)
        owner[row_off[c] + i] = (int32_t)c;
    for (int64_t j = 0; j < N; j++) src[j] = (int32_t)j;
    std::stable_sort(src.begin(), src.end(), [&](int32_t a, int32_t b) {
      return keys[a] < keys[b];
    });
    for (int64_t j = 0; j < N; j++) {
      newrow[src[j]] = (int32_t)j;
      src_c[j] = owner[src[j]];
    }
  }

  // ---- 2. span table for reference resolution -----------------------------
  std::vector<Span> spans;
  spans.reserve(C);
  for (int64_t c = 0; c < C; c++) {
    if (!n_ops[c]) continue;
    spans.push_back(Span{(author_rank[c] << 43) | start_op[c], start_op[c],
                         n_ops[c], row_off[c]});
  }
  std::sort(spans.begin(), spans.end(),
            [](const Span& a, const Span& b) { return a.key < b.key; });
  const int64_t S = (int64_t)spans.size();
  // resolve (ctr, rank) -> sorted row, -1 if not in this log. Reference
  // streams are extremely repetitive — RGA insert chains target the
  // author's own change and anchors/preds target the (few) base
  // changes — so a referencing-change fast path plus a last-span memo
  // resolves almost everything in O(1); the binary search is the rare
  // path.
  int64_t memo_span = -1;
  auto resolve2 = [&](int64_t ctr, int64_t rank, int64_t c_hint) -> int32_t {
    if (author_rank[c_hint] == rank && ctr >= start_op[c_hint] &&
        ctr < start_op[c_hint] + n_ops[c_hint])
      return newrow[row_off[c_hint] + (ctr - start_op[c_hint])];
    if (memo_span >= 0) {
      const Span& sp = spans[memo_span];
      if ((sp.key >> 43) == rank && ctr >= sp.start && ctr < sp.start + sp.n)
        return newrow[sp.row_off + (ctr - sp.start)];
    }
    const int64_t qk = (rank << 43) | ctr;
    int64_t lo = 0, hi = S;
    while (lo < hi) {
      const int64_t mid = (lo + hi) >> 1;
      if (spans[mid].key <= qk)
        lo = mid + 1;
      else
        hi = mid;
    }
    if (lo == 0) return -1;
    const Span& sp = spans[lo - 1];
    if ((sp.key >> 43) != rank) return -1;
    if (ctr < sp.start || ctr >= sp.start + sp.n) return -1;
    memo_span = lo - 1;
    return newrow[sp.row_off + (ctr - sp.start)];
  };

  // ---- 3. constant-column fills + one fused gather pass -------------------
  const bool c_obj = g_flags[1] != 0;
  const int64_t c_sid = g_flags[4];  // 0 none, 1 all-seq, 2 const map prop
  const bool c_ins = g_flags[7] != 0, c_exp = g_flags[8] != 0;
  const bool c_vc = g_flags[9] != 0, c_vl = g_flags[10] != 0;
  const bool c_vo = g_flags[11] != 0, c_vi = g_flags[12] != 0;
  const bool c_w = g_flags[13] != 0, c_mark = g_flags[14] != 0;
  if (c_obj) std::fill(obj_key, obj_key + N, g_vals[1]);
  // prop defaults to -1 via ONE memset; the gather loop then only writes
  // map-prop rows (real logs are sequence-dominated)
  if (c_sid != 2) std::memset(prop, 0xFF, (size_t)N * sizeof(int32_t));
  if (c_sid == 2) {
    std::fill(prop, prop + N, (int32_t)g_vals[4]);
    std::fill(elem_ref, elem_ref + N, ELEM_MAP);
  }
  if (c_ins) std::fill(insert, insert + N, (uint8_t)g_vals[7]);
  if (c_exp) std::fill(expand, expand + N, (uint8_t)g_vals[8]);
  if (c_vc) {
    std::fill(vcode, vcode + N, (int32_t)g_vals[9]);
    const int32_t vt =
        g_vals[9] > TAG_UNKNOWN ? TAG_UNKNOWN : (int32_t)g_vals[9];
    std::fill(value_tag, value_tag + N, vt);
  }
  if (c_vl) std::fill(vlen, vlen + N, g_vals[10]);
  if (c_vo) std::fill(voff, voff + N, g_vals[11]);
  if (c_vi) std::fill(value_int, value_int + N, g_vals[12]);
  if (c_w) std::fill(width, width + N, (int32_t)g_vals[13]);
  if (c_mark) std::fill(mark_idx, mark_idx + N, (int32_t)g_vals[14]);

  // (obj_table fills alongside; make ranks resolve later by binary search
  // over it — the table is tiny, and this drops the old N-row make_prefix
  // stream entirely)
  obj_table[0] = 0;
  int64_t n_make = 0;
  for (int64_t j = 0; j < N; j++) {
    const int64_t c = src_c[j];
    const int64_t i = src[j] - row_off[c];
    const int64_t* ptrs = col_ptrs + c * 19;
    const uint8_t* rec = (const uint8_t*)(uintptr_t)ptrs[18] + i * 24;
    id_key[j] = ((start_op[c] + i) << AB) | author_rank[c];
    const int32_t a = rec[20];
    action[j] = a;
    if (is_make_action(a)) obj_table[1 + n_make++] = id_key[j];
    if (!c_ins) insert[j] = rec[22];
    if (!c_exp) expand[j] = ((const uint8_t*)(uintptr_t)ptrs[8])[i];
    if (!c_vc) {
      const int32_t vc = rec[21];
      vcode[j] = vc;
      value_tag[j] = vc > TAG_UNKNOWN ? TAG_UNKNOWN : vc;
    }
    if (!c_vl) vlen[j] = *(const uint32_t*)(rec + 12);
    if (!c_vo) voff[j] = (int64_t)*(const uint32_t*)(rec + 8) + raw_base[c];
    if (!c_vi) value_int[j] = ((const int64_t*)(uintptr_t)ptrs[12])[i];
    if (!c_w) width[j] = ((const int32_t*)(uintptr_t)ptrs[13])[i];
    // object id (per-change const shortcut first: nearly every real
    // change targets one object, so the has/actor/ctr loads + table
    // translation collapse to a single C-array read)
    if (!c_obj) {
      const int64_t cobj = c_obj_key[c];
      if (cobj >= 0) {
        obj_key[j] = cobj;
      } else if (((const uint8_t*)(uintptr_t)ptrs[3])[i]) {
        const int32_t oa = ((const int32_t*)(uintptr_t)ptrs[2])[i];
        if (oa < 0 || oa >= tab_size[c]) return -4;
        const int64_t octr = ((const int64_t*)(uintptr_t)ptrs[1])[i];
        if (octr < 0 || octr >= ((int64_t)1 << 43)) return -5;
        obj_key[j] = (octr << AB) | tab_all[tab_off[c] + oa];
      } else {
        obj_key[j] = 0;
      }
    }
    // key: map prop or sequence element
    if (c_sid != 2) {
      const int64_t csid = c_sid == 1 ? -1 : c_sid_arr[c];
      const int32_t sid =
          csid != -2 ? -1 : ((const int32_t*)(uintptr_t)ptrs[4])[i];
      if (csid >= 0) {
        prop[j] = (int32_t)csid;
        elem_ref[j] = ELEM_MAP;
      } else if (sid >= 0) {
        if (prop_off[c] < 0 || sid >= prop_size[c]) return -6;
        prop[j] = prop_remap_all[prop_off[c] + sid];
        elem_ref[j] = ELEM_MAP;
      } else {
        const int64_t ectr = *(const int64_t*)(rec + 0);
        if (ectr == 0) {
          elem_ref[j] = ELEM_HEAD;
        } else {
          const int32_t ea = *(const int32_t*)(rec + 16);
          if (ea < 0 || ea >= tab_size[c]) return -7;
          if (ectr < 0 || ectr >= ((int64_t)1 << 43)) return -8;
          const int32_t r = resolve2(ectr, tab_all[tab_off[c] + ea], c);
          elem_ref[j] = r < 0 ? ELEM_MISSING : r;
        }
      }
    }
    // mark name
    if (!c_mark) {
      const int32_t ms = ((const int32_t*)(uintptr_t)ptrs[14])[i];
      if (ms >= 0) {
        if (mark_off[c] < 0 || ms >= mark_size[c]) return -9;
        mark_idx[j] = mark_remap_all[mark_off[c] + ms];
      } else {
        mark_idx[j] = -1;
      }
    }
  }
  out_meta[0] = 1 + n_make;

  // ---- 4. dense object ids ------------------------------------------------
  // ops overwhelmingly share their container: a one-entry memo turns the
  // resolve into a single compare for nearly every row. The make RANK of a
  // resolved row comes from a binary search over the (tiny, L1-resident)
  // obj_table instead of the old N-row make_prefix stream.
  auto make_rank = [&](int32_t r) -> int64_t {
    const int64_t idk = id_key[r];
    int64_t lo = 0, hi = n_make;
    while (lo < hi) {
      const int64_t mid = (lo + hi) >> 1;
      if (obj_table[1 + mid] < idk)
        lo = mid + 1;
      else
        hi = mid;
    }
    if (lo >= n_make || obj_table[1 + lo] != idk) return -1;
    return lo;
  };
  bool obj_fallback = false;
  if (c_obj) {
    const int64_t k = g_vals[1];
    int32_t dense = 0;
    if (k != 0) {
      const int32_t r =
          resolve2(k >> AB, k & (((int64_t)1 << AB) - 1), src_c[0]);
      const int64_t mr = r < 0 || !is_make_action(action[r])
                             ? -1
                             : make_rank(r);
      if (mr < 0)
        obj_fallback = true;
      else
        dense = (int32_t)(1 + mr);
    }
    if (!obj_fallback) std::fill(obj_dense, obj_dense + N, dense);
  } else {
    int64_t memo_obj_key = -1;
    int32_t memo_obj_dense = 0;
    for (int64_t j = 0; j < N; j++) {
      const int64_t k = obj_key[j];
      if (k == 0) {
        obj_dense[j] = 0;
        continue;
      }
      if (k == memo_obj_key) {
        obj_dense[j] = memo_obj_dense;
        continue;
      }
      const int32_t r = resolve2(k >> AB, k & (((int64_t)1 << AB) - 1),
                                 src_c[j]);
      const int64_t mr = r < 0 || !is_make_action(action[r])
                             ? -1
                             : make_rank(r);
      if (mr < 0) {
        obj_fallback = true;  // partial history: host recomputes the table
        break;
      }
      memo_obj_key = k;
      memo_obj_dense = (int32_t)(1 + mr);
      obj_dense[j] = memo_obj_dense;
    }
  }

  // ---- 5. pred edges -------------------------------------------------------
  for (int64_t c = 0; c < C; c++) {
    const int32_t* pnum = (const int32_t*)cp(c, 15);
    const int64_t* pctr = (const int64_t*)cp(c, 16);
    const int32_t* pact = (const int32_t*)cp(c, 17);
    int64_t k = pred_off[c];
    const int64_t kend = pred_off[c + 1];
    for (int64_t i = 0; i < n_ops[c]; i++) {
      const int32_t np = pnum[i];
      if (np < 0 || k + np > kend) return -10;
      for (int32_t e = 0; e < np; e++, k++) {
        const int64_t pc_local = k - pred_off[c];
        const int64_t ctr = pctr[pc_local];
        const int32_t pa = pact[pc_local];
        if (pa < 0 || pa >= tab_size[c]) return -11;
        if (ctr < 0 || ctr >= ((int64_t)1 << 43)) return -12;
        pred_src[k] = newrow[row_off[c] + i];
        pred_tgt[k] = resolve2(ctr, tab_all[tab_off[c] + pa], c);
      }
    }
    if (k != kend) return -13;  // pred_num sum != q_ops for this change
  }

  return obj_fallback ? 1 : 0;
}

}  // extern "C"
