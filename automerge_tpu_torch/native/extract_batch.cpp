// Batch column extraction: decode MANY changes' op columns in one native
// call per column kind, writing straight into unified output arrays.
//
// The change chunk's columnar encoding (reference:
// rust/automerge/src/storage/change/change_op_columns.rs) goes to numpy
// arrays without a per-change Python/FFI round trip.
//
// Layout contract (shared by all batch entry points):
//   buf       — all changes' bytes for this column, concatenated
//   off/len   — per-change slice of buf (len 0 = column absent)
//   row_off   — per-change output row offset; row_off[n_changes] = total
// Per change, exactly row_off[c+1]-row_off[c] rows are produced: a short
// column is padded with nulls, and a long one is cut there. The rows are
// those the change parser defines (storage/change.py decodes a change's
// ops from the first rows of each column and ignores what follows), so a
// column's tail past them is never read. Error return is -(c+1) for the
// first malformed change.

#include <cstdint>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

#include "leb.h"

namespace {

using i64 = long long;
using i32 = int32_t;
using u8 = uint8_t;
using amt::dec_sleb;
using amt::dec_uleb;

// One change's RLE column into out[0..cap); returns rows decoded (at most
// cap: decoding stops there) or -1.
i64 rle_one(const u8* buf, size_t len, int signed_vals, i64* out, u8* mask,
            size_t cap) {
  size_t pos = 0, row = 0;
  while (pos < len && row < cap) {
    int64_t header;
    int c = dec_sleb(buf + pos, len - pos, &header);
    if (c < 0) return -1;
    pos += (size_t)c;
    if (header > 0) {
      int64_t value;
      if (signed_vals) {
        c = dec_sleb(buf + pos, len - pos, &value);
      } else {
        uint64_t uv;
        c = dec_uleb(buf + pos, len - pos, &uv);
        value = (int64_t)uv;
      }
      if (c < 0) return -1;
      pos += (size_t)c;
      for (int64_t i = 0; i < header && row < cap; i++) {
        out[row] = value;
        mask[row] = 1;
        row++;
      }
    } else if (header < 0) {
      for (int64_t i = 0; i < -header && row < cap; i++) {
        int64_t value;
        if (signed_vals) {
          c = dec_sleb(buf + pos, len - pos, &value);
        } else {
          uint64_t uv;
          c = dec_uleb(buf + pos, len - pos, &uv);
          value = (int64_t)uv;
        }
        if (c < 0) return -1;
        pos += (size_t)c;
        out[row] = value;
        mask[row] = 1;
        row++;
      }
    } else {
      uint64_t nulls;
      c = dec_uleb(buf + pos, len - pos, &nulls);
      if (c < 0) return -1;
      pos += (size_t)c;
      for (uint64_t i = 0; i < nulls && row < cap; i++) {
        out[row] = 0;
        mask[row] = 0;
        row++;
      }
    }
  }
  return (i64)row;
}

}  // namespace

extern "C" {

i64 am_rle_decode_batch(const u8* buf, const i64* off, const i64* len,
                        const i64* row_off, i64 n_changes, int signed_vals,
                        i64* out, u8* mask) {
  for (i64 c = 0; c < n_changes; c++) {
    i64 lo = row_off[c], hi = row_off[c + 1];
    i64 n = rle_one(buf + off[c], (size_t)len[c], signed_vals, out + lo,
                    mask + lo, (size_t)(hi - lo));
    if (n < 0) return -(c + 1);
    for (i64 r = lo + n; r < hi; r++) {  // pad short columns with nulls
      out[r] = 0;
      mask[r] = 0;
    }
  }
  return 0;
}

// Delta: RLE of differences with the running absolute reset per change,
// saturating like the Python decoder (utils/codecs.py delta_decode).
i64 am_delta_decode_batch(const u8* buf, const i64* off, const i64* len,
                          const i64* row_off, i64 n_changes, i64* out,
                          u8* mask) {
  i64 rc = am_rle_decode_batch(buf, off, len, row_off, n_changes, 1, out, mask);
  if (rc != 0) return rc;
  for (i64 c = 0; c < n_changes; c++) {
    int64_t absolute = 0;
    for (i64 r = row_off[c]; r < row_off[c + 1]; r++) {
      if (mask[r]) {
        absolute = amt::sat_add(absolute, out[r]);
        out[r] = absolute;
      }
    }
  }
  return 0;
}

i64 am_bool_decode_batch(const u8* buf, const i64* off, const i64* len,
                         const i64* row_off, i64 n_changes, u8* out) {
  for (i64 c = 0; c < n_changes; c++) {
    i64 lo = row_off[c], hi = row_off[c + 1];
    size_t pos = 0, row = 0, cap = (size_t)(hi - lo);
    const u8* p = buf + off[c];
    size_t n = (size_t)len[c];
    u8 value = 1;
    while (pos < n && row < cap) {
      uint64_t run;
      int k = dec_uleb(p + pos, n - pos, &run);
      if (k < 0) return -(c + 1);
      pos += (size_t)k;
      value = !value;
      size_t take = run > cap - row ? cap - row : (size_t)run;
      memset(out + lo + row, value, take);
      row += take;
    }
    memset(out + lo + row, 0, cap - row);
  }
  return 0;
}

// String-RLE columns (map keys, mark names) decoded + content-interned in
// one pass. Per row: the interned string id (or -1 for null). The table is
// returned as (tab_off, tab_len) slices of `buf` in first-seen order.
// Returns the table size, or -(c+1) on error, or -1000000000 - needed if
// the table overflows max_tab. A column's rows past its change's row count
// are cut, as a change chunk's parser ignores a column's tail; with
// `strict` (a document chunk's key-string column) a null run or a value
// run past the row count is an error instead, -(c+1).
i64 am_rle_decode_batch_strtab(const u8* buf, const i64* off, const i64* len,
                               const i64* row_off, i64 n_changes,
                               i32* out_ids, i64* tab_off, i64* tab_len,
                               i64 max_tab, i64 strict) {
  std::unordered_map<std::string, i32> intern;
  i64 tab_n = 0;
  for (i64 c = 0; c < n_changes; c++) {
    i64 lo = row_off[c], hi = row_off[c + 1];
    size_t cap = (size_t)(hi - lo), row = 0, pos = 0;
    const u8* p = buf + off[c];
    size_t n = (size_t)len[c];
    while (pos < n && (strict || row < cap)) {
      int64_t header;
      int k = dec_sleb(p + pos, n - pos, &header);
      if (k < 0) return -(c + 1);
      pos += (size_t)k;
      if (header == 0) {
        uint64_t nulls;
        k = dec_uleb(p + pos, n - pos, &nulls);
        if (k < 0) return -(c + 1);
        pos += (size_t)k;
        if (strict && nulls > cap - row) return -(c + 1);
        for (uint64_t i = 0; i < nulls && row < cap; i++) out_ids[lo + row++] = -1;
        continue;
      }
      // a run stores its string once; a literal one string a row
      const uint64_t count = header > 0 ? (uint64_t)header : 0 - (uint64_t)header;
      const uint64_t strings = header > 0 ? 1 : count;
      for (uint64_t rep = 0; rep < strings && (strict || row < cap); rep++) {
        uint64_t slen;
        k = dec_uleb(p + pos, n - pos, &slen);
        if (k < 0) return -(c + 1);
        pos += (size_t)k;
        if (slen > n - pos) return -(c + 1);
        std::string s((const char*)(p + pos), (size_t)slen);
        auto it = intern.find(s);
        i32 id;
        if (it == intern.end()) {
          if (tab_n >= max_tab) return -1000000000 - (tab_n + 1);
          id = (i32)tab_n;
          tab_off[tab_n] = (i64)(off[c] + (i64)pos);
          tab_len[tab_n] = (i64)slen;
          tab_n++;
          intern.emplace(std::move(s), id);
        } else {
          id = it->second;
        }
        pos += (size_t)slen;
        const uint64_t reps = header > 0 ? count : 1;
        if (strict && reps > cap - row) return -(c + 1);
        for (uint64_t i = 0; i < reps && row < cap; i++) out_ids[lo + row++] = id;
      }
    }
    for (; row < cap; row++) out_ids[lo + row] = -1;
  }
  return tab_n;
}

// Per-change string tables from batch-interned ids: change c's table is
// the batch ids its rows use, in first-seen order, written to
// tab_ids[tab_start[c]..tab_start[c+1]); local[r] is the row's index in its
// change's table (-1 for null). ``stamp`` holds n_tab entries of scratch.
// A change's ids thus depend on that change alone, never on which changes
// were decoded in the same batch.
i64 am_localize_ids(const i32* ids, const i64* row_off, i64 n_changes,
                    i64 n_tab, i32* local, i32* tab_ids, i64* tab_start,
                    i64* stamp) {
  for (i64 t = 0; t < n_tab; t++) stamp[t] = -1;
  i64 w = 0;
  for (i64 c = 0; c < n_changes; c++) {
    tab_start[c] = w;
    const i64 base = w;
    for (i64 r = row_off[c]; r < row_off[c + 1]; r++) {
      const i32 g = ids[r];
      if (g < 0) {
        local[r] = -1;
        continue;
      }
      if (g >= n_tab) return -(c + 1);
      // stamp[g] packs (change, local id): its change's ids start at base
      if (stamp[g] < base) {
        stamp[g] = w;
        tab_ids[w++] = g;
      }
      local[r] = (i32)(stamp[g] - base);
    }
  }
  tab_start[n_changes] = w;
  return w;
}

// Integer value payloads: decode LEB at (voff, vlen) for rows whose code is
// an integer kind (3 = uleb uint; 4/8/9 = sleb int/counter/timestamp).
i64 am_leb_decode_rows(const u8* raw, i64 raw_len, const i64* voff,
                       const i64* vlen, const i32* vcode, i64 n, i64* out) {
  for (i64 r = 0; r < n; r++) {
    i32 code = vcode[r];
    out[r] = code == 2 ? 1 : 0;  // boolean true is payload-free
    if (vlen[r] <= 0) continue;
    if (code != 3 && code != 4 && code != 8 && code != 9) continue;
    if (voff[r] < 0 || voff[r] + vlen[r] > raw_len) return -(r + 1);
    const u8* p = raw + voff[r];
    if (code == 3) {
      uint64_t v;
      if (dec_uleb(p, (size_t)vlen[r], &v) < 0) return -(r + 1);
      out[r] = (i64)v;
    } else {
      int64_t v;
      if (dec_sleb(p, (size_t)vlen[r], &v) < 0) return -(r + 1);
      out[r] = v;
    }
  }
  return 0;
}

}  // extern "C"
