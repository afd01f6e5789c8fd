// The op columns of one change chunk checked in one pass, without
// decoding an op: what automerge_tpu_torch/storage/change.py's
// decode_change_ops (with utils/codecs.py's decoders and
// storage/values.py's decode_values) and the parser's actor bounds check
// accept and reject, with the op count they decode. The parser keeps the
// column bytes and decodes ops only when they are read (LazyOps).
//
// The Python decoders' rules, mirrored here:
//   - a column read without a row count (action, key string, key counter,
//     object actor and counter, key actor, pred group, mark name) decodes
//     every value up to 2^24, and is malformed past that with bytes left;
//   - a column read with a row count (insert, expand and value metadata to
//     the op count; pred actor and counter to the sum of every decoded
//     pred group) stops there: the bytes after it are not read, but a
//     literal run once begun is decoded to its end;
//   - the op count is the longest of the action, key string and key
//     counter columns; a shorter column reads as nulls past its end;
//   - strings are UTF-8 as Python's strict decoder takes it.
// A pred column that would decode to more than 2^26 values is refused
// (the Python decoder would build a list of them first).

#include <cstddef>
#include <cstdint>
#include <initializer_list>

#include "leb.h"

namespace {

using u8 = uint8_t;
using amt::dec_sleb;
using amt::dec_uleb;

constexpr uint64_t MAX_COLUMN_VALUES = 1ull << 24;
constexpr uint64_t MAX_PRED_VALUES = 1ull << 26;
constexpr uint64_t UNBOUNDED = 1ull << 62;

enum Err : long long {
  ERR_COLUMN = -1,      // malformed column bytes
  ERR_ACTION = -2,      // an op without an action
  ERR_OBJ = -3,         // half-null object id
  ERR_KEY = -4,         // neither map key nor element id
  ERR_META = -5,        // value metadata short or null
  ERR_VALUE = -6,       // a value's raw bytes
  ERR_PRED = -7,        // truncated pred columns
  ERR_ACTOR = -8,       // actor index outside the change's table
  ERR_TOO_MANY = -9,    // a column demands too many values
};

// Strict UTF-8 (RFC 3629: no overlongs, no surrogates, at most U+10FFFF).
bool utf8_ok(const u8* s, uint64_t n) {
  uint64_t i = 0;
  while (i < n) {
    const u8 c = s[i];
    if (c < 0x80) {
      i++;
      continue;
    }
    int k;
    u8 lo = 0x80, hi = 0xBF;
    if (c >= 0xC2 && c <= 0xDF) {
      k = 1;
    } else if (c >= 0xE0 && c <= 0xEF) {
      k = 2;
      if (c == 0xE0) lo = 0xA0;
      if (c == 0xED) hi = 0x9F;
    } else if (c >= 0xF0 && c <= 0xF4) {
      k = 3;
      if (c == 0xF0) lo = 0x90;
      if (c == 0xF4) hi = 0x8F;
    } else {
      return false;
    }
    if (n - i <= (uint64_t)k) return false;
    if (s[i + 1] < lo || s[i + 1] > hi) return false;
    for (int j = 2; j <= k; j++)
      if (s[i + j] < 0x80 || s[i + j] > 0xBF) return false;
    i += (uint64_t)k + 1;
  }
  return true;
}

enum Kind { UINT, SINT, STR };

// An RLE column read value by value the way utils/codecs.py's rle_decode
// reads it with ``limit`` as its row count.
struct Cursor {
  const u8* p;
  uint64_t len;
  Kind kind;
  uint64_t limit;
  uint64_t pos = 0;
  uint64_t count = 0;  // values produced
  int state = 0;       // 1 repeat run, 2 literal run, 3 null run
  uint64_t left = 0;   // values left in the current run
  int64_t val = 0;     // the repeat run's value
  bool bad = false;

  Cursor(const u8* p_, int64_t len_, Kind kind_, uint64_t limit_)
      : p(p_), len((uint64_t)len_), kind(kind_), limit(limit_) {}

  bool value(int64_t* v) {
    if (kind == UINT) {
      uint64_t u;
      const int c = dec_uleb(p + pos, len - pos, &u);
      if (c < 0) return false;
      pos += (uint64_t)c;
      *v = (int64_t)u;
      return true;
    }
    if (kind == SINT) {
      const int c = dec_sleb(p + pos, len - pos, v);
      if (c < 0) return false;
      pos += (uint64_t)c;
      return true;
    }
    uint64_t n;
    const int c = dec_uleb(p + pos, len - pos, &n);
    if (c < 0) return false;
    pos += (uint64_t)c;
    if (n > len - pos || !utf8_ok(p + pos, n)) return false;
    pos += n;
    *v = 0;
    return true;
  }

  // the next run's header (and a repeat run's value); false when malformed
  bool header() {
    int64_t h;
    const int c = dec_sleb(p + pos, len - pos, &h);
    if (c < 0) return false;
    pos += (uint64_t)c;
    if (h > 0) {
      if (!value(&val)) return false;
      state = 1;
      left = (uint64_t)h;
    } else if (h < 0) {
      state = 2;
      left = 0 - (uint64_t)h;
    } else {
      const int k = dec_uleb(p + pos, len - pos, &left);
      if (k < 0) return false;
      pos += (uint64_t)k;
      state = 3;
    }
    return true;
  }

  // 1: a value in *v; 0: a null; -1: no more values (a null to the
  // caller); -2: malformed
  int next(int64_t* v) {
    if (bad) return -2;
    if (count >= limit) return -1;
    while (left == 0) {
      if (pos >= len) return -1;
      if (!header()) {
        bad = true;
        return -2;
      }
    }
    left--;
    count++;
    if (state == 1) {
      *v = val;
      return 1;
    }
    if (state == 2) {
      if (!value(v)) {
        bad = true;
        return -2;
      }
      return 1;
    }
    return 0;
  }

  // Read on to the limit (or the end) as the Python decoder does, runs
  // skipped whole; ``sum`` adds the values read (saturating at 2^62).
  bool drain(uint64_t* sum = nullptr) {
    if (bad) return false;
    while (count < limit) {
      if (left == 0) {
        if (pos >= len) break;
        if (!header()) return false;
        continue;
      }
      const uint64_t k = left < limit - count ? left : limit - count;
      if (state == 2) {
        for (uint64_t i = 0; i < k; i++) {
          int64_t v;
          if (!value(&v)) return false;
          if (sum) add(sum, (uint64_t)v, 1);
        }
      } else if (state == 1 && sum) {
        add(sum, (uint64_t)val, k);
      }
      left -= k;
      count += k;
    }
    // a literal run once begun is decoded to its end
    if (state == 2) {
      for (; left; left--) {
        int64_t v;
        if (!value(&v)) return false;
      }
    }
    return true;
  }

  static void add(uint64_t* sum, uint64_t v, uint64_t k) {
    unsigned __int128 s = (unsigned __int128)v * k + *sum;
    *sum = s >= UNBOUNDED ? UNBOUNDED : (uint64_t)s;
  }
};

// A column read without a row count: its value count, or an error code.
long long count_all(const u8* p, int64_t len, Kind kind, uint64_t* sum = nullptr) {
  Cursor c(p, len, kind, MAX_COLUMN_VALUES);
  if (!c.drain(sum)) return ERR_COLUMN;
  if (c.count >= MAX_COLUMN_VALUES && c.pos < c.len) return ERR_TOO_MANY;
  return (long long)c.count;
}

// A boolean column read to ``n`` rows (utils/codecs.py boolean_decode).
bool bools_ok(const u8* p, int64_t len_, uint64_t n) {
  const uint64_t len = (uint64_t)len_;
  uint64_t pos = 0, row = 0;
  while (pos < len && row < n) {
    uint64_t run;
    const int k = dec_uleb(p + pos, len - pos, &run);
    if (k < 0) return false;
    pos += (uint64_t)k;
    row += run < n - row ? run : n - row;
  }
  return true;
}

// One value's raw bytes as storage/values.py _decode_one takes them.
bool value_ok(uint64_t code, const u8* raw, uint64_t n) {
  switch (code) {
    case 0:
    case 1:
    case 2:
      return n == 0;
    case 3: {
      uint64_t v;
      return n > 0 && n <= 10 && dec_uleb(raw, n, &v) == (int)n;
    }
    case 4:
    case 8:
    case 9: {
      int64_t v;
      return n > 0 && n <= 10 && dec_sleb(raw, n, &v) == (int)n;
    }
    case 5:
      return n == 8;
    case 6:
      return utf8_ok(raw, n);
    default:
      return true;
  }
}

}  // namespace

extern "C" {

// Column order of ``cols``/``lens``: obj actor, obj counter, key actor, key
// counter, key string, insert, action, value meta, value raw, pred group,
// pred actor, pred counter, expand, mark name (storage/change.py's
// COL_* specs 1, 2, 17, 19, 21, 52, 66, 86, 87, 112, 113, 115, 148, 165).
// Returns the op count, or a negative Err.
long long am_change_check(const u8* const* cols, const int64_t* lens,
                          int64_t n_actors) {
  enum { OBJ_ACTOR, OBJ_CTR, KEY_ACTOR, KEY_CTR, KEY_STR, INSERT, ACTION,
         VAL_META, VAL_RAW, PRED_GROUP, PRED_ACTOR, PRED_CTR, EXPAND,
         MARK_NAME };
  auto col = [&](int k) { return cols[k]; };

  // the columns read without a row count, whole
  long long c;
  uint64_t n = 0;
  for (int k : {ACTION, KEY_STR, KEY_CTR}) {
    c = count_all(col(k), lens[k], k == KEY_STR ? STR : k == KEY_CTR ? SINT : UINT);
    if (c < 0) return c;
    if ((uint64_t)c > n) n = (uint64_t)c;
  }
  for (int k : {OBJ_ACTOR, OBJ_CTR, KEY_ACTOR, MARK_NAME}) {
    c = count_all(col(k), lens[k], k == MARK_NAME ? STR : UINT);
    if (c < 0) return c;
  }
  uint64_t total_preds = 0;
  c = count_all(col(PRED_GROUP), lens[PRED_GROUP], UINT, &total_preds);
  if (c < 0) return c;
  if (!bools_ok(col(INSERT), lens[INSERT], n) ||
      !bools_ok(col(EXPAND), lens[EXPAND], n))
    return ERR_COLUMN;

  // the pred columns to their row count: how many values each holds
  uint64_t pred_avail = UNBOUNDED;
  for (int k : {PRED_ACTOR, PRED_CTR}) {
    Cursor pc(col(k), lens[k], k == PRED_CTR ? SINT : UINT, total_preds);
    if (!pc.drain()) return ERR_COLUMN;
    if (pc.count > MAX_PRED_VALUES) return ERR_TOO_MANY;
    if (pc.count < pred_avail) pred_avail = pc.count;
  }

  // the ops, row by row
  Cursor action(col(ACTION), lens[ACTION], UINT, MAX_COLUMN_VALUES);
  Cursor obj_actor(col(OBJ_ACTOR), lens[OBJ_ACTOR], UINT, MAX_COLUMN_VALUES);
  Cursor obj_ctr(col(OBJ_CTR), lens[OBJ_CTR], UINT, MAX_COLUMN_VALUES);
  Cursor key_actor(col(KEY_ACTOR), lens[KEY_ACTOR], UINT, MAX_COLUMN_VALUES);
  Cursor key_ctr(col(KEY_CTR), lens[KEY_CTR], SINT, MAX_COLUMN_VALUES);
  Cursor key_str(col(KEY_STR), lens[KEY_STR], STR, MAX_COLUMN_VALUES);
  Cursor meta(col(VAL_META), lens[VAL_META], UINT, n);
  Cursor pred_num(col(PRED_GROUP), lens[PRED_GROUP], UINT, MAX_COLUMN_VALUES);
  Cursor pred_actor(col(PRED_ACTOR), lens[PRED_ACTOR], UINT, total_preds);
  Cursor pred_ctr(col(PRED_CTR), lens[PRED_CTR], SINT, total_preds);
  const u8* raw = col(VAL_RAW);
  const uint64_t raw_len = (uint64_t)lens[VAL_RAW];
  const uint64_t actors = (uint64_t)n_actors;
  uint64_t raw_pos = 0, pi = 0;
  int64_t key_abs = 0;  // the key counter column's running absolute
  for (uint64_t i = 0; i < n; i++) {
    int64_t v, oa, oc, ka, kc, m, pn;
    if (action.next(&v) != 1) return action.bad ? ERR_COLUMN : ERR_ACTION;
    const int has_oa = obj_actor.next(&oa), has_oc = obj_ctr.next(&oc);
    if (has_oa == -2 || has_oc == -2) return ERR_COLUMN;
    if ((has_oa == 1) != (has_oc == 1)) return ERR_OBJ;
    if (has_oa == 1 && (uint64_t)oa >= actors) return ERR_ACTOR;
    const int has_ks = key_str.next(&v), has_kc = key_ctr.next(&kc),
              has_ka = key_actor.next(&ka);
    if (has_ks == -2 || has_kc == -2 || has_ka == -2) return ERR_COLUMN;
    if (has_kc == 1) key_abs = amt::sat_add(key_abs, kc);
    if (has_ks == 1) {
      // a map key
    } else if (has_kc == 1 && key_abs == 0 && has_ka != 1) {
      // HEAD
    } else if (has_kc == 1 && has_ka == 1) {
      if ((uint64_t)ka >= actors) return ERR_ACTOR;
    } else {
      return ERR_KEY;
    }
    const int has_m = meta.next(&m);
    if (has_m == -2) return ERR_COLUMN;
    if (has_m != 1) return ERR_META;
    const uint64_t vlen = (uint64_t)m >> 4;
    if (vlen > raw_len - raw_pos) return ERR_VALUE;
    if (!value_ok((uint64_t)m & 0xF, raw + raw_pos, vlen)) return ERR_VALUE;
    raw_pos += vlen;
    const int has_pn = pred_num.next(&pn);
    if (has_pn == -2) return ERR_COLUMN;
    if (has_pn == 1 && pn != 0) {
      if ((uint64_t)pn > pred_avail - pi) return ERR_PRED;
      for (int64_t e = 0; e < pn; e++, pi++) {
        int64_t pa, pc;
        const int has_pa = pred_actor.next(&pa), has_pc = pred_ctr.next(&pc);
        if (has_pa == -2 || has_pc == -2) return ERR_COLUMN;
        if (has_pa != 1 || has_pc != 1) return ERR_PRED;
        if ((uint64_t)pa >= actors) return ERR_ACTOR;
      }
    }
  }
  if (!meta.drain()) return ERR_COLUMN;
  return (long long)n;
}

}  // extern "C"
