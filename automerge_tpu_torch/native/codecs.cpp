// Single-column codecs of the document layer: the RLE, delta and boolean
// encoders the array-native save and load paths build their columns with,
// the decoders the document-chunk load reads them back with, and the RLE
// encoder of a string column given as ids into a table.
//
// Byte-compatible with automerge_tpu_torch/utils/codecs.py (the Python
// encoders' state machines are mirrored exactly: change hashes are taken
// over these bytes) and with the reference's columnar encodings
// (rust/automerge/src/columnar/encoding/{rle.rs,delta.rs,boolean.rs}).
// Decoders are bounds-checked and clamp run lengths to the caller's
// capacity; encoders return -1 when the output buffer is too small.

#include <cstddef>
#include <cstdint>
#include <cstring>

#include "leb.h"

namespace {

using amt::dec_sleb;
using amt::dec_uleb;

inline int64_t sat_sub(int64_t a, int64_t b) {
  int64_t r;
  if (__builtin_sub_overflow(a, b, &r)) return b < 0 ? INT64_MAX : INT64_MIN;
  return r;
}

struct Writer {
  uint8_t* out;
  size_t cap;
  size_t w = 0;
  bool ok = true;

  bool need(size_t k) {
    if (w + k > cap) ok = false;
    return ok;
  }
  void uleb(uint64_t v) {
    if (!need(10)) return;
    do {
      uint8_t b = v & 0x7f;
      v >>= 7;
      if (v) b |= 0x80;
      out[w++] = b;
    } while (v);
  }
  void sleb(int64_t v) {
    if (!need(10)) return;
    for (;;) {
      uint8_t b = v & 0x7f;
      v >>= 7;  // arithmetic shift
      const bool done = (v == 0 && !(b & 0x40)) || (v == -1 && (b & 0x40));
      if (!done) b |= 0x80;
      out[w++] = b;
      if (done) return;
    }
  }
  void value(int64_t v, int signed_vals) {
    if (signed_vals) sleb(v);
    else uleb((uint64_t)v);
  }
  void bytes(const uint8_t* p, size_t n) {
    if (!need(n)) return;
    std::memcpy(out + w, p, n);
    w += n;
  }
};

inline int read_value(const uint8_t* p, size_t n, int signed_vals, int64_t* v) {
  if (signed_vals) return dec_sleb(p, n, v);
  uint64_t uv;
  int c = dec_uleb(p, n, &uv);
  *v = (int64_t)uv;
  return c;
}

}  // namespace

extern "C" {

// RLE decode: values into out[], validity into mask[] (1 = present).
// signed_vals: 0 = ULEB values, 1 = SLEB values. Returns the rows decoded
// (at most capacity), or -1 on malformed input.
long long am_rle_decode_i64(const uint8_t* buf, size_t len, int signed_vals,
                            int64_t* out, uint8_t* mask, size_t capacity) {
  size_t pos = 0, row = 0;
  while (pos < len && row < capacity) {
    int64_t header;
    int c = dec_sleb(buf + pos, len - pos, &header);
    if (c < 0) return -1;
    pos += (size_t)c;
    if (header > 0) {
      int64_t value;
      c = read_value(buf + pos, len - pos, signed_vals, &value);
      if (c < 0) return -1;
      pos += (size_t)c;
      size_t take = (size_t)header;
      if (take > capacity - row) take = capacity - row;
      for (size_t i = 0; i < take; i++, row++) {
        out[row] = value;
        mask[row] = 1;
      }
    } else if (header < 0) {
      size_t litn = (size_t)(-header);
      for (size_t i = 0; i < litn; i++) {
        int64_t value;
        c = read_value(buf + pos, len - pos, signed_vals, &value);
        if (c < 0) return -1;
        pos += (size_t)c;
        if (row < capacity) {
          out[row] = value;
          mask[row] = 1;
          row++;
        }
      }
    } else {
      uint64_t nulls;
      c = dec_uleb(buf + pos, len - pos, &nulls);
      if (c < 0) return -1;
      pos += (size_t)c;
      size_t take = (size_t)nulls;
      if (take > capacity - row) take = capacity - row;
      for (size_t i = 0; i < take; i++, row++) {
        out[row] = 0;
        mask[row] = 0;
      }
    }
  }
  return (long long)row;
}

// Delta decode: an RLE column of successive differences, summed from 0
// (saturating).
long long am_delta_decode_i64(const uint8_t* buf, size_t len, int64_t* out,
                              uint8_t* mask, size_t capacity) {
  long long n = am_rle_decode_i64(buf, len, 1, out, mask, capacity);
  if (n < 0) return n;
  int64_t absolute = 0;
  for (long long i = 0; i < n; i++) {
    if (mask[i]) {
      absolute = amt::sat_add(absolute, out[i]);
      out[i] = absolute;
    }
  }
  return n;
}

// Boolean decode: alternating ULEB run lengths, starting with false.
long long am_bool_decode(const uint8_t* buf, size_t len, uint8_t* out,
                         size_t capacity) {
  size_t pos = 0, row = 0;
  uint8_t value = 1;
  while (pos < len && row < capacity) {
    uint64_t run;
    int c = dec_uleb(buf + pos, len - pos, &run);
    if (c < 0) return -1;
    pos += (size_t)c;
    value = !value;
    size_t take = (size_t)run;
    if (take > capacity - row) take = capacity - row;
    std::memset(out + row, value, take);
    row += take;
  }
  return (long long)row;
}

// RLE encode, the state machine of utils/codecs.py RleEncoder: a run of
// two or more equal values is sleb(count) + value, a literal run is
// sleb(-k) + k values, a null run is sleb(0) + uleb(count); an all-null
// column encodes to zero bytes. Returns bytes written, or -1 if out_cap
// is too small.
long long am_rle_encode_i64(const int64_t* vals, const uint8_t* mask, size_t n,
                            int signed_vals, uint8_t* out, size_t out_cap) {
  Writer wr{out, out_cap};
  size_t i = 0;
  while (i < n && wr.ok) {
    if (!mask[i]) {
      size_t j = i;
      while (j < n && !mask[j]) j++;
      if (i == 0 && j == n) return 0;
      wr.sleb(0);
      wr.uleb((uint64_t)(j - i));
      i = j;
      continue;
    }
    size_t j = i + 1;
    while (j < n && mask[j] && vals[j] == vals[i]) j++;
    if (j - i >= 2) {
      wr.sleb((int64_t)(j - i));
      wr.value(vals[i], signed_vals);
      i = j;
      continue;
    }
    // literal run: values until a pair of equal values or a null
    const size_t lit_start = i;
    for (;;) {
      if (j >= n || !mask[j]) break;
      if (vals[j] == vals[j - 1]) {  // a run starts at j - 1
        j--;
        break;
      }
      j++;
    }
    wr.sleb(-(int64_t)(j - lit_start));
    for (size_t k = lit_start; k < j && wr.ok; k++) wr.value(vals[k], signed_vals);
    i = j;
  }
  return wr.ok ? (long long)wr.w : -1;
}

// Delta encode: the signed RLE of successive differences (nulls keep no
// running value). scratch holds n int64.
long long am_delta_encode_i64(const int64_t* vals, const uint8_t* mask,
                              size_t n, uint8_t* out, size_t out_cap,
                              int64_t* scratch) {
  int64_t absolute = 0;
  for (size_t i = 0; i < n; i++) {
    if (mask[i]) {
      scratch[i] = sat_sub(vals[i], absolute);
      absolute = vals[i];
    } else {
      scratch[i] = 0;
    }
  }
  return am_rle_encode_i64(scratch, mask, n, 1, out, out_cap);
}

// Boolean encode: alternating run lengths, the first a run of false.
long long am_bool_encode(const uint8_t* vals, size_t n, uint8_t* out,
                         size_t out_cap) {
  Writer wr{out, out_cap};
  uint8_t last = 0;
  size_t count = 0;
  for (size_t i = 0; i < n && wr.ok; i++) {
    uint8_t v = vals[i] ? 1 : 0;
    if (v == last) {
      count++;
    } else {
      wr.uleb((uint64_t)count);
      last = v;
      count = 1;
    }
  }
  if (count > 0 && wr.ok) wr.uleb((uint64_t)count);
  return wr.ok ? (long long)wr.w : -1;
}

// String RLE encode from ids into a table (-1 = null): the framing of
// am_rle_encode_i64, each value written as uleb(byte length) + its UTF-8
// bytes. Equal ids are equal strings (the table is interned).
long long am_rle_encode_strtab(const int64_t* ids, int64_t n,
                               const int64_t* tab_off, const int64_t* tab_len,
                               const uint8_t* tab_buf, uint8_t* out,
                               int64_t out_cap) {
  Writer wr{out, (size_t)out_cap};
  auto value = [&](int64_t id) {
    wr.uleb((uint64_t)tab_len[id]);
    wr.bytes(tab_buf + tab_off[id], (size_t)tab_len[id]);
  };
  int64_t i = 0;
  while (i < n && wr.ok) {
    if (ids[i] < 0) {
      int64_t j = i;
      while (j < n && ids[j] < 0) j++;
      if (i == 0 && j == n) return 0;
      wr.sleb(0);
      wr.uleb((uint64_t)(j - i));
      i = j;
      continue;
    }
    int64_t j = i + 1;
    while (j < n && ids[j] == ids[i]) j++;
    if (j - i >= 2) {
      wr.sleb(j - i);
      value(ids[i]);
      i = j;
      continue;
    }
    const int64_t lit_start = i;
    for (;;) {
      if (j >= n || ids[j] < 0) break;
      if (ids[j] == ids[j - 1]) {
        j--;
        break;
      }
      j++;
    }
    wr.sleb(-(j - lit_start));
    for (int64_t k = lit_start; k < j && wr.ok; k++) value(ids[k]);
    i = j;
  }
  return wr.ok ? (long long)wr.w : -1;
}

}  // extern "C"
