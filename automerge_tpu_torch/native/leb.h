// LEB128 decoders shared by the native sources: strict like the reference's
// parser (rust/automerge/src/storage/parse/leb128.rs) and like
// automerge_tpu_torch/utils/leb128.py, which they must accept and reject
// alike: truncation, values outside u64 / i64 and overlong encodings are
// errors.

#pragma once

#include <cstddef>
#include <cstdint>

namespace amt {

// Decode ULEB128; returns bytes consumed or -1 on error/truncation.
inline int dec_uleb(const uint8_t* p, size_t n, uint64_t* out) {
  uint64_t v = 0;
  int shift = 0;
  for (size_t i = 0; i < n && i < 10; i++) {
    uint64_t b = p[i] & 0x7f;
    if (shift == 63 && b > 1) return -1;  // overflow u64
    v |= b << shift;
    if (!(p[i] & 0x80)) {
      // reject non-canonical (overlong) encodings like the reference
      if (i > 0 && p[i] == 0) return -1;
      *out = v;
      return (int)(i + 1);
    }
    shift += 7;
  }
  return -1;
}

// Decode SLEB128; returns bytes consumed or -1 on error/truncation.
inline int dec_sleb(const uint8_t* p, size_t n, int64_t* out) {
  uint64_t v = 0;
  int shift = 0;
  for (size_t i = 0; i < n && i < 10; i++) {
    uint8_t byte = p[i];
    if (shift == 63 && (byte & 0x7f) != 0 && (byte & 0x7f) != 0x7f) return -1;
    v |= (uint64_t)(byte & 0x7f) << shift;
    shift += 7;
    if (!(byte & 0x80)) {
      if (shift < 64 && (byte & 0x40)) v |= ~(uint64_t)0 << shift;
      // reject overlong: a final 0x00 after continuation with no sign
      // effect, or 0x7f extending a negative number redundantly
      if (i > 0) {
        uint8_t prev = p[i - 1];
        if (byte == 0 && !(prev & 0x40) && (prev & 0x80)) return -1;
        if (byte == 0x7f && (prev & 0x40) && (prev & 0x80)) return -1;
      }
      *out = (int64_t)v;
      return (int)(i + 1);
    }
  }
  return -1;
}

inline int64_t sat_add(int64_t a, int64_t b) {
  int64_t r;
  if (__builtin_add_overflow(a, b, &r)) return b > 0 ? INT64_MAX : INT64_MIN;
  return r;
}

}  // namespace amt
