// Native map-put session: the local map-transaction hot path.
//
// The reference's local map op path (transaction/inner.rs:399-451
// local_map_op: pred lookup in the op tree, op insert, succ marking) runs
// per-op in Rust; the Python transaction layer pays ~13us/op on the same
// work. This session owns ONE map object's visible-winner state for the
// duration of a transaction: a put resolves its pred (the key's current
// winner) in a C++ hash map, encodes the scalar payload into the change
// column's raw form, and the emitted ops are exported as arrays for the
// array-native change encoder at commit (storage/change.py
// encode_ops_with_map_tail).
//
// Eligibility is gated by the Python wrapper (core/transaction.py
// fast_put_fn): MAP object, no conflicted (multi-winner) keys, no
// isolation scope, actor indices < 2^20. Ids pack as
// (counter << 20 | doc actor index), matching session.cpp.

#include <cstddef>
#include <cstdint>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

using std::size_t;

namespace {

using i64 = long long;
using i32 = int32_t;
using u8 = uint8_t;

// value_meta type codes (types.py VALUE_TYPE_*, reference value.rs)
constexpr i32 V_NULL = 0;
constexpr i32 V_FALSE = 1;
constexpr i32 V_TRUE = 2;
constexpr i32 V_UINT = 3;  // uleb
constexpr i32 V_INT = 4;   // sleb
constexpr i32 V_F64 = 5;
constexpr i32 V_STR = 6;
constexpr i32 V_BYTES = 7;
constexpr i32 V_COUNTER = 8;    // sleb
constexpr i32 V_TIMESTAMP = 9;  // sleb

struct MOp {
  i64 id;       // packed (ctr << 20 | rank)
  i64 pred;     // overwritten winner id, 0 = fresh key
  i64 vmeta;    // (raw_len << 4) | type_code
  i64 raw_off;  // into MapSession::raw
  i64 raw_len;
  i32 key;      // interned key index
};

struct MapSession {
  std::unordered_map<std::string, i32> index;  // key -> key table index
  std::vector<i64> key_off;                    // n_keys+1 arena offsets
  std::vector<char> key_arena;                 // concatenated utf-8 keys
  std::vector<i64> winner;  // per key index: current winner id (0 = none)
  std::vector<MOp> ops;
  std::vector<u8> raw;  // concatenated value payload bytes
  i64 rank = 0;

  MapSession() { key_off.push_back(0); }

  i32 intern(const char* key, i64 len) {
    std::string k(key, (size_t)len);
    auto it = index.find(k);
    if (it != index.end()) return it->second;
    i32 idx = (i32)winner.size();
    index.emplace(std::move(k), idx);
    key_arena.insert(key_arena.end(), key, key + len);
    key_off.push_back((i64)key_arena.size());
    winner.push_back(0);
    return idx;
  }
};

void put_sleb(std::vector<u8>& out, i64 v) {
  for (;;) {
    u8 byte = (u8)(v & 0x7F);
    v >>= 7;  // arithmetic shift: sign-extends
    if ((v == 0 && !(byte & 0x40)) || (v == -1 && (byte & 0x40))) {
      out.push_back(byte);
      return;
    }
    out.push_back(byte | 0x80);
  }
}

void put_uleb(std::vector<u8>& out, unsigned long long v) {
  for (;;) {
    u8 byte = (u8)(v & 0x7F);
    v >>= 7;
    if (v == 0) {
      out.push_back(byte);
      return;
    }
    out.push_back(byte | 0x80);
  }
}

}  // namespace

extern "C" {

void* am_map_create(i64 rank) {
  auto* s = new MapSession();
  s->rank = rank;
  return s;
}

void am_map_destroy(void* p) { delete static_cast<MapSession*>(p); }

// Preload the object's visible keys: key i is key_bytes[key_offs[i] ..
// key_offs[i+1]) with current winner id winners[i]. Returns 0.
i64 am_map_init(void* p, const u8* key_bytes, const i64* key_offs,
                const i64* winners, i64 n) {
  MapSession& s = *static_cast<MapSession*>(p);
  for (i64 i = 0; i < n; i++) {
    i32 idx = s.intern((const char*)key_bytes + key_offs[i],
                       key_offs[i + 1] - key_offs[i]);
    s.winner[(size_t)idx] = winners[i];
  }
  return 0;
}

i64 am_map_op_count(void* p) {
  return (i64)static_cast<MapSession*>(p)->ops.size();
}

// One put. `code` is the value_meta type code; the payload is `ival` for
// int, `fval` for f64, `raw[0..raw_len)` for str/bytes, nothing for
// null/bool. Emits exactly one op (pred = the key's current winner) and
// promotes the new op to winner. Returns 1, or -3 for an unsupported code.
i64 am_map_put(void* p, i64 ctr, const char* key, i64 key_len, i32 code,
               i64 ival, double fval, const u8* rawv, i64 raw_len) {
  MapSession& s = *static_cast<MapSession*>(p);
  i32 kidx = s.intern(key, key_len);
  MOp op;
  op.id = (ctr << 20) | s.rank;
  op.key = kidx;
  op.pred = s.winner[(size_t)kidx];
  op.raw_off = (i64)s.raw.size();
  switch (code) {
    case V_NULL:
    case V_FALSE:
    case V_TRUE:
      break;
    case V_UINT:
      put_uleb(s.raw, (unsigned long long)ival);
      break;
    case V_INT:
    case V_COUNTER:
    case V_TIMESTAMP:
      put_sleb(s.raw, ival);
      break;
    case V_F64: {
      u8 buf[8];
      std::memcpy(buf, &fval, 8);  // x86/arm little-endian, like struct '<d'
      s.raw.insert(s.raw.end(), buf, buf + 8);
      break;
    }
    case V_STR:
    case V_BYTES:
      s.raw.insert(s.raw.end(), rawv, rawv + raw_len);
      break;
    default:
      return -3;
  }
  op.raw_len = (i64)s.raw.size() - op.raw_off;
  op.vmeta = (op.raw_len << 4) | code;
  s.ops.push_back(op);
  s.winner[(size_t)kidx] = op.id;
  return 1;
}

// Sizes needed to export ops [start, op_count): rows and raw-payload bytes.
i64 am_map_export_sizes(void* p, i64 start, i64* n_rows, i64* raw_bytes) {
  MapSession& s = *static_cast<MapSession*>(p);
  if (start < 0 || (size_t)start > s.ops.size()) return -1;
  *n_rows = (i64)s.ops.size() - start;
  i64 rb = 0;
  for (size_t i = (size_t)start; i < s.ops.size(); i++) rb += s.ops[i].raw_len;
  *raw_bytes = rb;
  return 0;
}

// Export emitted ops [start, op_count) in id (emission) order. Arrays must
// hold the counts from am_map_export_sizes. Returns rows written.
i64 am_map_export(void* p, i64 start, i64* ids, i64* key_idx, i64* preds,
                  i64* vmeta, u8* raw_out) {
  MapSession& s = *static_cast<MapSession*>(p);
  if (start < 0 || (size_t)start > s.ops.size()) return -1;
  i64 w = 0;
  i64 roff = 0;
  for (size_t i = (size_t)start; i < s.ops.size(); i++, w++) {
    const MOp& o = s.ops[i];
    ids[w] = o.id;
    key_idx[w] = o.key;
    preds[w] = o.pred;
    vmeta[w] = o.vmeta;
    std::memcpy(raw_out + roff, s.raw.data() + o.raw_off, (size_t)o.raw_len);
    roff += o.raw_len;
  }
  return w;
}

// Key-table export: sizes, then bytes + n_keys+1 offsets.
i64 am_map_keytab_sizes(void* p, i64* n_keys, i64* total_bytes) {
  MapSession& s = *static_cast<MapSession*>(p);
  *n_keys = (i64)s.winner.size();
  *total_bytes = (i64)s.key_arena.size();
  return 0;
}

i64 am_map_keytab(void* p, u8* bytes_out, i64* offs_out) {
  MapSession& s = *static_cast<MapSession*>(p);
  std::memcpy(bytes_out, s.key_arena.data(), s.key_arena.size());
  std::memcpy(offs_out, s.key_off.data(), s.key_off.size() * sizeof(i64));
  return (i64)s.winner.size();
}

}  // extern "C"
