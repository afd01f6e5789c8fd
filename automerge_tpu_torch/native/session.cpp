// Native text-edit session: the local-transaction hot path.
//
// The reference replays its edit trace through Rust (criterion
// rust/edit-trace/benches/main.rs splice loop over
// transaction/inner.rs:600-714 inner_splice); the Python transaction
// layer cannot match that per-op. This session owns ONE text object's
// visible-element state for the duration of a transaction: splices are
// resolved (position seek, mid-element rewind, delete walk, insert
// chaining) entirely in C++, and the emitted ops are exported as arrays
// for the array-native change encoder at commit. Deleted elements are
// physically unlinked — a session list never accumulates tombstone
// deserts, so the position cursor walk stays O(edit locality).
//
// Eligibility is gated by the Python wrapper: TEXT object, no marks, no
// multi-winner (conflicted) elements, no isolation scope. Ids pack as
// (counter << 20 | doc actor index); the wrapper translates to
// chunk-local actor tables at commit.

#include <cstddef>
#include <cstdint>
#include <algorithm>
#include <vector>

using std::size_t;

namespace {

using i64 = long long;
using i32 = int32_t;
using u8 = uint8_t;

constexpr i32 NONE = -1;

struct SElem {
  i64 id;       // element (insert op) id, packed
  i64 winner;   // current visible op id (pred target for deletes)
  i32 width;    // text width in the configured encoding unit
  i32 prev = NONE, next = NONE;
};

struct EOp {     // one emitted op, in id (emission) order
  i64 id;        // packed (ctr << 20 | rank)
  i64 elem_ref;  // insert: RGA reference element (0 = HEAD); delete: target
  i64 pred;      // delete: overwritten winner id; insert: 0
  i32 cp;        // insert: unicode codepoint; delete: -1
  i32 width;     // insert: width of this codepoint
  u8 is_del;
};

struct Session {
  std::vector<SElem> elems;  // slot-addressed; unlinked slots stay (ids live)
  std::vector<EOp> ops;
  i32 head = NONE, tail = NONE;
  i64 total_width = 0;
  i64 rank = 0;  // author's packed-id rank (doc actor index)
  // moving cursor: slot whose span starts at cur_at (NONE = unseeded)
  i32 cur = NONE;
  i64 cur_at = 0;
  // anchor index for random-position seeks (the session analogue of the
  // host store's block order-statistics index, core/op_store.py): every
  // kAnchorStride-th visible element with its span start, sorted by
  // position. Built lazily on the first far seek — sequential typing
  // (cursor always near) never pays for it — and maintained per splice:
  // anchors inside a deleted span drop, later anchors shift by the width
  // delta, and a rebuild re-amortizes after kAnchorRebuild mutations.
  std::vector<i32> anc_slot;
  std::vector<i64> anc_at;
  i64 anc_muts = 0;
  bool anc_dirty = true;
};

constexpr i64 kAnchorStride = 512;
constexpr i64 kAnchorRebuild = 4096;

void anc_rebuild(Session& s) {
  s.anc_slot.clear();
  s.anc_at.clear();
  i64 a = 0, count = 0;
  for (i32 slot = s.head; slot != NONE; slot = s.elems[slot].next) {
    if (count % kAnchorStride == 0) {
      s.anc_slot.push_back(slot);
      s.anc_at.push_back(a);
    }
    a += s.elems[slot].width;
    count++;
  }
  s.anc_muts = 0;
  s.anc_dirty = false;
}

// Splice bookkeeping: drop anchors inside the deleted span [pos, pos+del_w),
// shift anchors at or past the splice point by the width delta.
void anc_after_splice(Session& s, i64 pos, i64 del_w, i64 ins_w) {
  if (s.anc_dirty) return;
  if (++s.anc_muts > kAnchorRebuild) {
    s.anc_dirty = true;
    return;
  }
  size_t lo = (size_t)(std::lower_bound(s.anc_at.begin(), s.anc_at.end(), pos) -
                       s.anc_at.begin());
  size_t hi = (size_t)(std::lower_bound(s.anc_at.begin(), s.anc_at.end(),
                                        pos + del_w) -
                       s.anc_at.begin());
  if (hi > lo) {
    s.anc_slot.erase(s.anc_slot.begin() + lo, s.anc_slot.begin() + hi);
    s.anc_at.erase(s.anc_at.begin() + lo, s.anc_at.begin() + hi);
  }
  const i64 delta = ins_w - del_w;
  if (delta)
    for (size_t i = lo; i < s.anc_at.size(); i++) s.anc_at[i] += delta;
}

// Find the visible element covering width-position `pos`; returns slot (or
// NONE past the end) and writes its span start to *at. Walks from the
// cursor when near, else from an index anchor, else from the closer end.
i32 seek(Session& s, i64 pos, i64* at) {
  i32 slot;
  i64 a;
  i64 from_front = pos;
  i64 from_back = s.total_width - pos;
  i64 from_cur = s.cur == NONE ? from_front + 1 : (pos > s.cur_at ? pos - s.cur_at : s.cur_at - pos);
  i64 best = from_cur < from_front ? from_cur : from_front;
  if (from_back < best) best = from_back;
  if (best > 2 * kAnchorStride) {
    if (s.anc_dirty && s.elems.size() > (size_t)(4 * kAnchorStride))
      anc_rebuild(s);
    if (!s.anc_dirty && !s.anc_at.empty()) {
      size_t idx = (size_t)(std::upper_bound(s.anc_at.begin(), s.anc_at.end(),
                                             pos) -
                            s.anc_at.begin());
      if (idx > 0 && pos - s.anc_at[idx - 1] < best) {
        slot = s.anc_slot[idx - 1];
        a = s.anc_at[idx - 1];
        goto walk;
      }
    }
  }
  if (s.cur != NONE && from_cur <= from_front && from_cur <= from_back) {
    slot = s.cur;
    a = s.cur_at;
  } else if (from_front <= from_back) {
    slot = s.head;
    a = 0;
  } else {
    slot = s.tail;
    a = s.total_width - (s.tail == NONE ? 0 : s.elems[s.tail].width);
  }
walk:
  // walk backward while pos is before the span
  while (slot != NONE && pos < a) {
    slot = s.elems[slot].prev;
    if (slot != NONE) a -= s.elems[slot].width;
  }
  if (slot == NONE && pos >= 0 && s.head != NONE && pos < s.total_width) {
    slot = s.head;
    a = 0;
  }
  // walk forward while pos is past the span
  while (slot != NONE && pos >= a + s.elems[slot].width) {
    a += s.elems[slot].width;
    slot = s.elems[slot].next;
  }
  *at = a;
  return slot;
}

}  // namespace

extern "C" {

void* am_edit_create(i64 rank) {
  auto* s = new Session();
  s->rank = rank;
  return s;
}

void am_edit_destroy(void* p) { delete static_cast<Session*>(p); }

// Preload the object's visible elements in document order. Each carries
// its element id, current winner id, and width. Returns 0.
i64 am_edit_init(void* p, const i64* elem_ids, const i64* winner_ids,
                 const i32* widths, i64 n) {
  Session& s = *static_cast<Session*>(p);
  s.elems.reserve((size_t)n + 1024);
  i32 prev = NONE;
  for (i64 i = 0; i < n; i++) {
    SElem el;
    el.id = elem_ids[i];
    el.winner = winner_ids[i];
    el.width = widths[i];
    el.prev = prev;
    i32 slot = (i32)s.elems.size();
    s.elems.push_back(el);
    if (prev == NONE)
      s.head = slot;
    else
      s.elems[prev].next = slot;
    prev = slot;
    s.total_width += widths[i];
  }
  s.tail = prev;
  return 0;
}

i64 am_edit_length(void* p) { return static_cast<Session*>(p)->total_width; }

i64 am_edit_op_count(void* p) {
  return (i64)static_cast<Session*>(p)->ops.size();
}

namespace {
// one splice: returns ops emitted or a negative error (-1 pos OOB, -2
// delete past end)
i64 splice_impl(Session& s, i64 ctr0, i64 pos, i64 ndel, const i32* cps,
                const i32* widths, i64 ncp) {
  if (pos < 0 || pos > s.total_width) return -1;
  i64 ctr = ctr0;
  i64 emitted = 0;

  // mid-element rewind (reference inner_splice adjusted_index,
  // transaction/inner.rs:631-637): a delete starting inside a multi-width
  // element expands to cover it from its start
  i64 at;
  if (ndel > 0) {
    i32 t = seek(s, pos, &at);
    if (t != NONE && at < pos) {
      ndel += pos - at;
      pos = at;
    }
  }

  // anchor: visible element covering pos-1 (NONE = HEAD)
  i32 anchor = NONE;
  i64 anchor_at = 0;
  if (pos > 0) {
    anchor = seek(s, pos - 1, &anchor_at);
    if (anchor == NONE) return -1;
  }

  // deletes: walk forward from the anchor, unlink each element
  i64 remaining = ndel;
  i64 del_w = 0;
  i32 cur = anchor == NONE ? s.head : s.elems[anchor].next;
  while (remaining > 0) {
    if (cur == NONE) {
      // elements were already unlinked; the anchor index would otherwise
      // keep trusting their slots/positions for up to kAnchorRebuild muts
      s.anc_dirty = true;
      return -2;
    }
    SElem& el = s.elems[cur];
    EOp op;
    op.id = (ctr << 20) | s.rank;
    op.elem_ref = el.id;
    op.pred = el.winner;
    op.cp = -1;
    op.width = 0;
    op.is_del = 1;
    s.ops.push_back(op);
    ctr++;
    emitted++;
    remaining -= el.width;
    del_w += el.width;
    s.total_width -= el.width;
    i32 nxt = el.next;
    if (el.prev == NONE)
      s.head = nxt;
    else
      s.elems[el.prev].next = nxt;
    if (nxt == NONE)
      s.tail = el.prev;
    else
      s.elems[nxt].prev = el.prev;
    cur = nxt;
  }

  // inserts: chain after the anchor (ref = previous element id; no marks
  // in session objects, so the sticky-boundary scan reduces to the anchor)
  i32 prev = anchor;
  i64 ins_w = 0;
  i64 ref = anchor == NONE ? 0 : s.elems[anchor].id;
  for (i64 i = 0; i < ncp; i++) {
    i64 id = (ctr << 20) | s.rank;
    EOp op;
    op.id = id;
    op.elem_ref = ref;
    op.pred = 0;
    op.cp = cps[i];
    op.width = widths[i];
    op.is_del = 0;
    s.ops.push_back(op);
    ctr++;
    emitted++;
    SElem el;
    el.id = id;
    el.winner = id;
    el.width = widths[i];
    el.prev = prev;
    el.next = prev == NONE ? s.head : s.elems[prev].next;
    i32 slot = (i32)s.elems.size();
    s.elems.push_back(el);
    if (el.prev == NONE)
      s.head = slot;
    else
      s.elems[el.prev].next = slot;
    if (el.next == NONE)
      s.tail = slot;
    else
      s.elems[el.next].prev = slot;
    prev = slot;
    ref = id;
    ins_w += widths[i];
    s.total_width += widths[i];
  }
  anc_after_splice(s, pos, del_w, ins_w);

  // reseed the cursor at the anchor's (authoritative) span start — the
  // anchor is never deleted by this splice, so both are still valid
  if (anchor != NONE) {
    s.cur = anchor;
    s.cur_at = anchor_at;
  } else {
    s.cur = s.head;
    s.cur_at = 0;
  }
  return emitted;
}
}  // namespace

// Splice: delete `ndel` width units at `pos`, then insert `ncp` codepoints
// (with per-codepoint widths). Op ids are allocated from `ctr0` upward;
// returns the number of ops emitted, or a negative error:
//   -1 pos out of bounds   -2 delete past end
i64 am_edit_splice(void* p, i64 ctr0, i64 pos, i64 ndel, const i32* cps,
                   const i32* widths, i64 ncp) {
  return splice_impl(*static_cast<Session*>(p), ctr0, pos, ndel, cps, widths,
                     ncp);
}

// Bulk splice: `n_edits` edits, the i-th inserting
// cps[text_off[i] .. text_off[i+1]) at pos[i] after deleting ndel[i].
// With `clamp`, positions/deletes are clamped to the live length (the
// edit-trace replay convention). The whole loop runs native — this is
// the bulk-ingest path. Returns total ops emitted or a negative error.
i64 am_edit_splice_batch(void* p, i64 ctr0, const i64* pos, const i64* ndel,
                         const i64* text_off, const i32* cps,
                         const i32* widths, i64 n_edits, u8 clamp) {
  Session& s = *static_cast<Session*>(p);
  i64 total = 0;
  for (i64 i = 0; i < n_edits; i++) {
    i64 p_i = pos[i];
    i64 d_i = ndel[i];
    if (clamp) {
      if (p_i > s.total_width) p_i = s.total_width;
      if (d_i > s.total_width - p_i) d_i = s.total_width - p_i;
    }
    i64 r = splice_impl(s, ctr0 + total, p_i, d_i, cps + text_off[i],
                        widths + text_off[i], text_off[i + 1] - text_off[i]);
    if (r < 0) return r;
    total += r;
  }
  return total;
}

// Export emitted ops [start, count) in id order. Arrays must hold
// (op_count - start) rows. Returns rows written.
i64 am_edit_export(void* p, i64 start, i64* ids, i64* elem_refs, i64* preds,
                   i32* cps, i32* widths, u8* is_del) {
  Session& s = *static_cast<Session*>(p);
  if (start < 0 || (size_t)start > s.ops.size()) return -1;
  i64 w = 0;
  for (size_t i = (size_t)start; i < s.ops.size(); i++, w++) {
    const EOp& o = s.ops[i];
    ids[w] = o.id;
    elem_refs[w] = o.elem_ref;
    preds[w] = o.pred;
    cps[w] = o.cp;
    widths[w] = o.width;
    is_del[w] = o.is_del;
  }
  return w;
}

// Export the CURRENT visible element ids in document order (drain /
// debugging). Returns element count; caps at `cap`.
i64 am_edit_order(void* p, i64* out_ids, i64 cap) {
  Session& s = *static_cast<Session*>(p);
  i64 n = 0;
  for (i32 c = s.head; c != NONE; c = s.elems[c].next) {
    if (n < cap) out_ids[n] = s.elems[c].id;
    n++;
  }
  return n;
}

}  // extern "C"
