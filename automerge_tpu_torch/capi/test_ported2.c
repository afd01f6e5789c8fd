/* Second ported-scenario suite: the reference wasm/C scenarios not yet
 * covered by test_basic.c / test_sync.c, re-expressed against this
 * framework's am.h (behavioral ports of
 * rust/automerge-c/test/ported_wasm/basic_tests.c and sync_tests.c —
 * no code copied; scenario names cite the originals).
 *
 * Covers: the list insert/put/push/splice matrix, delete of
 * non-existent props, counters in sequences under concurrent puts,
 * mark expand policies + overlap + unmark + historical marks, cursor
 * stability under concurrent edits and deletion, deep historical
 * reads, recursive subtree deletion, out-of-order change application
 * (causal queue + missing deps), and the sync scenarios: equal heads,
 * either initiator, simultaneous crossing messages, no-resend
 * backpressure, non-empty state after sync, data loss with and
 * without disconnecting, concurrent-to-last-sync heads, and
 * branching/merging storms.
 */
#include <stdio.h>
#include <string.h>

#include "am.h"
#include "test_util.h"

static uint8_t msg[1 << 20];
static uint8_t blob[1 << 20];
static char sbuf[4096];

/* -- helpers ---------------------------------------------------------------- */

static int sync_rounds(AMdoc *a, AMdoc *b, AMsyncState *sa, AMsyncState *sb) {
  for (int round = 0; round < 64; round++) {
    AMresult *ma = am_generate_sync_message(a, sa);
    AMresult *mb = am_generate_sync_message(b, sb);
    if (!res_ok(ma) || !res_ok(mb)) {
      am_result_free(ma);
      am_result_free(mb);
      return -1;
    }
    int quiet = am_result_size(ma) == 0 && am_result_size(mb) == 0;
    if (am_result_size(ma) > 0) {
      size_t len = 0;
      const uint8_t *p = am_item_bytes(ma, 0, &len);
      memcpy(msg, p, len);
      AMresult *r = am_receive_sync_message(b, sb, msg, len);
      if (!res_ok(r)) quiet = -1;
      am_result_free(r);
    }
    if (am_result_size(mb) > 0) {
      size_t len = 0;
      const uint8_t *p = am_item_bytes(mb, 0, &len);
      memcpy(msg, p, len);
      AMresult *r = am_receive_sync_message(a, sa, msg, len);
      if (!res_ok(r)) quiet = -1;
      am_result_free(r);
    }
    am_result_free(ma);
    am_result_free(mb);
    if (quiet == 1) return round;
    if (quiet < 0) return -1;
  }
  return -1;
}

static int docs_equal_heads(AMdoc *a, AMdoc *b) {
  static uint8_t ha[32 * 64], hb[32 * 64];
  size_t na = res_heads(am_get_heads(a), ha, 64);
  size_t nb = res_heads(am_get_heads(b), hb, 64);
  return na == nb && memcmp(ha, hb, 32 * na) == 0;
}

static void obj_of(AMresult *r, char *out, size_t cap) {
  out[0] = '\0';
  if (res_ok(r) && am_result_size(r) > 0) {
    strncpy(out, am_item_str(r, 0), cap - 1);
    out[cap - 1] = '\0';
  }
  am_result_free(r);
}

/* -- lists have insert, put, push and splice ops ---------------------------- */
/* (reference basic_tests.c test_lists_have_insert_set_splice_and_push_ops) */
static void test_list_op_matrix(void) {
  AMdoc *d = am_create(NULL, 0);
  char l[128];
  obj_of(am_map_put_object(d, AM_ROOT, "l", AM_OBJ_LIST), l, sizeof l);
  CHECK(l[0] != '\0');

  /* push == insert at length */
  CHECK_OK(am_list_insert_int(d, l, 0, 1));
  CHECK_OK(am_list_insert_int(d, l, 1, 2));
  CHECK_OK(am_list_insert_int(d, l, 2, 3));
  CHECK(res_int(am_length(d, l)) == 3);

  /* put overwrites in place (no length change) */
  CHECK_OK(am_list_put_str(d, l, 1, "two"));
  CHECK(res_int(am_length(d, l)) == 3);
  AMresult *r = am_list_get(d, l, 1);
  CHECK(am_item_type(r, 0) == AM_VAL_STR);
  CHECK(strcmp(am_item_str(r, 0), "two") == 0);
  am_result_free(r);

  /* insert in the middle shifts the tail */
  CHECK_OK(am_list_insert_f64(d, l, 1, 2.5));
  CHECK(res_int(am_length(d, l)) == 4);
  CHECK(res_f64(am_list_get(d, l, 1)) == 2.5);
  r = am_list_get(d, l, 2);
  CHECK(strcmp(am_item_str(r, 0), "two") == 0);
  am_result_free(r);

  /* every scalar type survives a put + read back */
  CHECK_OK(am_list_put_null(d, l, 0));
  r = am_list_get(d, l, 0);
  CHECK(am_item_type(r, 0) == AM_VAL_NULL);
  am_result_free(r);
  CHECK_OK(am_list_put_bool(d, l, 0, 1));
  CHECK(res_int(am_list_get(d, l, 0)) == 1);
  CHECK_OK(am_list_put_uint(d, l, 0, 77));
  r = am_list_get(d, l, 0);
  CHECK(am_item_type(r, 0) == AM_VAL_UINT && am_item_int(r, 0) == 77);
  am_result_free(r);
  CHECK_OK(am_list_put_timestamp(d, l, 0, 1700000000));
  r = am_list_get(d, l, 0);
  CHECK(am_item_type(r, 0) == AM_VAL_TIMESTAMP);
  CHECK(am_item_int(r, 0) == 1700000000);
  am_result_free(r);
  uint8_t raw[3] = {9, 8, 7};
  CHECK_OK(am_list_put_bytes(d, l, 0, raw, 3));
  r = am_list_get(d, l, 0);
  size_t bl = 0;
  const uint8_t *bp = am_item_bytes(r, 0, &bl);
  CHECK(bl == 3 && bp[0] == 9 && bp[2] == 7);
  am_result_free(r);

  /* splice-delete removes a run */
  CHECK_OK(am_list_splice(d, l, 1, 2));
  CHECK(res_int(am_length(d, l)) == 2);

  /* nested object put returns its id and reads back as OBJ_ID */
  char sub[128];
  obj_of(am_list_put_object(d, l, 0, AM_OBJ_MAP), sub, sizeof sub);
  CHECK(sub[0] != '\0');
  CHECK_OK(am_map_put_int(d, sub, "deep", 42));
  r = am_list_get(d, l, 0);
  CHECK(am_item_type(r, 0) == AM_VAL_OBJ_ID);
  am_result_free(r);
  CHECK(res_int(am_map_get(d, sub, "deep")) == 42);

  /* list_items walks visible values in order */
  r = am_list_items(d, l);
  CHECK(am_result_size(r) == 2);
  CHECK(am_item_type(r, 0) == AM_VAL_OBJ_ID);
  am_result_free(r);

  /* list_range subranges */
  CHECK_OK(am_list_insert_int(d, l, 2, 10));
  CHECK_OK(am_list_insert_int(d, l, 3, 11));
  r = am_list_range(d, l, 1, 3);
  CHECK(am_result_size(r) == 2);
  am_result_free(r);
  am_doc_free(d);
}

/* -- deleting non-existent props is a no-op --------------------------------- */
/* (reference basic_tests.c test_should_be_able_to_delete_non_existent_props) */
static void test_delete_nonexistent_props(void) {
  AMdoc *d = am_create(NULL, 0);
  CHECK_OK(am_map_put_str(d, AM_ROOT, "foo", "bar"));
  CHECK_OK(am_map_put_str(d, AM_ROOT, "bip", "bap"));
  uint8_t h1[32 * 4];
  CHECK_OK(am_commit(d, NULL));
  size_t n1 = res_heads(am_get_heads(d), h1, 4);
  CHECK(n1 == 1);

  AMresult *keys = am_keys(d, AM_ROOT);
  CHECK(am_result_size(keys) == 2);
  CHECK(strcmp(am_item_str(keys, 0), "bip") == 0);
  CHECK(strcmp(am_item_str(keys, 1), "foo") == 0);
  am_result_free(keys);

  CHECK_OK(am_map_delete(d, AM_ROOT, "foo"));
  CHECK_OK(am_map_delete(d, AM_ROOT, "baz")); /* non-existent: no-op */
  CHECK_OK(am_commit(d, NULL));

  keys = am_keys(d, AM_ROOT);
  CHECK(am_result_size(keys) == 1);
  CHECK(strcmp(am_item_str(keys, 0), "bip") == 0);
  am_result_free(keys);

  /* the historical view still shows both */
  keys = am_keys_at(d, AM_ROOT, h1, n1);
  CHECK(am_result_size(keys) == 2);
  am_result_free(keys);
  am_doc_free(d);
}

/* -- counters in a sequence under concurrent puts ---------------------------- */
/* (reference test_local_inc_increments_all_visible_counters_in_a_sequence) */
static void test_counters_in_sequence(void) {
  uint8_t a1[1] = {1}, a2[1] = {2};
  AMdoc *d1 = am_create(a1, 1);
  char l[128];
  obj_of(am_map_put_object(d1, AM_ROOT, "l", AM_OBJ_LIST), l, sizeof l);
  CHECK_OK(am_list_insert_str(d1, l, 0, "seed"));
  CHECK_OK(am_commit(d1, NULL));

  AMdoc *d2 = am_fork(d1, a2, 1);
  /* concurrent: both replace index 0 with a counter */
  CHECK_OK(am_list_put_counter(d1, l, 0, 10));
  CHECK_OK(am_commit(d1, NULL));
  CHECK_OK(am_list_put_counter(d2, l, 0, 100));
  CHECK_OK(am_commit(d2, NULL));
  CHECK_OK(am_merge(d1, d2));

  /* one increment bumps EVERY visible (conflicting) counter */
  CHECK_OK(am_list_increment(d1, l, 0, 5));
  CHECK_OK(am_commit(d1, NULL));
  AMresult *all = am_map_get_all(d1, l, "0"); /* not a map: expect error */
  am_result_free(all);
  /* winner value reflects its own increment */
  AMresult *r = am_list_get(d1, l, 0);
  CHECK(am_item_type(r, 0) == AM_VAL_COUNTER);
  int64_t winner = am_item_int(r, 0);
  CHECK(winner == 15 || winner == 105);
  am_result_free(r);

  /* merge back into d2 and increment there too: totals stay coherent */
  CHECK_OK(am_merge(d2, d1));
  r = am_list_get(d2, l, 0);
  CHECK(am_item_type(r, 0) == AM_VAL_COUNTER);
  CHECK(am_item_int(r, 0) == winner);
  am_result_free(r);
  am_doc_free(d1);
  am_doc_free(d2);
}

/* -- mark expand policies, overlap, unmark, historical marks ----------------- */
static void test_marks_depth(void) {
  AMdoc *d = am_create(NULL, 0);
  char t[128];
  obj_of(am_map_put_object(d, AM_ROOT, "t", AM_OBJ_TEXT), t, sizeof t);
  CHECK_OK(am_splice_text(d, t, 0, 0, "hello world"));
  CHECK_OK(am_commit(d, NULL));
  uint8_t h1[32 * 4];
  size_t n1 = res_heads(am_get_heads(d), h1, 4);

  /* overlapping marks of different names coexist */
  CHECK_OK(am_mark_bool(d, t, 0, 5, "bold", 1, "none"));
  CHECK_OK(am_mark_str(d, t, 3, 8, "comment", "hi", "none"));
  CHECK_OK(am_commit(d, NULL));
  AMresult *m = am_marks(d, t);
  CHECK(am_result_size(m) == 8); /* 2 marks x 4 items */
  am_result_free(m);

  /* unmark a subrange splits the span */
  CHECK_OK(am_unmark(d, t, 1, 3, "bold"));
  CHECK_OK(am_commit(d, NULL));
  m = am_marks(d, t);
  /* bold [0,1) + bold [3,5) + comment [3,8) = 3 spans */
  CHECK(am_result_size(m) == 12);
  am_result_free(m);

  /* historical view: before any marks there were none */
  m = am_marks_at(d, t, h1, n1);
  CHECK(am_result_size(m) == 0);
  am_result_free(m);

  /* expand policies: after/both grow over an insertion at the end edge */
  char t2[128];
  obj_of(am_map_put_object(d, AM_ROOT, "t2", AM_OBJ_TEXT), t2, sizeof t2);
  CHECK_OK(am_splice_text(d, t2, 0, 0, "abcd"));
  CHECK_OK(am_mark_bool(d, t2, 1, 3, "grow", 1, "both"));
  CHECK_OK(am_mark_bool(d, t2, 1, 3, "stay", 1, "none"));
  CHECK_OK(am_commit(d, NULL));
  CHECK_OK(am_splice_text(d, t2, 3, 0, "XY")); /* insert at the end edge */
  CHECK_OK(am_commit(d, NULL));
  m = am_marks(d, t2);
  int found_grow = 0, found_stay = 0;
  for (size_t i = 0; i + 3 < am_result_size(m); i += 4) {
    const char *name = am_item_str(m, i + 2);
    int64_t start = am_item_int(m, i), end = am_item_int(m, i + 1);
    if (name && strcmp(name, "grow") == 0) {
      found_grow = 1;
      CHECK(start == 1 && end == 5); /* swallowed the insertion */
    }
    if (name && strcmp(name, "stay") == 0) {
      found_stay = 1;
      CHECK(start == 1 && end == 3); /* did not */
    }
  }
  CHECK(found_grow && found_stay);
  am_result_free(m);

  /* marks survive save/load */
  size_t sl = res_bytes(am_save(d), blob, sizeof blob);
  AMdoc *d2 = am_load(blob, sl);
  CHECK(d2 != NULL);
  m = am_marks(d2, t2);
  CHECK(am_result_size(m) >= 8);
  am_result_free(m);
  am_doc_free(d2);
  am_doc_free(d);
}

/* -- cursors track elements through concurrent edits and deletion ------------ */
static void test_cursor_stability(void) {
  uint8_t a1[1] = {1}, a2[1] = {2};
  AMdoc *d1 = am_create(a1, 1);
  char t[128];
  obj_of(am_map_put_object(d1, AM_ROOT, "t", AM_OBJ_TEXT), t, sizeof t);
  CHECK_OK(am_splice_text(d1, t, 0, 0, "abcdef"));
  CHECK_OK(am_commit(d1, NULL));
  char cur[160];
  res_str(am_get_cursor(d1, t, 3), cur, sizeof cur); /* element 'd' */
  CHECK(cur[0] != '\0');

  /* concurrent edits on a fork move the cursor's element */
  AMdoc *d2 = am_fork(d1, a2, 1);
  CHECK_OK(am_splice_text(d2, t, 0, 0, "..."));
  CHECK_OK(am_commit(d2, NULL));
  CHECK_OK(am_splice_text(d1, t, 5, 1, "F"));
  CHECK_OK(am_commit(d1, NULL));
  CHECK_OK(am_merge(d1, d2));
  CHECK(res_int(am_get_cursor_position(d1, t, cur)) == 6);

  /* cursor survives in the fork that never saw the original doc object */
  CHECK_OK(am_merge(d2, d1));
  CHECK(res_int(am_get_cursor_position(d2, t, cur)) == 6);

  /* deleting the element: position degrades to the nearest survivor */
  CHECK_OK(am_splice_text(d1, t, 6, 1, ""));
  CHECK_OK(am_commit(d1, NULL));
  int64_t pos = res_int(am_get_cursor_position(d1, t, cur));
  CHECK(pos >= 0 && pos <= (int64_t)6);
  am_doc_free(d1);
  am_doc_free(d2);
}

/* -- recursive subtree deletion + re-put ------------------------------------- */
static void test_recursive_delete_and_reput(void) {
  AMdoc *d = am_create(NULL, 0);
  char outer[128], inner[128], list[128];
  obj_of(am_map_put_object(d, AM_ROOT, "cfg", AM_OBJ_MAP), outer, sizeof outer);
  obj_of(am_map_put_object(d, outer, "nested", AM_OBJ_MAP), inner, sizeof inner);
  obj_of(am_map_put_object(d, inner, "items", AM_OBJ_LIST), list, sizeof list);
  CHECK_OK(am_list_insert_int(d, list, 0, 1));
  CHECK_OK(am_commit(d, NULL));
  uint8_t h1[32 * 4];
  size_t n1 = res_heads(am_get_heads(d), h1, 4);

  /* delete the whole subtree at its root */
  CHECK_OK(am_map_delete(d, AM_ROOT, "cfg"));
  CHECK_OK(am_commit(d, NULL));
  AMresult *r = am_map_get(d, AM_ROOT, "cfg");
  CHECK(am_result_size(r) == 0);
  am_result_free(r);

  /* re-put the same key: a FRESH object, not the old one */
  char outer2[128];
  obj_of(am_map_put_object(d, AM_ROOT, "cfg", AM_OBJ_MAP), outer2, sizeof outer2);
  CHECK(strcmp(outer, outer2) != 0);
  CHECK_OK(am_map_put_int(d, outer2, "v", 2));
  CHECK_OK(am_commit(d, NULL));
  CHECK(res_int(am_map_get(d, outer2, "v")) == 2);

  /* the old subtree is still reachable at the old heads */
  r = am_map_get_at(d, AM_ROOT, "cfg", h1, n1);
  CHECK(am_result_size(r) == 1 && am_item_type(r, 0) == AM_VAL_OBJ_ID);
  am_result_free(r);
  CHECK(res_int(am_length_at(d, list, h1, n1)) == 1);
  am_doc_free(d);
}

/* -- out-of-order change application: causal queue + missing deps ------------ */
static void test_out_of_order_changes(void) {
  uint8_t a1[1] = {1}, a2[1] = {2};
  AMdoc *src = am_create(a1, 1);
  CHECK_OK(am_map_put_int(src, AM_ROOT, "x", 1));
  CHECK_OK(am_commit(src, NULL));
  uint8_t h1[32 * 4];
  size_t n1 = res_heads(am_get_heads(src), h1, 4);
  size_t c1 = res_bytes(am_save_incremental(src, NULL, 0), blob, sizeof blob);
  CHECK(c1 > 0);

  CHECK_OK(am_map_put_int(src, AM_ROOT, "x", 2));
  CHECK_OK(am_commit(src, NULL));
  static uint8_t c2buf[1 << 16];
  size_t c2 = res_bytes(am_save_incremental(src, h1, n1), c2buf, sizeof c2buf);
  CHECK(c2 > 0);

  /* apply the SECOND change first: doc must queue it and report the
   * missing dependency, showing nothing until the gap fills */
  AMdoc *dst = am_create(a2, 1);
  CHECK_OK(am_apply_changes(dst, c2buf, c2));
  AMresult *r = am_map_get(dst, AM_ROOT, "x");
  CHECK(am_result_size(r) == 0);
  am_result_free(r);
  r = am_get_missing_deps(dst, NULL, 0);
  CHECK(am_result_size(r) == 1);
  am_result_free(r);

  CHECK_OK(am_apply_changes(dst, blob, c1));
  CHECK(res_int(am_map_get(dst, AM_ROOT, "x")) == 2);
  r = am_get_missing_deps(dst, NULL, 0);
  CHECK(am_result_size(r) == 0);
  am_result_free(r);
  CHECK(docs_equal_heads(src, dst));
  am_doc_free(src);
  am_doc_free(dst);
}

/* ======================= sync scenarios ==================================== */

/* (reference sync_tests.c test_repos_with_equal_heads_do_not_need_a_reply) */
static void test_sync_equal_heads_quick_quiet(void) {
  uint8_t a1[1] = {1}, a2[1] = {2};
  AMdoc *d1 = am_create(a1, 1);
  char l[128];
  obj_of(am_map_put_object(d1, AM_ROOT, "n", AM_OBJ_LIST), l, sizeof l);
  for (int i = 0; i < 10; i++) {
    CHECK_OK(am_list_insert_int(d1, l, (size_t)i, i));
    CHECK_OK(am_commit(d1, NULL));
  }
  size_t sl = res_bytes(am_save(d1), blob, sizeof blob);
  AMdoc *d2 = am_load(blob, sl);
  CHECK(d2 && docs_equal_heads(d1, d2));

  /* both already share everything: one round trip goes quiet */
  AMsyncState *s1 = am_sync_state_new(), *s2 = am_sync_state_new();
  int rounds = sync_rounds(d1, d2, s1, s2);
  CHECK(rounds >= 0 && rounds <= 2);
  CHECK(docs_equal_heads(d1, d2));
  am_sync_state_free(s1);
  am_sync_state_free(s2);
  am_doc_free(d1);
  am_doc_free(d2);
}

/* (reference test_should_work_regardless_of_who_initiates_the_exchange) */
static void test_sync_either_initiator(void) {
  for (int initiator = 0; initiator < 2; initiator++) {
    uint8_t a1[1] = {1}, a2[1] = {2};
    AMdoc *d1 = am_create(a1, 1), *d2 = am_create(a2, 1);
    char l[128];
    obj_of(am_map_put_object(d1, AM_ROOT, "n", AM_OBJ_LIST), l, sizeof l);
    for (int i = 0; i < 5; i++) {
      CHECK_OK(am_list_insert_int(d1, l, (size_t)i, i));
      CHECK_OK(am_commit(d1, NULL));
    }
    AMsyncState *s1 = am_sync_state_new(), *s2 = am_sync_state_new();
    int rounds = initiator == 0 ? sync_rounds(d1, d2, s1, s2)
                                : sync_rounds(d2, d1, s2, s1);
    CHECK(rounds >= 0);
    CHECK(docs_equal_heads(d1, d2));
    CHECK(res_int(am_length(d2, l)) == 5);
    am_sync_state_free(s1);
    am_sync_state_free(s2);
    am_doc_free(d1);
    am_doc_free(d2);
  }
}

/* (reference test_should_allow_simultaneous_messages_during_synchronization)
 * Both peers keep generating before receiving — messages cross in flight
 * every round — and the protocol still converges. */
static void test_sync_simultaneous_messages(void) {
  uint8_t a1[1] = {1}, a2[1] = {2};
  AMdoc *d1 = am_create(a1, 1), *d2 = am_create(a2, 1);
  char l1[128], l2[128];
  obj_of(am_map_put_object(d1, AM_ROOT, "a", AM_OBJ_LIST), l1, sizeof l1);
  obj_of(am_map_put_object(d2, AM_ROOT, "b", AM_OBJ_LIST), l2, sizeof l2);
  for (int i = 0; i < 8; i++) {
    CHECK_OK(am_list_insert_int(d1, l1, (size_t)i, i));
    CHECK_OK(am_commit(d1, NULL));
    CHECK_OK(am_list_insert_int(d2, l2, (size_t)i, 100 + i));
    CHECK_OK(am_commit(d2, NULL));
  }
  AMsyncState *s1 = am_sync_state_new(), *s2 = am_sync_state_new();
  static uint8_t m1[1 << 18], m2[1 << 18];
  int converged = 0;
  for (int round = 0; round < 64 && !converged; round++) {
    /* generate BOTH first (simultaneous), then deliver both */
    AMresult *r1 = am_generate_sync_message(d1, s1);
    AMresult *r2 = am_generate_sync_message(d2, s2);
    size_t n1 = 0, n2 = 0;
    if (am_result_size(r1)) {
      const uint8_t *p = am_item_bytes(r1, 0, &n1);
      memcpy(m1, p, n1);
    }
    if (am_result_size(r2)) {
      const uint8_t *p = am_item_bytes(r2, 0, &n2);
      memcpy(m2, p, n2);
    }
    converged = n1 == 0 && n2 == 0;
    am_result_free(r1);
    am_result_free(r2);
    if (n1) CHECK_OK(am_receive_sync_message(d2, s2, m1, n1));
    if (n2) CHECK_OK(am_receive_sync_message(d1, s1, m2, n2));
  }
  CHECK(converged);
  CHECK(docs_equal_heads(d1, d2));
  CHECK(res_int(am_length(d1, l2)) == 8);
  CHECK(res_int(am_length(d2, l1)) == 8);
  am_sync_state_free(s1);
  am_sync_state_free(s2);
  am_doc_free(d1);
  am_doc_free(d2);
}

/* (reference test_should_assume_sent_changes_were_received...) — a peer
 * must not re-send the same changes while they are in flight. */
static void test_sync_no_resend_in_flight(void) {
  uint8_t a1[1] = {1}, a2[1] = {2};
  AMdoc *d1 = am_create(a1, 1), *d2 = am_create(a2, 1);
  char l[128];
  obj_of(am_map_put_object(d1, AM_ROOT, "n", AM_OBJ_LIST), l, sizeof l);
  CHECK_OK(am_commit(d1, NULL));
  /* establish the session so d1 knows d2's wants */
  AMsyncState *s1 = am_sync_state_new(), *s2 = am_sync_state_new();
  CHECK(sync_rounds(d1, d2, s1, s2) >= 0);

  for (int i = 0; i < 20; i++) {
    CHECK_OK(am_list_insert_int(d1, l, (size_t)i, i));
    CHECK_OK(am_commit(d1, NULL));
  }
  /* first message carries the 20 new changes */
  AMresult *r = am_generate_sync_message(d1, s1);
  CHECK(am_result_size(r) == 1);
  size_t first = 0;
  am_item_bytes(r, 0, &first);
  am_result_free(r);
  /* generating AGAIN without hearing back must not re-carry them */
  r = am_generate_sync_message(d1, s1);
  size_t second = 0;
  if (am_result_size(r)) am_item_bytes(r, 0, &second);
  am_result_free(r);
  CHECK(second < first / 2);
  am_sync_state_free(s1);
  am_sync_state_free(s2);
  am_doc_free(d1);
  am_doc_free(d2);
}

/* (reference test_should_ensure_non_empty_state_after_sync) */
static void test_sync_non_empty_state(void) {
  uint8_t a1[1] = {1}, a2[1] = {2};
  AMdoc *d1 = am_create(a1, 1), *d2 = am_create(a2, 1);
  CHECK_OK(am_map_put_int(d1, AM_ROOT, "x", 1));
  CHECK_OK(am_commit(d1, NULL));
  AMsyncState *s1 = am_sync_state_new(), *s2 = am_sync_state_new();
  CHECK(sync_rounds(d1, d2, s1, s2) >= 0);
  AMresult *r = am_sync_state_shared_heads(s1);
  CHECK(am_result_size(r) == 1);
  am_result_free(r);
  r = am_sync_state_shared_heads(s2);
  CHECK(am_result_size(r) == 1);
  am_result_free(r);
  am_sync_state_free(s1);
  am_sync_state_free(s2);
  am_doc_free(d1);
  am_doc_free(d2);
}

/* (reference test_should_resync_after_one_node_experiences_data_loss_
 * without_disconnecting) — the lossy peer RESTARTS from an old save but
 * the healthy peer keeps its session state. */
static void test_sync_data_loss_without_disconnect(void) {
  uint8_t a1[1] = {1}, a2[1] = {2};
  AMdoc *d1 = am_create(a1, 1), *d2 = am_create(a2, 1);
  char l[128];
  obj_of(am_map_put_object(d1, AM_ROOT, "n", AM_OBJ_LIST), l, sizeof l);
  CHECK_OK(am_commit(d1, NULL));
  AMsyncState *s1 = am_sync_state_new(), *s2 = am_sync_state_new();
  CHECK(sync_rounds(d1, d2, s1, s2) >= 0);
  size_t old_len = res_bytes(am_save(d2), blob, sizeof blob);

  for (int i = 0; i < 6; i++) {
    CHECK_OK(am_list_insert_int(d1, l, (size_t)i, i));
    CHECK_OK(am_commit(d1, NULL));
  }
  CHECK(sync_rounds(d1, d2, s1, s2) >= 0);
  CHECK(docs_equal_heads(d1, d2));

  /* d2 crashes and reloads the stale save; ITS state is fresh but d1
   * still believes the old session */
  am_doc_free(d2);
  d2 = am_load(blob, old_len);
  CHECK(d2 != NULL);
  AMsyncState *s2b = am_sync_state_new();
  CHECK(sync_rounds(d1, d2, s1, s2b) >= 0);
  CHECK(docs_equal_heads(d1, d2));
  CHECK(res_int(am_length(d2, l)) == 6);
  am_sync_state_free(s1);
  am_sync_state_free(s2);
  am_sync_state_free(s2b);
  am_doc_free(d1);
  am_doc_free(d2);
}

/* (reference test_should_handle_changes_concurrent_to_the_last_sync_heads) */
static void test_sync_concurrent_to_last_heads(void) {
  uint8_t a1[1] = {1}, a2[1] = {2};
  AMdoc *d1 = am_create(a1, 1), *d2 = am_create(a2, 1);
  CHECK_OK(am_map_put_int(d1, AM_ROOT, "seed", 0));
  CHECK_OK(am_commit(d1, NULL));
  AMsyncState *s1 = am_sync_state_new(), *s2 = am_sync_state_new();
  CHECK(sync_rounds(d1, d2, s1, s2) >= 0);

  /* both edit concurrently AFTER the session established */
  CHECK_OK(am_map_put_int(d1, AM_ROOT, "from1", 1));
  CHECK_OK(am_commit(d1, NULL));
  CHECK_OK(am_map_put_int(d2, AM_ROOT, "from2", 2));
  CHECK_OK(am_commit(d2, NULL));
  CHECK(sync_rounds(d1, d2, s1, s2) >= 0);
  CHECK(docs_equal_heads(d1, d2));
  CHECK(res_int(am_map_get(d1, AM_ROOT, "from2")) == 2);
  CHECK(res_int(am_map_get(d2, AM_ROOT, "from1")) == 1);

  /* and again: a second wave reusing the same states */
  CHECK_OK(am_map_put_int(d1, AM_ROOT, "w2a", 3));
  CHECK_OK(am_commit(d1, NULL));
  CHECK_OK(am_map_put_int(d2, AM_ROOT, "w2b", 4));
  CHECK_OK(am_commit(d2, NULL));
  CHECK(sync_rounds(d1, d2, s1, s2) >= 0);
  CHECK(docs_equal_heads(d1, d2));
  am_sync_state_free(s1);
  am_sync_state_free(s2);
  am_doc_free(d1);
  am_doc_free(d2);
}

/* (reference test_should_handle_histories_with_lots_of_branching_and_merging) */
static void test_sync_branching_merging_storm(void) {
  uint8_t a1[1] = {1}, a2[1] = {2}, a3[1] = {3};
  AMdoc *d1 = am_create(a1, 1);
  CHECK_OK(am_map_put_int(d1, AM_ROOT, "seed", 0));
  CHECK_OK(am_commit(d1, NULL));
  size_t sl = res_bytes(am_save(d1), blob, sizeof blob);
  AMdoc *d2 = am_load(blob, sl);
  AMdoc *d3 = am_load(blob, sl);
  CHECK(d2 && d3);
  CHECK_OK(am_set_actor_id(d2, a2, 1));
  CHECK_OK(am_set_actor_id(d3, a3, 1));

  /* rounds of independent edits + partial merges build a wide DAG */
  for (int i = 0; i < 6; i++) {
    char key[16];
    snprintf(key, sizeof key, "k1_%d", i);
    CHECK_OK(am_map_put_int(d1, AM_ROOT, key, i));
    CHECK_OK(am_commit(d1, NULL));
    snprintf(key, sizeof key, "k2_%d", i);
    CHECK_OK(am_map_put_int(d2, AM_ROOT, key, i));
    CHECK_OK(am_commit(d2, NULL));
    snprintf(key, sizeof key, "k3_%d", i);
    CHECK_OK(am_map_put_int(d3, AM_ROOT, key, i));
    CHECK_OK(am_commit(d3, NULL));
    if (i % 2 == 0) {
      CHECK_OK(am_merge(d1, d2));
      CHECK_OK(am_merge(d2, d3));
    } else {
      CHECK_OK(am_merge(d3, d1));
    }
  }
  /* pairwise sync all three to a single converged state */
  AMsyncState *s12 = am_sync_state_new(), *s21 = am_sync_state_new();
  AMsyncState *s13 = am_sync_state_new(), *s31 = am_sync_state_new();
  CHECK(sync_rounds(d1, d2, s12, s21) >= 0);
  CHECK(sync_rounds(d1, d3, s13, s31) >= 0);
  CHECK(sync_rounds(d1, d2, s12, s21) >= 0);
  CHECK(docs_equal_heads(d1, d2));
  CHECK(docs_equal_heads(d1, d3));
  /* every branch's keys are visible everywhere */
  AMresult *keys = am_keys(d3, AM_ROOT);
  CHECK(am_result_size(keys) == 1 + 18);
  am_result_free(keys);
  am_sync_state_free(s12);
  am_sync_state_free(s21);
  am_sync_state_free(s13);
  am_sync_state_free(s31);
  am_doc_free(d1);
  am_doc_free(d2);
  am_doc_free(d3);
}

/* -- map_range / keys_at interplay across history ---------------------------- */
static void test_map_range_and_history(void) {
  AMdoc *d = am_create(NULL, 0);
  const char *names[] = {"alpha", "beta", "gamma", "delta", "epsilon"};
  for (int i = 0; i < 5; i++) {
    CHECK_OK(am_map_put_int(d, AM_ROOT, names[i], i));
  }
  CHECK_OK(am_commit(d, NULL));
  /* [beta, delta) in key order: beta, gamma — wait: order is lexicographic:
   * alpha beta delta epsilon gamma; [beta, delta) = beta only */
  AMresult *r = am_map_range(d, AM_ROOT, "beta", "delta");
  CHECK(am_result_size(r) == 2); /* 1 entry = key + value */
  CHECK(strcmp(am_item_str(r, 0), "beta") == 0);
  am_result_free(r);
  r = am_map_range(d, AM_ROOT, "b", "");
  CHECK(am_result_size(r) == 8); /* beta delta epsilon gamma */
  am_result_free(r);
  am_doc_free(d);
}

int main(void) {
  if (am_init() != 0) {
    fprintf(stderr, "am_init failed\n");
    return 1;
  }
  test_list_op_matrix();
  test_delete_nonexistent_props();
  test_counters_in_sequence();
  test_marks_depth();
  test_cursor_stability();
  test_recursive_delete_and_reput();
  test_out_of_order_changes();
  test_sync_equal_heads_quick_quiet();
  test_sync_either_initiator();
  test_sync_simultaneous_messages();
  test_sync_no_resend_in_flight();
  test_sync_non_empty_state();
  test_sync_data_loss_without_disconnect();
  test_sync_concurrent_to_last_heads();
  test_sync_branching_merging_storm();
  test_map_range_and_history();
  am_shutdown();
  return am_test_finish("test_ported2");
}
