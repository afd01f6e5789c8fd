/* Sync-suite scenarios ported from the reference's wasm/C sync tests
 * (behavioral port of rust/automerge-c/test/ported_wasm/sync_tests.c,
 * re-expressed against this framework's am.h; no code copied) plus the
 * round-3 sync-state encode/decode surface.
 */
#include <stdio.h>
#include <string.h>

#include "am.h"
#include "test_util.h"

static uint8_t msg[1 << 20];
static uint8_t buf[1 << 20];
static char sbuf[1024];

/* run the full sync loop between two docs; returns rounds (-1 = no
 * convergence within the budget) */
static int sync_loop(AMdoc *a, AMdoc *b, AMsyncState *sa, AMsyncState *sb) {
  for (int round = 0; round < 40; round++) {
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

static int heads_equal(AMdoc *a, AMdoc *b) {
  static uint8_t ha[32 * 64], hb[32 * 64];
  size_t na = res_heads(am_get_heads(a), ha, 64);
  size_t nb = res_heads(am_get_heads(b), hb, 64);
  return na == nb && memcmp(ha, hb, 32 * na) == 0;
}

/* -- an empty local doc still announces itself ----------------------------- */
static void test_empty_doc_sends_message(void) {
  AMdoc *a = am_create(NULL, 0);
  AMsyncState *s = am_sync_state_new();
  AMresult *m = am_generate_sync_message(a, s);
  CHECK(res_ok(m) && am_result_size(m) == 1); /* heads+need+have, no changes */
  am_result_free(m);
  am_sync_state_free(s);
  am_doc_free(a);
}

/* -- two empty docs converge to silence ------------------------------------- */
static void test_empty_docs_converge(void) {
  AMdoc *a = am_create(NULL, 0);
  AMdoc *b = am_create(NULL, 0);
  AMsyncState *sa = am_sync_state_new(), *sb = am_sync_state_new();
  CHECK(sync_loop(a, b, sa, sb) >= 0);
  CHECK(heads_equal(a, b));
  am_sync_state_free(sa);
  am_sync_state_free(sb);
  am_doc_free(b);
  am_doc_free(a);
}

/* -- n1 offers everything to an empty n2 ------------------------------------ */
static void test_offer_all_changes_from_nothing(void) {
  uint8_t a1[1] = {1};
  AMdoc *a = am_create(a1, 1);
  AMresult *r = am_map_put_object(a, AM_ROOT, "l", AM_OBJ_LIST);
  char l[128];
  strncpy(l, am_item_str(r, 0), sizeof l - 1);
  am_result_free(r);
  for (int i = 0; i < 10; i++) {
    CHECK_OK(am_list_insert_int(a, l, (size_t)i, i));
    CHECK_OK(am_commit(a, NULL));
  }
  AMdoc *b = am_create(NULL, 0);
  AMsyncState *sa = am_sync_state_new(), *sb = am_sync_state_new();
  CHECK(sync_loop(a, b, sa, sb) >= 0);
  CHECK(heads_equal(a, b));
  CHECK(res_int(am_length(b, l)) == 10);
  am_sync_state_free(sa);
  am_sync_state_free(sb);
  am_doc_free(b);
  am_doc_free(a);
}

/* -- sync peers where one has commits the other lacks ----------------------- */
static void test_one_sided_commits(void) {
  uint8_t a1[1] = {1}, a2[1] = {2};
  AMdoc *a = am_create(a1, 1);
  CHECK_OK(am_map_put_int(a, AM_ROOT, "base", 0));
  CHECK_OK(am_commit(a, NULL));
  AMdoc *b = am_fork(a, a2, 1);
  for (int i = 0; i < 5; i++) {
    char key[16];
    snprintf(key, sizeof key, "k%d", i);
    CHECK_OK(am_map_put_int(a, AM_ROOT, key, i));
    CHECK_OK(am_commit(a, NULL));
  }
  AMsyncState *sa = am_sync_state_new(), *sb = am_sync_state_new();
  CHECK(sync_loop(a, b, sa, sb) >= 0);
  CHECK(heads_equal(a, b));
  CHECK(res_int(am_map_get(b, AM_ROOT, "k4")) == 4);
  am_sync_state_free(sa);
  am_sync_state_free(sb);
  am_doc_free(b);
  am_doc_free(a);
}

/* -- bidirectional concurrent edits converge -------------------------------- */
static void test_bidirectional_concurrent(void) {
  uint8_t a1[1] = {1}, a2[1] = {2};
  AMdoc *a = am_create(a1, 1);
  AMresult *r = am_map_put_object(a, AM_ROOT, "t", AM_OBJ_TEXT);
  char t[128];
  strncpy(t, am_item_str(r, 0), sizeof t - 1);
  am_result_free(r);
  CHECK_OK(am_splice_text(a, t, 0, 0, "shared"));
  CHECK_OK(am_commit(a, NULL));
  AMdoc *b = am_fork(a, a2, 1);
  CHECK_OK(am_splice_text(a, t, 0, 0, "A:"));
  CHECK_OK(am_map_put_int(a, AM_ROOT, "from_a", 1));
  CHECK_OK(am_commit(a, NULL));
  CHECK_OK(am_splice_text(b, t, 6, 0, ":B"));
  CHECK_OK(am_map_put_int(b, AM_ROOT, "from_b", 2));
  CHECK_OK(am_commit(b, NULL));
  AMsyncState *sa = am_sync_state_new(), *sb = am_sync_state_new();
  CHECK(sync_loop(a, b, sa, sb) >= 0);
  CHECK(heads_equal(a, b));
  char ta[64], tb[64];
  res_str(am_text(a, t), ta, sizeof ta);
  res_str(am_text(b, t), tb, sizeof tb);
  CHECK(strcmp(ta, tb) == 0);
  CHECK(res_int(am_map_get(a, AM_ROOT, "from_b")) == 2);
  CHECK(res_int(am_map_get(b, AM_ROOT, "from_a")) == 1);
  am_sync_state_free(sa);
  am_sync_state_free(sb);
  am_doc_free(b);
  am_doc_free(a);
}

/* -- no messages once synced ------------------------------------------------ */
static void test_quiet_once_synced(void) {
  uint8_t a1[1] = {1};
  AMdoc *a = am_create(a1, 1);
  CHECK_OK(am_map_put_int(a, AM_ROOT, "x", 1));
  CHECK_OK(am_commit(a, NULL));
  AMdoc *b = am_create(NULL, 0);
  AMsyncState *sa = am_sync_state_new(), *sb = am_sync_state_new();
  CHECK(sync_loop(a, b, sa, sb) >= 0);
  /* both generators now return empty */
  AMresult *m = am_generate_sync_message(a, sa);
  CHECK(res_ok(m) && am_result_size(m) == 0);
  am_result_free(m);
  m = am_generate_sync_message(b, sb);
  CHECK(res_ok(m) && am_result_size(m) == 0);
  am_result_free(m);
  am_sync_state_free(sa);
  am_sync_state_free(sb);
  am_doc_free(b);
  am_doc_free(a);
}

/* -- works with (persisted) prior sync state -------------------------------- */
static void test_prior_sync_state_roundtrip(void) {
  uint8_t a1[1] = {1};
  AMdoc *a = am_create(a1, 1);
  CHECK_OK(am_map_put_int(a, AM_ROOT, "x", 1));
  CHECK_OK(am_commit(a, NULL));
  AMdoc *b = am_create(NULL, 0);
  AMsyncState *sa = am_sync_state_new(), *sb = am_sync_state_new();
  CHECK(sync_loop(a, b, sa, sb) >= 0);

  /* after convergence both peers record the same shared heads */
  AMresult *sh = am_sync_state_shared_heads(sa);
  CHECK(res_ok(sh) && am_result_size(sh) == 1);
  am_result_free(sh);

  /* persist both states (only shared_heads survives, by design) */
  size_t la = res_bytes(am_sync_state_encode(sa), buf, sizeof buf);
  CHECK(la > 0);
  AMsyncState *sa2 = am_sync_state_decode(buf, la);
  CHECK(sa2 != NULL);
  size_t lb = res_bytes(am_sync_state_encode(sb), buf, sizeof buf);
  AMsyncState *sb2 = am_sync_state_decode(buf, lb);
  CHECK(sb2 != NULL);
  am_sync_state_free(sa);
  am_sync_state_free(sb);

  /* more edits on a; resumed states catch b up without a full resync */
  CHECK_OK(am_map_put_int(a, AM_ROOT, "y", 2));
  CHECK_OK(am_commit(a, NULL));
  CHECK(sync_loop(a, b, sa2, sb2) >= 0);
  CHECK(heads_equal(a, b));
  CHECK(res_int(am_map_get(b, AM_ROOT, "y")) == 2);
  am_sync_state_free(sa2);
  am_sync_state_free(sb2);
  am_doc_free(b);
  am_doc_free(a);
}

/* -- resync after one peer crashes with data loss --------------------------- */
static void test_resync_after_data_loss(void) {
  uint8_t a1[1] = {1};
  AMdoc *a = am_create(a1, 1);
  CHECK_OK(am_map_put_int(a, AM_ROOT, "x", 1));
  CHECK_OK(am_commit(a, NULL));
  AMdoc *b = am_create(NULL, 0);
  AMsyncState *sa = am_sync_state_new(), *sb = am_sync_state_new();
  CHECK(sync_loop(a, b, sa, sb) >= 0);
  CHECK(heads_equal(a, b));

  /* b crashes and restarts empty with a FRESH state; a keeps its old
   * state that believes b has everything — sync must still recover */
  am_doc_free(b);
  am_sync_state_free(sb);
  b = am_create(NULL, 0);
  sb = am_sync_state_new();
  am_sync_state_free(sa);
  sa = am_sync_state_new();
  CHECK(sync_loop(a, b, sa, sb) >= 0);
  CHECK(heads_equal(a, b));
  CHECK(res_int(am_map_get(b, AM_ROOT, "x")) == 1);
  am_sync_state_free(sa);
  am_sync_state_free(sb);
  am_doc_free(b);
  am_doc_free(a);
}

/* -- heavy branching / merging histories ------------------------------------ */
static void test_branching_histories(void) {
  uint8_t a1[1] = {1}, a2[1] = {2};
  AMdoc *a = am_create(a1, 1);
  CHECK_OK(am_map_put_int(a, AM_ROOT, "seed", 0));
  CHECK_OK(am_commit(a, NULL));
  AMdoc *b = am_fork(a, a2, 1);
  /* alternating concurrent rounds with periodic merges */
  for (int i = 0; i < 8; i++) {
    char ka[16], kb[16];
    snprintf(ka, sizeof ka, "a%d", i);
    snprintf(kb, sizeof kb, "b%d", i);
    CHECK_OK(am_map_put_int(a, AM_ROOT, ka, i));
    CHECK_OK(am_commit(a, NULL));
    CHECK_OK(am_map_put_int(b, AM_ROOT, kb, i));
    CHECK_OK(am_commit(b, NULL));
    if (i % 3 == 2) {
      CHECK_OK(am_merge(a, b));
    }
  }
  AMsyncState *sa = am_sync_state_new(), *sb = am_sync_state_new();
  CHECK(sync_loop(a, b, sa, sb) >= 0);
  CHECK(heads_equal(a, b));
  CHECK(res_int(am_map_get(b, AM_ROOT, "a7")) == 7);
  CHECK(res_int(am_map_get(a, AM_ROOT, "b7")) == 7);
  am_sync_state_free(sa);
  am_sync_state_free(sb);
  am_doc_free(b);
  am_doc_free(a);
}

/* -- three peers in a chain converge ---------------------------------------- */
static void test_three_peer_chain(void) {
  uint8_t a1[1] = {1}, a2[1] = {2}, a3[1] = {3};
  AMdoc *a = am_create(a1, 1);
  CHECK_OK(am_map_put_int(a, AM_ROOT, "origin", 1));
  CHECK_OK(am_commit(a, NULL));
  AMdoc *b = am_fork(a, a2, 1);
  AMdoc *c = am_fork(a, a3, 1);
  CHECK_OK(am_map_put_int(a, AM_ROOT, "from_a", 1));
  CHECK_OK(am_commit(a, NULL));
  CHECK_OK(am_map_put_int(c, AM_ROOT, "from_c", 3));
  CHECK_OK(am_commit(c, NULL));
  /* a <-> b, then b <-> c: c's and a's edits flow through b */
  AMsyncState *s1 = am_sync_state_new(), *s2 = am_sync_state_new();
  AMsyncState *s3 = am_sync_state_new(), *s4 = am_sync_state_new();
  CHECK(sync_loop(a, b, s1, s2) >= 0);
  CHECK(sync_loop(b, c, s3, s4) >= 0);
  CHECK(res_int(am_map_get(c, AM_ROOT, "from_a")) == 1);
  CHECK(res_int(am_map_get(b, AM_ROOT, "from_c")) == 3);
  CHECK(sync_loop(a, b, s1, s2) >= 0);
  CHECK(res_int(am_map_get(a, AM_ROOT, "from_c")) == 3);
  am_sync_state_free(s1);
  am_sync_state_free(s2);
  am_sync_state_free(s3);
  am_sync_state_free(s4);
  am_doc_free(c);
  am_doc_free(b);
  am_doc_free(a);
}

/* -- sync transfers marks and counters intact -------------------------------- */
static void test_sync_rich_content(void) {
  uint8_t a1[1] = {1};
  AMdoc *a = am_create(a1, 1);
  AMresult *r = am_map_put_object(a, AM_ROOT, "t", AM_OBJ_TEXT);
  char t[128];
  strncpy(t, am_item_str(r, 0), sizeof t - 1);
  am_result_free(r);
  CHECK_OK(am_splice_text(a, t, 0, 0, "rich content"));
  CHECK_OK(am_mark_str(a, t, 0, 4, "style", "heading", "after"));
  CHECK_OK(am_map_put_counter(a, AM_ROOT, "n", 5));
  CHECK_OK(am_map_increment(a, AM_ROOT, "n", 2));
  CHECK_OK(am_commit(a, NULL));
  AMdoc *b = am_create(NULL, 0);
  AMsyncState *sa = am_sync_state_new(), *sb = am_sync_state_new();
  CHECK(sync_loop(a, b, sa, sb) >= 0);
  CHECK(strcmp(res_str(am_text(b, t), sbuf, sizeof sbuf), "rich content") == 0);
  CHECK(res_int(am_map_get(b, AM_ROOT, "n")) == 7);
  AMresult *ms = am_marks(b, t);
  CHECK(res_ok(ms) && am_result_size(ms) == 4);
  CHECK(strcmp(am_item_str(ms, 3), "heading") == 0);
  am_result_free(ms);
  am_sync_state_free(sa);
  am_sync_state_free(sb);
  am_doc_free(b);
  am_doc_free(a);
}

int main(void) {
  if (am_init() != 0) {
    fprintf(stderr, "am_init failed\n");
    return 2;
  }
  test_empty_doc_sends_message();
  test_empty_docs_converge();
  test_offer_all_changes_from_nothing();
  test_one_sided_commits();
  test_bidirectional_concurrent();
  test_quiet_once_synced();
  test_prior_sync_state_roundtrip();
  test_resync_after_data_loss();
  test_branching_histories();
  test_three_peer_chain();
  test_sync_rich_content();
  int rc = am_test_finish("test_sync");
  am_shutdown();
  return rc;
}
