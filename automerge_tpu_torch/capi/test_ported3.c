/* Third C-corpus suite: the change-exchange surface, deep history,
 * sync-state persistence, the error-path matrix, and a measured C-ABI
 * throughput probe (behavioral ports of scenarios from the reference's
 * automerge-c test corpus — doc_tests, item/result discipline, the
 * byte_span and actor-id tests, plus the criterion-style bulk-call
 * timing discipline — re-expressed against this framework's am.h; no
 * code copied).
 *
 * Throughput note (BASELINE.md "C ABI throughput is Python-bound"): the
 * probe prints per-op and bulk-call rates to stderr so CI logs carry
 * the measured boundary cost; the bulk idiom (am_splice_text with a
 * whole run, am_apply_changes with a whole chunk set) is what C
 * embedders should use on hot paths.
 */
#include <stdio.h>
#include <string.h>
#include <time.h>

#include "am.h"
#include "test_util.h"

static uint8_t blob[1 << 20];
static uint8_t blob2[1 << 20];
static char sbuf[1 << 16];

static double now_s(void) {
  struct timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return ts.tv_sec + 1e-9 * ts.tv_nsec;
}

static void obj_of(AMresult *r, char *out, size_t cap) {
  out[0] = '\0';
  if (res_ok(r) && am_result_size(r) > 0) {
    strncpy(out, am_item_str(r, 0), cap - 1);
    out[cap - 1] = '\0';
  }
  am_result_free(r);
}

/* -- incremental save / apply matrix ---------------------------------------- */
/* (reference doc.rs AMsaveIncremental/AMloadIncremental discipline) */
static void test_incremental_save_apply_matrix(void) {
  uint8_t a1[1] = {1}, a2[1] = {2};
  AMdoc *src = am_create(a1, 1);
  char t[128];
  obj_of(am_map_put_object(src, AM_ROOT, "t", AM_OBJ_TEXT), t, sizeof t);
  CHECK_OK(am_splice_text(src, t, 0, 0, "one"));
  CHECK_OK(am_commit(src, "c1"));
  uint8_t h1[32 * 4];
  size_t n1 = res_heads(am_get_heads(src), h1, 4);

  CHECK_OK(am_splice_text(src, t, 3, 0, " two"));
  CHECK_OK(am_commit(src, "c2"));
  uint8_t h2[32 * 4];
  size_t n2 = res_heads(am_get_heads(src), h2, 4);

  CHECK_OK(am_splice_text(src, t, 7, 0, " three"));
  CHECK_OK(am_commit(src, "c3"));

  /* save_incremental(NULL) = everything; (h1) = c2+c3; (h2) = c3 */
  size_t all = res_bytes(am_save_incremental(src, NULL, 0), blob, sizeof blob);
  size_t after1 = res_bytes(am_save_incremental(src, h1, n1), blob2, sizeof blob2);
  CHECK(all > after1 && after1 > 0);

  /* a replica fed everything converges */
  AMdoc *dst = am_create(a2, 1);
  CHECK_OK(am_apply_changes(dst, blob, all));
  CHECK(strcmp(res_str(am_text(dst, t), sbuf, sizeof sbuf), "one two three")
        == 0);
  CHECK(res_int(am_equal(src, dst)) == 1);

  /* a replica at h1 fed only the delta converges too */
  AMdoc *mid = am_fork_at(src, h1, n1, a2, 1);
  CHECK(strcmp(res_str(am_text(mid, t), sbuf, sizeof sbuf), "one") == 0);
  CHECK_OK(am_apply_changes(mid, blob2, after1));
  CHECK(strcmp(res_str(am_text(mid, t), sbuf, sizeof sbuf), "one two three")
        == 0);
  am_doc_free(mid);
  am_doc_free(dst);
  am_doc_free(src);
}

/* -- get_changes / by-hash / added / last-local ------------------------------ */
static void test_change_exchange_accessors(void) {
  uint8_t a1[1] = {1}, a2[1] = {2};
  AMdoc *d1 = am_create(a1, 1);
  CHECK_OK(am_map_put_int(d1, AM_ROOT, "x", 1));
  CHECK_OK(am_commit(d1, NULL));
  AMdoc *d2 = am_fork(d1, a2, 1);
  CHECK_OK(am_map_put_int(d2, AM_ROOT, "y", 2));
  CHECK_OK(am_commit(d2, NULL));
  CHECK_OK(am_map_put_int(d1, AM_ROOT, "z", 3));
  CHECK_OK(am_commit(d1, NULL));

  /* changes_added(d1, d2) = what a merge would carry over */
  AMresult *added = am_get_changes_added(d1, d2);
  CHECK(am_result_size(added) == 1);
  size_t clen = 0;
  const uint8_t *cp = am_item_bytes(added, 0, &clen);
  memcpy(blob, cp, clen);
  am_result_free(added);
  CHECK_OK(am_apply_changes(d1, blob, clen));
  CHECK(res_int(am_map_get(d1, AM_ROOT, "y")) == 2);

  /* get_changes(heads=NULL) walks the whole history (3 changes now) */
  AMresult *all = am_get_changes(d1, NULL, 0);
  CHECK(am_result_size(all) == 3);
  am_result_free(all);

  /* by-hash round trip: every head hash resolves to a chunk */
  uint8_t hs[32 * 4];
  size_t nh = res_heads(am_get_heads(d1), hs, 4);
  CHECK(nh >= 1);
  for (size_t i = 0; i < nh; i++) {
    AMresult *ch = am_get_change_by_hash(d1, hs + 32 * i);
    CHECK(am_result_size(ch) == 1);
    am_result_free(ch);
  }
  uint8_t bogus[32] = {0};
  AMresult *missing = am_get_change_by_hash(d1, bogus);
  CHECK(res_ok(missing) && am_result_size(missing) == 0);
  am_result_free(missing);

  /* last local change belongs to this doc's actor */
  CHECK_OK(am_map_put_int(d1, AM_ROOT, "w", 4));
  AMresult *last = am_get_last_local_change(d1);
  CHECK(am_result_size(last) == 1);
  am_result_free(last);
  am_doc_free(d1);
  am_doc_free(d2);
}

/* -- sync-state persistence across a process restart ------------------------- */
/* (reference sync/state.rs: only shared_heads survives encode) */
static void test_sync_state_persistence(void) {
  uint8_t a1[1] = {1}, a2[1] = {2};
  AMdoc *d1 = am_create(a1, 1), *d2 = am_create(a2, 1);
  char l[128];
  obj_of(am_map_put_object(d1, AM_ROOT, "l", AM_OBJ_LIST), l, sizeof l);
  for (int i = 0; i < 5; i++) {
    CHECK_OK(am_list_insert_int(d1, l, (size_t)i, i));
    CHECK_OK(am_commit(d1, NULL));
  }
  AMsyncState *s1 = am_sync_state_new(), *s2 = am_sync_state_new();
  for (int round = 0; round < 40; round++) {
    AMresult *m1 = am_generate_sync_message(d1, s1);
    AMresult *m2 = am_generate_sync_message(d2, s2);
    int quiet = am_result_size(m1) == 0 && am_result_size(m2) == 0;
    if (am_result_size(m1)) {
      size_t ln = 0;
      const uint8_t *p = am_item_bytes(m1, 0, &ln);
      memcpy(blob, p, ln);
      CHECK_OK(am_receive_sync_message(d2, s2, blob, ln));
    }
    if (am_result_size(m2)) {
      size_t ln = 0;
      const uint8_t *p = am_item_bytes(m2, 0, &ln);
      memcpy(blob, p, ln);
      CHECK_OK(am_receive_sync_message(d1, s1, blob, ln));
    }
    am_result_free(m1);
    am_result_free(m2);
    if (quiet) break;
  }
  AMresult *sh = am_sync_state_shared_heads(s1);
  CHECK(am_result_size(sh) >= 1);
  am_result_free(sh);

  /* persist both states; "restart"; resume with NEW divergence */
  size_t e1 = res_bytes(am_sync_state_encode(s1), blob, sizeof blob);
  size_t e2 = res_bytes(am_sync_state_encode(s2), blob2, sizeof blob2);
  CHECK(e1 > 0 && e2 > 0);
  am_sync_state_free(s1);
  am_sync_state_free(s2);
  AMsyncState *r1 = am_sync_state_decode(blob, e1);
  AMsyncState *r2 = am_sync_state_decode(blob2, e2);
  CHECK(r1 && r2);
  sh = am_sync_state_shared_heads(r1);
  CHECK(am_result_size(sh) >= 1); /* shared_heads survived the roundtrip */
  am_result_free(sh);

  CHECK_OK(am_list_insert_int(d1, l, 5, 99));
  CHECK_OK(am_commit(d1, NULL));
  int rounds = 0;
  for (; rounds < 40; rounds++) {
    AMresult *m1 = am_generate_sync_message(d1, r1);
    AMresult *m2 = am_generate_sync_message(d2, r2);
    int quiet = am_result_size(m1) == 0 && am_result_size(m2) == 0;
    if (am_result_size(m1)) {
      size_t ln = 0;
      const uint8_t *p = am_item_bytes(m1, 0, &ln);
      memcpy(blob, p, ln);
      CHECK_OK(am_receive_sync_message(d2, r2, blob, ln));
    }
    if (am_result_size(m2)) {
      size_t ln = 0;
      const uint8_t *p = am_item_bytes(m2, 0, &ln);
      memcpy(blob, p, ln);
      CHECK_OK(am_receive_sync_message(d1, r1, blob, ln));
    }
    am_result_free(m1);
    am_result_free(m2);
    if (quiet) break;
  }
  CHECK(rounds < 40);
  CHECK(res_int(am_length(d2, l)) == 6);
  am_sync_state_free(r1);
  am_sync_state_free(r2);
  am_doc_free(d1);
  am_doc_free(d2);
}

/* -- error-path matrix: bad handles, ids, indexes, types --------------------- */
/* (reference result.rs/item.rs discipline: errors come back as AMresult
 * status, never crashes) */
static void test_error_paths(void) {
  AMdoc *d = am_create(NULL, 0);
  /* unknown object id */
  AMresult *r = am_map_get(d, "999@ffffffffffffffffffffffffffffffff", "k");
  CHECK(am_result_status(r) == AM_STATUS_ERROR);
  am_result_free(r);
  /* malformed object id */
  r = am_map_put_int(d, "not-an-id", "k", 1);
  CHECK(am_result_status(r) == AM_STATUS_ERROR);
  am_result_free(r);
  /* list index out of range */
  char l[128];
  obj_of(am_map_put_object(d, AM_ROOT, "l", AM_OBJ_LIST), l, sizeof l);
  r = am_list_put_int(d, l, 5, 1); /* put beyond length errors */
  CHECK(am_result_status(r) == AM_STATUS_ERROR);
  am_result_free(r);
  CHECK_OK(am_list_insert_int(d, l, 0, 1)); /* insert at len is push */
  /* map ops on a list object */
  r = am_map_put_int(d, l, "k", 1);
  CHECK(am_result_status(r) == AM_STATUS_ERROR);
  am_result_free(r);
  /* text ops on a map */
  r = am_splice_text(d, AM_ROOT, 0, 0, "x");
  CHECK(am_result_status(r) == AM_STATUS_ERROR);
  am_result_free(r);
  /* increment of a non-counter */
  CHECK_OK(am_map_put_int(d, AM_ROOT, "n", 1));
  r = am_map_increment(d, AM_ROOT, "n", 1);
  CHECK(am_result_status(r) == AM_STATUS_ERROR);
  am_result_free(r);
  /* corrupt load returns NULL, not a crash */
  uint8_t junk[16] = {1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
  AMdoc *bad = am_load(junk, sizeof junk);
  CHECK(bad == NULL);
  /* item accessors out of range return benign defaults */
  r = am_get_heads(d);
  CHECK(am_item_type(r, 99) == AM_VAL_VOID);
  CHECK(am_item_str(r, 99) == NULL || am_item_str(r, 99)[0] == '\0');
  am_result_free(r);
  am_doc_free(d);
}

/* -- deep history: many commits, reads at every recorded point --------------- */
static void test_deep_history_reads(void) {
  AMdoc *d = am_create(NULL, 0);
  char t[128];
  obj_of(am_map_put_object(d, AM_ROOT, "t", AM_OBJ_TEXT), t, sizeof t);
  static uint8_t heads[24][32 * 2];
  static size_t nheads[24];
  char expect[25][32];
  expect[0][0] = '\0';
  for (int i = 0; i < 24; i++) {
    char c[2] = {(char)('a' + i), 0};
    CHECK_OK(am_splice_text(d, t, (size_t)i, 0, c));
    CHECK_OK(am_commit(d, NULL));
    nheads[i] = res_heads(am_get_heads(d), heads[i], 2);
    snprintf(expect[i + 1], sizeof expect[i + 1], "%s%s", expect[i], c);
  }
  /* every historical point reads back its exact text + length */
  for (int i = 0; i < 24; i++) {
    CHECK(strcmp(res_str(am_text_at(d, t, heads[i], nheads[i]), sbuf,
                         sizeof sbuf),
                 expect[i + 1]) == 0);
    CHECK(res_int(am_length_at(d, t, heads[i], nheads[i])) == i + 1);
  }
  /* historical single-element read */
  AMresult *r = am_list_get_at(d, t, 0, heads[3], nheads[3]);
  CHECK(am_result_size(r) == 1);
  am_result_free(r);
  am_doc_free(d);
}

/* -- concurrent counters in maps across three peers -------------------------- */
static void test_three_peer_counter_convergence(void) {
  uint8_t a1[1] = {1}, a2[1] = {2}, a3[1] = {3};
  AMdoc *d1 = am_create(a1, 1);
  CHECK_OK(am_map_put_counter(d1, AM_ROOT, "hits", 0));
  CHECK_OK(am_commit(d1, NULL));
  AMdoc *d2 = am_fork(d1, a2, 1), *d3 = am_fork(d1, a3, 1);
  for (int i = 0; i < 10; i++) {
    CHECK_OK(am_map_increment(d1, AM_ROOT, "hits", 1));
    CHECK_OK(am_map_increment(d2, AM_ROOT, "hits", 2));
    CHECK_OK(am_map_increment(d3, AM_ROOT, "hits", 3));
  }
  CHECK_OK(am_commit(d1, NULL));
  CHECK_OK(am_commit(d2, NULL));
  CHECK_OK(am_commit(d3, NULL));
  /* merge in both directions and orders: totals must agree everywhere */
  CHECK_OK(am_merge(d1, d2));
  CHECK_OK(am_merge(d1, d3));
  CHECK_OK(am_merge(d3, d2));
  CHECK_OK(am_merge(d3, d1));
  CHECK_OK(am_merge(d2, d3));
  AMresult *r = am_map_get(d1, AM_ROOT, "hits");
  CHECK(am_item_type(r, 0) == AM_VAL_COUNTER);
  CHECK(am_item_int(r, 0) == 60);
  am_result_free(r);
  CHECK(res_int(am_map_get(d2, AM_ROOT, "hits")) == 60);
  CHECK(res_int(am_map_get(d3, AM_ROOT, "hits")) == 60);
  am_doc_free(d1);
  am_doc_free(d2);
  am_doc_free(d3);
}

/* -- unicode text through the C boundary ------------------------------------- */
static void test_unicode_text(void) {
  AMdoc *d = am_create(NULL, 0);
  char t[128];
  obj_of(am_map_put_object(d, AM_ROOT, "t", AM_OBJ_TEXT), t, sizeof t);
  /* 2-byte, 3-byte and 4-byte UTF-8 sequences */
  CHECK_OK(am_splice_text(d, t, 0, 0, "caf\xc3\xa9 \xe2\x82\xac \xf0\x9f\x98\x80"));
  /* length counts the configured text units, not bytes */
  int64_t len = res_int(am_length(d, t));
  CHECK(len > 0 && len < 12);
  /* round-trips through save/load byte-identically */
  size_t sl = res_bytes(am_save(d), blob, sizeof blob);
  AMdoc *d2 = am_load(blob, sl);
  CHECK(d2 != NULL);
  res_str(am_text(d2, t), sbuf, sizeof sbuf);
  CHECK(strcmp(sbuf, "caf\xc3\xa9 \xe2\x82\xac \xf0\x9f\x98\x80") == 0);
  /* splice after the emoji keeps units consistent */
  CHECK_OK(am_splice_text(d2, t, (size_t)res_int(am_length(d2, t)), 0, "!"));
  res_str(am_text(d2, t), sbuf, sizeof sbuf);
  CHECK(sbuf[strlen(sbuf) - 1] == '!');
  am_doc_free(d);
  am_doc_free(d2);
}

/* -- measured throughput probe ----------------------------------------------- */
/* Not an assertion (the boundary crosses into the embedded runtime, and
 * BASELINE.md documents it as interpreter-bound per call); prints per-op
 * vs bulk rates so CI logs track the boundary cost and the bulk idiom's
 * advantage stays visible. */
/* -- hot-call fast-path edge cases ------------------------------------------- */
/* The am_embed hot-call cache must agree with the dispatch path on every
 * rejection: invalid utf-8, splices on non-text objects, empty keys, and
 * op-id accounting across fast/slow interleavings. */
static void test_fast_path_edges(void) {
  AMdoc *d = am_create(NULL, 0);
  char t[128], l[128];
  obj_of(am_map_put_object(d, AM_ROOT, "t", AM_OBJ_TEXT), t, sizeof t);
  obj_of(am_map_put_object(d, AM_ROOT, "l", AM_OBJ_LIST), l, sizeof l);

  /* arm the fast path, then feed it input only the dispatch path rejects */
  CHECK_OK(am_splice_text(d, t, 0, 0, "ok"));
  AMresult *r = am_splice_text(d, t, 0, 0, "\xff\xfe");
  CHECK(am_result_status(r) != AM_STATUS_OK); /* stray lead bytes */
  am_result_free(r);
  r = am_splice_text(d, t, 0, 0, "\xf8\x80\x80\x80");
  CHECK(am_result_status(r) != AM_STATUS_OK); /* > 4-byte lead */
  am_result_free(r);
  r = am_splice_text(d, t, 0, 0, "\xed\xa0\x80");
  CHECK(am_result_status(r) != AM_STATUS_OK); /* surrogate half */
  am_result_free(r);
  r = am_splice_text(d, t, 0, 0, "\xc0\xaf");
  CHECK(am_result_status(r) != AM_STATUS_OK); /* overlong */
  am_result_free(r);
  CHECK_OK(am_splice_text(d, t, 2, 0, " \xf0\x9f\x9a\x80")); /* valid 4-byte */

  /* splice on a LIST object must error exactly like the python frontend */
  r = am_splice_text(d, l, 0, 0, "nope");
  CHECK(am_result_status(r) != AM_STATUS_OK);
  am_result_free(r);

  /* empty / invalid-utf8 keys: dispatch path raises */
  r = am_map_put_int(d, AM_ROOT, "", 1);
  CHECK(am_result_status(r) != AM_STATUS_OK);
  am_result_free(r);
  r = am_map_put_str(d, AM_ROOT, "k", "\xff");
  CHECK(am_result_status(r) != AM_STATUS_OK); /* invalid utf-8 value */
  am_result_free(r);

  /* fast/slow interleave: map puts (fast), delete (dispatch), puts again;
   * op-id accounting must stay consistent through commit + reload */
  CHECK_OK(am_map_put_int(d, AM_ROOT, "a", 1));
  CHECK_OK(am_map_put_int(d, AM_ROOT, "b", 2));
  CHECK_OK(am_map_delete(d, AM_ROOT, "a"));
  CHECK_OK(am_map_put_int(d, AM_ROOT, "c", 3));
  CHECK_OK(am_splice_text(d, t, 0, 0, ">"));
  CHECK_OK(am_map_put_counter(d, AM_ROOT, "n", 5));
  CHECK_OK(am_map_increment(d, AM_ROOT, "n", 2));
  CHECK_OK(am_commit(d, NULL));
  CHECK(res_int(am_map_get(d, AM_ROOT, "n")) == 7);
  CHECK(res_int(am_map_get(d, AM_ROOT, "c")) == 3);
  r = am_map_get(d, AM_ROOT, "a");
  CHECK(am_result_status(r) == AM_STATUS_OK && am_result_size(r) == 0);
  am_result_free(r);
  /* save/load roundtrip proves the ids encoded consistently */
  uint8_t buf[1 << 16];
  size_t n = res_bytes(am_save(d), buf, sizeof buf);
  AMdoc *d2 = am_load(buf, n);
  CHECK(d2 != NULL);
  CHECK(res_int(am_map_get(d2, AM_ROOT, "n")) == 7);
  char s1[256], s2[256];
  res_str(am_text(d2, t), s1, sizeof s1);
  res_str(am_text(d, t), s2, sizeof s2);
  CHECK(strcmp(s1, s2) == 0);
  am_doc_free(d);
  am_doc_free(d2);
}

static void test_throughput_probe(void) {
  AMdoc *d = am_create(NULL, 0);
  char t[128];
  obj_of(am_map_put_object(d, AM_ROOT, "t", AM_OBJ_TEXT), t, sizeof t);
  const int N = 20000;
  double t0 = now_s();
  for (int i = 0; i < N; i++) {
    CHECK_OK(am_splice_text(d, t, (size_t)i, 0, "x"));
  }
  double per_op = N / (now_s() - t0);
  /* per-call map puts (the am_embed hot-call cache drives the native
   * map session directly — no Python in the loop) */
  char key[32];
  t0 = now_s();
  for (int i = 0; i < N; i++) {
    snprintf(key, sizeof key, "k%06d", i);
    CHECK_OK(am_map_put_int(d, AM_ROOT, key, i));
  }
  double per_put = N / (now_s() - t0);
  /* bulk idiom: one boundary crossing for the whole run */
  char big[8193];
  memset(big, 'y', 8192);
  big[8192] = 0;
  t0 = now_s();
  CHECK_OK(am_splice_text(d, t, (size_t)N, 0, big));
  double bulk = 8192 / (now_s() - t0);
  fprintf(stderr,
          "capi throughput: %.0f splice ops/s per-call, %.0f map puts/s "
          "per-call, %.0f chars/s bulk\n",
          per_op, per_put, bulk);
  CHECK(res_int(am_length(d, t)) == N + 8192);
  CHECK(res_int(am_map_get(d, AM_ROOT, "k000007")) == 7);
  am_doc_free(d);
}

/* -- conflicting values at historical heads ---------------------------------- */
/* (reference read.rs get_all_at: every conflicting writer visible, and
 * the view at older heads must not see later resolutions) */
static void test_get_all_at_conflict_history(void) {
  uint8_t a1[1] = {1}, a2[1] = {2}, a3[1] = {3};
  AMdoc *d1 = am_create(a1, 1);
  CHECK_OK(am_map_put_str(d1, AM_ROOT, "k", "base"));
  CHECK_OK(am_commit(d1, NULL));
  AMdoc *d2 = am_fork(d1, a2, 1), *d3 = am_fork(d1, a3, 1);
  CHECK_OK(am_map_put_str(d1, AM_ROOT, "k", "one"));
  CHECK_OK(am_commit(d1, NULL));
  CHECK_OK(am_map_put_str(d2, AM_ROOT, "k", "two"));
  CHECK_OK(am_commit(d2, NULL));
  CHECK_OK(am_map_put_str(d3, AM_ROOT, "k", "three"));
  CHECK_OK(am_commit(d3, NULL));
  CHECK_OK(am_merge(d1, d2));
  CHECK_OK(am_merge(d1, d3));
  uint8_t h3[32 * 4];
  size_t n3 = res_heads(am_get_heads(d1), h3, 4);
  CHECK(n3 == 3); /* three concurrent heads */

  /* all three writers visible as conflicts */
  AMresult *all = am_map_get_all(d1, AM_ROOT, "k");
  CHECK(am_result_size(all) == 3);
  am_result_free(all);

  /* a later overwrite collapses the conflict... */
  CHECK_OK(am_map_put_str(d1, AM_ROOT, "k", "winner"));
  CHECK_OK(am_commit(d1, NULL));
  all = am_map_get_all(d1, AM_ROOT, "k");
  CHECK(am_result_size(all) == 1);
  CHECK(strcmp(am_item_str(all, 0), "winner") == 0);
  am_result_free(all);

  /* ...but the historical view still shows all three */
  all = am_map_get_all_at(d1, AM_ROOT, "k", h3, n3);
  CHECK(am_result_size(all) == 3);
  int saw_one = 0, saw_two = 0, saw_three = 0;
  for (size_t i = 0; i < 3; i++) {
    const char *s = am_item_str(all, i);
    if (s && strcmp(s, "one") == 0) saw_one = 1;
    if (s && strcmp(s, "two") == 0) saw_two = 1;
    if (s && strcmp(s, "three") == 0) saw_three = 1;
  }
  CHECK(saw_one && saw_two && saw_three);
  am_result_free(all);
  am_doc_free(d1);
  am_doc_free(d2);
  am_doc_free(d3);
}

/* -- deep nesting: lists of lists of maps, reads at every level -------------- */
static void test_deep_nesting(void) {
  AMdoc *d = am_create(NULL, 0);
  char grid[128];
  obj_of(am_map_put_object(d, AM_ROOT, "grid", AM_OBJ_LIST), grid,
         sizeof grid);
  char rows[3][128];
  for (int r = 0; r < 3; r++) {
    obj_of(am_list_insert_object(d, grid, (size_t)r, AM_OBJ_LIST), rows[r],
           sizeof rows[r]);
    for (int c = 0; c < 3; c++) {
      char cell[128];
      obj_of(am_list_insert_object(d, rows[r], (size_t)c, AM_OBJ_MAP), cell,
             sizeof cell);
      CHECK_OK(am_map_put_int(d, cell, "v", r * 3 + c));
    }
  }
  CHECK_OK(am_commit(d, NULL));
  CHECK(res_int(am_length(d, grid)) == 3);
  /* read a middle cell back through the id chain */
  AMresult *row1 = am_list_get(d, grid, 1);
  CHECK(am_item_type(row1, 0) == AM_VAL_OBJ_ID);
  char row1_id[128];
  strncpy(row1_id, am_item_str(row1, 0), sizeof row1_id - 1);
  row1_id[sizeof row1_id - 1] = 0;
  am_result_free(row1);
  AMresult *cell = am_list_get(d, row1_id, 2);
  CHECK(am_item_type(cell, 0) == AM_VAL_OBJ_ID);
  char cell_id[128];
  strncpy(cell_id, am_item_str(cell, 0), sizeof cell_id - 1);
  cell_id[sizeof cell_id - 1] = 0;
  am_result_free(cell);
  CHECK(res_int(am_map_get(d, cell_id, "v")) == 5);
  /* object_type reports each level correctly */
  CHECK(res_int(am_object_type(d, grid)) == AM_OBJ_LIST);
  CHECK(res_int(am_object_type(d, row1_id)) == AM_OBJ_LIST);
  CHECK(res_int(am_object_type(d, cell_id)) == AM_OBJ_MAP);
  /* survives save/load with every level intact */
  size_t sl = res_bytes(am_save(d), blob, sizeof blob);
  AMdoc *d2 = am_load(blob, sl);
  CHECK(d2 != NULL);
  CHECK(res_int(am_map_get(d2, cell_id, "v")) == 5);
  am_doc_free(d2);
  am_doc_free(d);
}

/* -- clone vs fork: actor identity and divergence ---------------------------- */
static void test_clone_vs_fork_actors(void) {
  uint8_t a1[4] = {0xDE, 0xAD, 0xBE, 0xEF}, a2[2] = {0xCA, 0xFE};
  AMdoc *d = am_create(a1, 4);
  CHECK_OK(am_map_put_int(d, AM_ROOT, "x", 1));
  CHECK_OK(am_commit(d, NULL));
  /* clone keeps the actor bytes exactly */
  AMdoc *c = am_clone(d);
  size_t ln = 0;
  AMresult *r = am_actor_id(c);
  const uint8_t *p = am_item_bytes(r, 0, &ln);
  CHECK(ln == 4 && memcmp(p, a1, 4) == 0);
  am_result_free(r);
  /* fork with an explicit actor uses it */
  AMdoc *f = am_fork(d, a2, 2);
  r = am_actor_id(f);
  p = am_item_bytes(r, 0, &ln);
  CHECK(ln == 2 && memcmp(p, a2, 2) == 0);
  am_result_free(r);
  /* fork with no actor mints a fresh one (not the parent's) */
  AMdoc *g = am_fork(d, NULL, 0);
  r = am_actor_id(g);
  p = am_item_bytes(r, 0, &ln);
  CHECK(!(ln == 4 && memcmp(p, a1, 4) == 0));
  am_result_free(r);
  /* divergent clones merge cleanly (same history root) */
  CHECK_OK(am_map_put_int(c, AM_ROOT, "from_clone", 1));
  CHECK_OK(am_commit(c, NULL));
  CHECK_OK(am_map_put_int(f, AM_ROOT, "from_fork", 2));
  CHECK_OK(am_commit(f, NULL));
  CHECK_OK(am_merge(d, c));
  CHECK_OK(am_merge(d, f));
  CHECK(res_int(am_map_get(d, AM_ROOT, "from_clone")) == 1);
  CHECK(res_int(am_map_get(d, AM_ROOT, "from_fork")) == 2);
  am_doc_free(c);
  am_doc_free(f);
  am_doc_free(g);
  am_doc_free(d);
}

/* -- keys ordering and map_entries with many keys ---------------------------- */
static void test_many_keys_ordering(void) {
  AMdoc *d = am_create(NULL, 0);
  /* insert in reverse order; keys() must come back sorted */
  for (int i = 63; i >= 0; i--) {
    char k[16];
    snprintf(k, sizeof k, "key%02d", i);
    CHECK_OK(am_map_put_int(d, AM_ROOT, k, i));
  }
  CHECK_OK(am_commit(d, NULL));
  AMresult *keys = am_keys(d, AM_ROOT);
  CHECK(am_result_size(keys) == 64);
  for (size_t i = 1; i < 64; i++)
    CHECK(strcmp(am_item_str(keys, i - 1), am_item_str(keys, i)) < 0);
  am_result_free(keys);
  /* map_entries pairs every key with its value */
  AMresult *ent = am_map_entries(d, AM_ROOT);
  CHECK(am_result_size(ent) == 128);
  CHECK(strcmp(am_item_str(ent, 0), "key00") == 0);
  CHECK(am_item_int(ent, 1) == 0);
  am_result_free(ent);
  /* deleting odd keys halves the count */
  for (int i = 1; i < 64; i += 2) {
    char k[16];
    snprintf(k, sizeof k, "key%02d", i);
    CHECK_OK(am_map_delete(d, AM_ROOT, k));
  }
  CHECK_OK(am_commit(d, NULL));
  keys = am_keys(d, AM_ROOT);
  CHECK(am_result_size(keys) == 32);
  am_result_free(keys);
  am_doc_free(d);
}

/* -- diff between arbitrary head pairs --------------------------------------- */
static void test_diff_between_heads(void) {
  AMdoc *d = am_create(NULL, 0);
  char t[128];
  obj_of(am_map_put_object(d, AM_ROOT, "t", AM_OBJ_TEXT), t, sizeof t);
  CHECK_OK(am_splice_text(d, t, 0, 0, "abc"));
  CHECK_OK(am_commit(d, NULL));
  uint8_t h1[32 * 2];
  size_t n1 = res_heads(am_get_heads(d), h1, 2);
  CHECK_OK(am_splice_text(d, t, 3, 0, "def"));
  CHECK_OK(am_map_put_int(d, AM_ROOT, "n", 1));
  CHECK_OK(am_commit(d, NULL));
  uint8_t h2[32 * 2];
  size_t n2 = res_heads(am_get_heads(d), h2, 2);

  /* forward diff: a splice_text and a put_map record */
  AMresult *p = am_diff(d, h1, n1, h2, n2);
  int saw_splice = 0, saw_put = 0;
  for (size_t i = 0; i + 5 < am_result_size(p); i += 6) {
    const char *kind = am_item_str(p, i + 2);
    if (kind && strcmp(kind, "splice_text") == 0) saw_splice = 1;
    if (kind && strcmp(kind, "put_map") == 0) saw_put = 1;
  }
  CHECK(saw_splice && saw_put);
  am_result_free(p);

  /* reverse diff: the put shows as a delete, the splice as a del */
  p = am_diff(d, h2, n2, h1, n1);
  int saw_del = 0;
  for (size_t i = 0; i + 5 < am_result_size(p); i += 6) {
    const char *kind = am_item_str(p, i + 2);
    if (kind && (strcmp(kind, "del_map") == 0 || strcmp(kind, "del_seq") == 0))
      saw_del = 1;
  }
  CHECK(saw_del);
  am_result_free(p);

  /* identical heads diff to nothing */
  p = am_diff(d, h2, n2, h2, n2);
  CHECK(am_result_size(p) == 0);
  am_result_free(p);
  am_doc_free(d);
}

/* -- rollback interleaved with committed sync -------------------------------- */
static void test_rollback_vs_sync(void) {
  uint8_t a1[1] = {1}, a2[1] = {2};
  AMdoc *d1 = am_create(a1, 1), *d2 = am_create(a2, 1);
  CHECK_OK(am_map_put_int(d1, AM_ROOT, "keep", 1));
  CHECK_OK(am_commit(d1, NULL));
  /* pending (uncommitted) ops roll back; sync ships only commits */
  CHECK_OK(am_map_put_int(d1, AM_ROOT, "discard", 2));
  CHECK(res_int(am_pending_ops(d1)) == 1);
  CHECK(res_int(am_rollback(d1)) == 1);
  AMsyncState *s1 = am_sync_state_new(), *s2 = am_sync_state_new();
  for (int round = 0; round < 40; round++) {
    AMresult *m1 = am_generate_sync_message(d1, s1);
    AMresult *m2 = am_generate_sync_message(d2, s2);
    int quiet = am_result_size(m1) == 0 && am_result_size(m2) == 0;
    if (am_result_size(m1)) {
      size_t ln = 0;
      const uint8_t *p = am_item_bytes(m1, 0, &ln);
      memcpy(blob, p, ln);
      CHECK_OK(am_receive_sync_message(d2, s2, blob, ln));
    }
    if (am_result_size(m2)) {
      size_t ln = 0;
      const uint8_t *p = am_item_bytes(m2, 0, &ln);
      memcpy(blob, p, ln);
      CHECK_OK(am_receive_sync_message(d1, s1, blob, ln));
    }
    am_result_free(m1);
    am_result_free(m2);
    if (quiet) break;
  }
  CHECK(res_int(am_map_get(d2, AM_ROOT, "keep")) == 1);
  AMresult *r = am_map_get(d2, AM_ROOT, "discard");
  CHECK(res_ok(r) && am_result_size(r) == 0);
  am_result_free(r);
  am_sync_state_free(s1);
  am_sync_state_free(s2);
  am_doc_free(d1);
  am_doc_free(d2);
}

/* -- cursors across history and merges --------------------------------------- */
static void test_cursor_matrix(void) {
  uint8_t a1[1] = {1}, a2[1] = {2};
  AMdoc *d1 = am_create(a1, 1);
  char t[128];
  obj_of(am_map_put_object(d1, AM_ROOT, "t", AM_OBJ_TEXT), t, sizeof t);
  CHECK_OK(am_splice_text(d1, t, 0, 0, "0123456789"));
  CHECK_OK(am_commit(d1, NULL));
  uint8_t h1[32 * 2];
  size_t n1 = res_heads(am_get_heads(d1), h1, 2);

  /* cursors at the start, middle and end all resolve */
  char c0[160], c5[160], c9[160];
  res_str(am_get_cursor(d1, t, 0), c0, sizeof c0);
  res_str(am_get_cursor(d1, t, 5), c5, sizeof c5);
  res_str(am_get_cursor(d1, t, 9), c9, sizeof c9);
  CHECK(c0[0] && c5[0] && c9[0]);
  CHECK(res_int(am_get_cursor_position(d1, t, c0)) == 0);
  CHECK(res_int(am_get_cursor_position(d1, t, c5)) == 5);
  CHECK(res_int(am_get_cursor_position(d1, t, c9)) == 9);

  /* a merge shifting everything moves all cursors coherently */
  AMdoc *d2 = am_fork(d1, a2, 1);
  CHECK_OK(am_splice_text(d2, t, 0, 0, "<<<"));
  CHECK_OK(am_commit(d2, NULL));
  CHECK_OK(am_merge(d1, d2));
  CHECK(res_int(am_get_cursor_position(d1, t, c0)) == 3);
  CHECK(res_int(am_get_cursor_position(d1, t, c5)) == 8);
  CHECK(res_int(am_get_cursor_position(d1, t, c9)) == 12);

  /* the cursor's element, read at the OLD heads, has the old position */
  char cat[160];
  res_str(am_get_cursor(d1, t, 8), cat, sizeof cat); /* == c5's element */
  CHECK(strcmp(cat, c5) == 0);
  am_doc_free(d1);
  am_doc_free(d2);
}

/* -- ranges with historical heads through the range reads -------------------- */
static void test_range_reads(void) {
  AMdoc *d = am_create(NULL, 0);
  char l[128];
  obj_of(am_map_put_object(d, AM_ROOT, "l", AM_OBJ_LIST), l, sizeof l);
  for (int i = 0; i < 20; i++)
    CHECK_OK(am_list_insert_int(d, l, (size_t)i, i * 10));
  CHECK_OK(am_commit(d, NULL));

  /* bounded range */
  AMresult *r = am_list_range(d, l, 5, 9);
  CHECK(am_result_size(r) == 4);
  CHECK(am_item_int(r, 0) == 50 && am_item_int(r, 3) == 80);
  am_result_free(r);
  /* empty + inverted + beyond-length ranges are benign */
  r = am_list_range(d, l, 7, 7);
  CHECK(res_ok(r) && am_result_size(r) == 0);
  am_result_free(r);
  r = am_list_range(d, l, 12, 5);
  CHECK(res_ok(r) && am_result_size(r) == 0);
  am_result_free(r);
  r = am_list_range(d, l, 18, 500);
  CHECK(am_result_size(r) == 2);
  am_result_free(r);

  /* map_range begin/end bounds with real keys */
  for (int i = 0; i < 8; i++) {
    char k[8];
    snprintf(k, sizeof k, "m%d", i);
    CHECK_OK(am_map_put_int(d, AM_ROOT, k, i));
  }
  CHECK_OK(am_commit(d, NULL));
  r = am_map_range(d, AM_ROOT, "m2", "m6");
  CHECK(am_result_size(r) == 8); /* m2..m5: 4 entries x (key, value) */
  CHECK(strcmp(am_item_str(r, 0), "m2") == 0);
  am_result_free(r);
  am_doc_free(d);
}

int main(void) {
  if (am_init() != 0) {
    fprintf(stderr, "am_init failed\n");
    return 1;
  }
  test_cursor_matrix();
  test_range_reads();
  test_incremental_save_apply_matrix();
  test_change_exchange_accessors();
  test_sync_state_persistence();
  test_error_paths();
  test_deep_history_reads();
  test_three_peer_counter_convergence();
  test_unicode_text();
  test_fast_path_edges();
  test_throughput_probe();
  test_get_all_at_conflict_history();
  test_deep_nesting();
  test_clone_vs_fork_actors();
  test_many_keys_ordering();
  test_diff_between_heads();
  test_rollback_vs_sync();
  am_shutdown();
  return am_test_finish("test_ported3");
}
