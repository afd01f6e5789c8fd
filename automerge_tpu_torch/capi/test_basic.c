/* Basic-suite scenarios ported from the reference's wasm/C test corpus
 * (behavioral port of rust/automerge-c/test/ported_wasm/basic_tests.c,
 * re-expressed against this framework's am.h; no code copied) plus the
 * round-3 surface: historical reads, fork_at, the full list scalar
 * matrix, patches, map entries / list items, object types.
 */
#include <stdio.h>
#include <string.h>

#include "am.h"
#include "test_util.h"

static char sbuf[4096];
static uint8_t bbuf[1 << 20];
static uint8_t heads1[32 * 64], heads2[32 * 64];

/* -- create / clone / free ------------------------------------------------ */
static void test_create_fork_free(void) {
  uint8_t actor[2] = {0xAA, 0xBB};
  AMdoc *d = am_create(actor, 2);
  CHECK(d != NULL);
  AMresult *r = am_actor_id(d);
  CHECK(res_ok(r) && am_result_size(r) == 1);
  size_t len = 0;
  const uint8_t *p = am_item_bytes(r, 0, &len);
  CHECK(len == 2 && p[0] == 0xAA && p[1] == 0xBB);
  am_result_free(r);
  AMdoc *f = am_fork(d, NULL, 0);
  CHECK(f != NULL);
  am_doc_free(f);
  am_doc_free(d);
}

/* -- start and commit ----------------------------------------------------- */
static void test_start_and_commit(void) {
  AMdoc *d = am_create(NULL, 0);
  CHECK_OK(am_map_put_int(d, AM_ROOT, "n", 1));
  AMresult *r = am_commit(d, "first");
  CHECK(res_ok(r) && am_result_size(r) == 1);
  am_result_free(r);
  CHECK(res_heads(am_get_heads(d), heads1, 64) == 1);
  am_doc_free(d);
}

/* -- getting a nonexistent prop does not error ---------------------------- */
static void test_nonexistent_prop(void) {
  AMdoc *d = am_create(NULL, 0);
  AMresult *r = am_map_get(d, AM_ROOT, "missing");
  CHECK(res_ok(r) && am_result_size(r) == 0);
  am_result_free(r);
  am_doc_free(d);
}

/* -- set and get the whole scalar matrix on a map ------------------------- */
static void test_simple_values(void) {
  AMdoc *d = am_create(NULL, 0);
  CHECK_OK(am_map_put_null(d, AM_ROOT, "nul"));
  CHECK_OK(am_map_put_bool(d, AM_ROOT, "yes", 1));
  CHECK_OK(am_map_put_bool(d, AM_ROOT, "no", 0));
  CHECK_OK(am_map_put_int(d, AM_ROOT, "int", -42));
  CHECK_OK(am_map_put_uint(d, AM_ROOT, "uint", 42));
  CHECK_OK(am_map_put_f64(d, AM_ROOT, "pi", 3.5));
  CHECK_OK(am_map_put_str(d, AM_ROOT, "s", "hello"));
  CHECK_OK(am_map_put_counter(d, AM_ROOT, "c", 10));
  CHECK_OK(am_map_put_timestamp(d, AM_ROOT, "t", 1234567890));

  AMresult *r = am_map_get(d, AM_ROOT, "nul");
  CHECK(res_ok(r) && am_item_type(r, 0) == AM_VAL_NULL);
  am_result_free(r);
  r = am_map_get(d, AM_ROOT, "yes");
  CHECK(res_ok(r) && am_item_type(r, 0) == AM_VAL_BOOL && am_item_int(r, 0) == 1);
  am_result_free(r);
  r = am_map_get(d, AM_ROOT, "no");
  CHECK(res_ok(r) && am_item_int(r, 0) == 0);
  am_result_free(r);
  CHECK(res_int(am_map_get(d, AM_ROOT, "int")) == -42);
  CHECK(res_int(am_map_get(d, AM_ROOT, "uint")) == 42);
  CHECK(res_f64(am_map_get(d, AM_ROOT, "pi")) == 3.5);
  CHECK(strcmp(res_str(am_map_get(d, AM_ROOT, "s"), sbuf, sizeof sbuf),
               "hello") == 0);
  r = am_map_get(d, AM_ROOT, "c");
  CHECK(res_ok(r) && am_item_type(r, 0) == AM_VAL_COUNTER && am_item_int(r, 0) == 10);
  am_result_free(r);
  r = am_map_get(d, AM_ROOT, "t");
  CHECK(res_ok(r) && am_item_type(r, 0) == AM_VAL_TIMESTAMP &&
        am_item_int(r, 0) == 1234567890);
  am_result_free(r);
  am_doc_free(d);
}

/* -- bytes round-trip ------------------------------------------------------ */
static void test_bytes(void) {
  AMdoc *d = am_create(NULL, 0);
  const uint8_t data[5] = {0, 1, 2, 255, 128};
  CHECK_OK(am_map_put_bytes(d, AM_ROOT, "b", data, 5));
  AMresult *r = am_map_get(d, AM_ROOT, "b");
  CHECK(res_ok(r) && am_item_type(r, 0) == AM_VAL_BYTES);
  size_t len = 0;
  const uint8_t *p = am_item_bytes(r, 0, &len);
  CHECK(len == 5 && memcmp(p, data, 5) == 0);
  am_result_free(r);
  am_doc_free(d);
}

/* -- subobjects ------------------------------------------------------------ */
static void test_subobjects(void) {
  AMdoc *d = am_create(NULL, 0);
  AMresult *r = am_map_put_object(d, AM_ROOT, "cfg", AM_OBJ_MAP);
  CHECK(res_ok(r) && am_item_type(r, 0) == AM_VAL_OBJ_ID);
  char cfg[128];
  strncpy(cfg, am_item_str(r, 0), sizeof cfg - 1);
  am_result_free(r);
  CHECK_OK(am_map_put_bool(d, cfg, "logging", 1));
  r = am_map_get(d, cfg, "logging");
  CHECK(res_ok(r) && am_item_int(r, 0) == 1);
  am_result_free(r);
  CHECK(res_int(am_object_type(d, cfg)) == AM_OBJ_MAP);
  /* overwriting the key makes the old object unreachable */
  CHECK_OK(am_map_put_int(d, AM_ROOT, "cfg", 7));
  CHECK(res_int(am_map_get(d, AM_ROOT, "cfg")) == 7);
  am_doc_free(d);
}

/* -- lists: the whole verb x scalar matrix --------------------------------- */
static void test_lists(void) {
  AMdoc *d = am_create(NULL, 0);
  AMresult *r = am_map_put_object(d, AM_ROOT, "l", AM_OBJ_LIST);
  char l[128];
  strncpy(l, am_item_str(r, 0), sizeof l - 1);
  am_result_free(r);
  CHECK(res_int(am_object_type(d, l)) == AM_OBJ_LIST);

  CHECK_OK(am_list_insert_int(d, l, 0, 1));
  CHECK_OK(am_list_insert_str(d, l, 1, "two"));
  CHECK_OK(am_list_insert_bool(d, l, 2, 1));
  CHECK_OK(am_list_insert_uint(d, l, 3, 9));
  CHECK_OK(am_list_insert_f64(d, l, 4, 2.25));
  CHECK_OK(am_list_insert_null(d, l, 5));
  const uint8_t raw[3] = {9, 8, 7};
  CHECK_OK(am_list_insert_bytes(d, l, 6, raw, 3));
  /* NULL bytes = empty payload (review regression: must not store None) */
  CHECK_OK(am_list_insert_bytes(d, l, 6, NULL, 0));
  AMresult *eb = am_list_get(d, l, 6);
  size_t elen = 99;
  CHECK(res_ok(eb) && am_item_type(eb, 0) == AM_VAL_BYTES);
  am_item_bytes(eb, 0, &elen);
  CHECK(elen == 0);
  am_result_free(eb);
  CHECK_OK(am_list_delete(d, l, 6));
  CHECK_OK(am_list_insert_counter(d, l, 7, 5));
  CHECK_OK(am_list_insert_timestamp(d, l, 8, 999));
  CHECK(res_int(am_length(d, l)) == 9);

  CHECK(res_int(am_list_get(d, l, 0)) == 1);
  CHECK(strcmp(res_str(am_list_get(d, l, 1), sbuf, sizeof sbuf), "two") == 0);
  AMresult *g = am_list_get(d, l, 5);
  CHECK(res_ok(g) && am_item_type(g, 0) == AM_VAL_NULL);
  am_result_free(g);
  g = am_list_get(d, l, 6);
  size_t blen = 0;
  const uint8_t *bp = am_item_bytes(g, 0, &blen);
  CHECK(blen == 3 && bp[1] == 8);
  am_result_free(g);

  /* puts overwrite in place (no length change) */
  CHECK_OK(am_list_put_str(d, l, 0, "one"));
  CHECK_OK(am_list_put_bool(d, l, 2, 0));
  CHECK_OK(am_list_put_uint(d, l, 3, 10));
  CHECK_OK(am_list_put_f64(d, l, 4, 1.5));
  CHECK_OK(am_list_put_null(d, l, 5));
  const uint8_t raw2[2] = {1, 2};
  CHECK_OK(am_list_put_bytes(d, l, 6, raw2, 2));
  CHECK_OK(am_list_put_counter(d, l, 7, 100));
  CHECK_OK(am_list_put_timestamp(d, l, 8, 1000));
  CHECK_OK(am_list_put_int(d, l, 1, 22));
  CHECK(res_int(am_length(d, l)) == 9);
  CHECK(strcmp(res_str(am_list_get(d, l, 0), sbuf, sizeof sbuf), "one") == 0);
  CHECK(res_int(am_list_get(d, l, 1)) == 22);
  CHECK(res_f64(am_list_get(d, l, 4)) == 1.5);
  CHECK(res_int(am_list_get(d, l, 7)) == 100);

  /* item iteration covers every element */
  AMresult *items = am_list_items(d, l);
  CHECK(res_ok(items) && am_result_size(items) == 9);
  CHECK(am_item_type(items, 0) == AM_VAL_STR);
  CHECK(am_item_type(items, 7) == AM_VAL_COUNTER);
  am_result_free(items);

  /* delete shrinks */
  CHECK_OK(am_list_delete(d, l, 5));
  CHECK(res_int(am_length(d, l)) == 8);

  /* nested object via both verbs */
  r = am_list_insert_object(d, l, 0, AM_OBJ_MAP);
  CHECK(res_ok(r) && am_item_type(r, 0) == AM_VAL_OBJ_ID);
  char sub[128];
  strncpy(sub, am_item_str(r, 0), sizeof sub - 1);
  am_result_free(r);
  CHECK_OK(am_map_put_int(d, sub, "x", 1));
  r = am_list_put_object(d, l, 1, AM_OBJ_TEXT);
  CHECK(res_ok(r) && am_item_type(r, 0) == AM_VAL_OBJ_ID);
  char txt[128];
  strncpy(txt, am_item_str(r, 0), sizeof txt - 1);
  am_result_free(r);
  CHECK_OK(am_splice_text(d, txt, 0, 0, "in list"));
  CHECK(strcmp(res_str(am_text(d, txt), sbuf, sizeof sbuf), "in list") == 0);
  am_doc_free(d);
}

/* -- deleting (incl. nonexistent) ------------------------------------------ */
static void test_delete(void) {
  AMdoc *d = am_create(NULL, 0);
  CHECK_OK(am_map_put_str(d, AM_ROOT, "k", "v"));
  CHECK_OK(am_map_delete(d, AM_ROOT, "k"));
  AMresult *r = am_map_get(d, AM_ROOT, "k");
  CHECK(res_ok(r) && am_result_size(r) == 0);
  am_result_free(r);
  /* deleting a prop that does not exist is a silent no-op (reference:
   * transaction/inner.rs:422-423, ported_wasm delete_non_existent_props) */
  CHECK_OK(am_map_delete(d, AM_ROOT, "never"));
  am_doc_free(d);
}

/* -- counters -------------------------------------------------------------- */
static void test_counters(void) {
  AMdoc *d = am_create(NULL, 0);
  CHECK_OK(am_map_put_counter(d, AM_ROOT, "c", 10));
  CHECK_OK(am_map_increment(d, AM_ROOT, "c", 5));
  CHECK_OK(am_map_increment(d, AM_ROOT, "c", -3));
  CHECK(res_int(am_map_get(d, AM_ROOT, "c")) == 12);
  am_doc_free(d);
}

/* local increment bumps every visible (conflicting) counter — the merge
 * keeps both actors' counters under one key and increments hit all */
static void test_inc_increments_all_visible_counters(void) {
  uint8_t a1[1] = {1}, a2[1] = {2};
  AMdoc *d1 = am_create(a1, 1);
  CHECK_OK(am_commit(d1, NULL));
  AMdoc *d2 = am_fork(d1, a2, 1);
  CHECK_OK(am_map_put_counter(d1, AM_ROOT, "n", 10));
  CHECK_OK(am_commit(d1, NULL));
  CHECK_OK(am_map_put_counter(d2, AM_ROOT, "n", 100));
  CHECK_OK(am_commit(d2, NULL));
  CHECK_OK(am_merge(d1, d2));
  AMresult *all = am_map_get_all(d1, AM_ROOT, "n");
  CHECK(res_ok(all) && am_result_size(all) == 2);
  am_result_free(all);
  CHECK_OK(am_map_increment(d1, AM_ROOT, "n", 1));
  all = am_map_get_all(d1, AM_ROOT, "n");
  CHECK(res_ok(all) && am_result_size(all) == 2);
  CHECK(am_item_int(all, 0) + am_item_int(all, 1) == 10 + 100 + 2);
  am_result_free(all);
  am_doc_free(d2);
  am_doc_free(d1);
}

/* -- text splices ----------------------------------------------------------- */
static void test_splice_text(void) {
  AMdoc *d = am_create(NULL, 0);
  AMresult *r = am_map_put_object(d, AM_ROOT, "text", AM_OBJ_TEXT);
  char t[128];
  strncpy(t, am_item_str(r, 0), sizeof t - 1);
  am_result_free(r);
  CHECK_OK(am_splice_text(d, t, 0, 0, "hello world"));
  CHECK_OK(am_splice_text(d, t, 6, 5, "there"));
  CHECK(strcmp(res_str(am_text(d, t), sbuf, sizeof sbuf), "hello there") == 0);
  CHECK(res_int(am_length(d, t)) == 11);
  /* out-of-bounds errors, does not abort */
  r = am_splice_text(d, t, 999, 0, "x");
  CHECK(am_result_status(r) == AM_STATUS_ERROR);
  am_result_free(r);
  am_doc_free(d);
}

/* -- save all / incrementally ---------------------------------------------- */
static void test_save_all_or_incrementally(void) {
  AMdoc *d = am_create(NULL, 0);
  CHECK_OK(am_map_put_int(d, AM_ROOT, "a", 1));
  CHECK_OK(am_commit(d, NULL));
  size_t n1 = res_heads(am_get_heads(d), heads1, 64);
  CHECK(n1 == 1);
  CHECK_OK(am_map_put_int(d, AM_ROOT, "b", 2));
  CHECK_OK(am_commit(d, NULL));

  /* incremental after the first head = just the second change */
  AMresult *inc = am_save_incremental(d, heads1, n1);
  CHECK(res_ok(inc));
  size_t inc_len = 0;
  const uint8_t *inc_p = am_item_bytes(inc, 0, &inc_len);
  CHECK(inc_len > 0);

  /* a fork at the first head + the incremental bytes = the full doc */
  AMdoc *early = am_fork_at(d, heads1, n1, NULL, 0);
  CHECK(early != NULL);
  AMresult *probe = am_map_get(early, AM_ROOT, "b");
  CHECK(res_ok(probe) && am_result_size(probe) == 0);
  am_result_free(probe);
  CHECK_OK(am_apply_changes(early, inc_p, inc_len));
  am_result_free(inc);
  CHECK(res_int(am_map_get(early, AM_ROOT, "b")) == 2);
  am_doc_free(early);

  /* full save loads back */
  size_t n = res_bytes(am_save(d), bbuf, sizeof bbuf);
  CHECK(n > 0);
  AMdoc *l = am_load(bbuf, n);
  CHECK(l != NULL);
  CHECK(res_int(am_map_get(l, AM_ROOT, "a")) == 1);
  CHECK(res_int(am_map_get(l, AM_ROOT, "b")) == 2);
  am_doc_free(l);
  am_doc_free(d);
}

/* -- fetch changes by heads ------------------------------------------------- */
static void test_fetch_changes(void) {
  AMdoc *d = am_create(NULL, 0);
  CHECK_OK(am_map_put_int(d, AM_ROOT, "a", 1));
  CHECK_OK(am_commit(d, NULL));
  size_t n1 = res_heads(am_get_heads(d), heads1, 64);
  CHECK_OK(am_map_put_int(d, AM_ROOT, "b", 2));
  CHECK_OK(am_commit(d, NULL));
  AMresult *all = am_get_changes(d, NULL, 0);
  CHECK(res_ok(all) && am_result_size(all) == 2);
  am_result_free(all);
  AMresult *tail = am_get_changes(d, heads1, n1);
  CHECK(res_ok(tail) && am_result_size(tail) == 1);
  am_result_free(tail);
  am_doc_free(d);
}

/* -- recursive sets --------------------------------------------------------- */
static void test_recursive_sets(void) {
  AMdoc *d = am_create(NULL, 0);
  AMresult *r = am_map_put_object(d, AM_ROOT, "l", AM_OBJ_LIST);
  char l[128];
  strncpy(l, am_item_str(r, 0), sizeof l - 1);
  am_result_free(r);
  r = am_list_insert_object(d, l, 0, AM_OBJ_MAP);
  char m[128];
  strncpy(m, am_item_str(r, 0), sizeof m - 1);
  am_result_free(r);
  CHECK_OK(am_map_put_str(d, m, "name", "deep"));
  r = am_map_put_object(d, m, "inner", AM_OBJ_LIST);
  char il[128];
  strncpy(il, am_item_str(r, 0), sizeof il - 1);
  am_result_free(r);
  CHECK_OK(am_list_insert_int(d, il, 0, 7));
  CHECK(res_int(am_list_get(d, il, 0)) == 7);
  CHECK(strcmp(res_str(am_map_get(d, m, "name"), sbuf, sizeof sbuf), "deep") == 0);
  /* map entries pair key + value items */
  AMresult *ents = am_map_entries(d, m);
  CHECK(res_ok(ents) && am_result_size(ents) == 4);
  CHECK(am_item_type(ents, 0) == AM_VAL_STR);
  am_result_free(ents);
  am_doc_free(d);
}

/* -- objects without properties are preserved across save/load -------------- */
static void test_empty_objects_preserved(void) {
  AMdoc *d = am_create(NULL, 0);
  AMresult *r = am_map_put_object(d, AM_ROOT, "empty", AM_OBJ_MAP);
  am_result_free(r);
  CHECK_OK(am_commit(d, NULL));
  size_t n = res_bytes(am_save(d), bbuf, sizeof bbuf);
  AMdoc *l = am_load(bbuf, n);
  AMresult *g = am_map_get(l, AM_ROOT, "empty");
  CHECK(res_ok(g) && am_item_type(g, 0) == AM_VAL_OBJ_ID);
  am_result_free(g);
  am_doc_free(l);
  am_doc_free(d);
}

/* -- fork_at heads + historical reads --------------------------------------- */
static void test_fork_at_and_historical_reads(void) {
  AMdoc *d = am_create(NULL, 0);
  AMresult *r = am_map_put_object(d, AM_ROOT, "t", AM_OBJ_TEXT);
  char t[128];
  strncpy(t, am_item_str(r, 0), sizeof t - 1);
  am_result_free(r);
  CHECK_OK(am_splice_text(d, t, 0, 0, "version one"));
  CHECK_OK(am_map_put_int(d, AM_ROOT, "v", 1));
  CHECK_OK(am_commit(d, NULL));
  size_t n1 = res_heads(am_get_heads(d), heads1, 64);

  CHECK_OK(am_splice_text(d, t, 8, 3, "two"));
  CHECK_OK(am_map_put_int(d, AM_ROOT, "v", 2));
  CHECK_OK(am_map_put_str(d, AM_ROOT, "extra", "x"));
  CHECK_OK(am_commit(d, NULL));

  /* current reads see v2 */
  CHECK(res_int(am_map_get(d, AM_ROOT, "v")) == 2);
  CHECK(strcmp(res_str(am_text(d, t), sbuf, sizeof sbuf), "version two") == 0);

  /* *_at reads pin the first commit */
  CHECK(res_int(am_map_get_at(d, AM_ROOT, "v", heads1, n1)) == 1);
  CHECK(strcmp(res_str(am_text_at(d, t, heads1, n1), sbuf, sizeof sbuf),
               "version one") == 0);
  CHECK(res_int(am_length_at(d, t, heads1, n1)) == 11);
  AMresult *k = am_keys_at(d, AM_ROOT, heads1, n1);
  CHECK(res_ok(k) && am_result_size(k) == 2); /* t, v — no "extra" yet */
  am_result_free(k);
  AMresult *ga = am_map_get_all_at(d, AM_ROOT, "v", heads1, n1);
  CHECK(res_ok(ga) && am_result_size(ga) == 1 && am_item_int(ga, 0) == 1);
  am_result_free(ga);

  /* fork_at reproduces the historical doc exactly */
  AMdoc *old = am_fork_at(d, heads1, n1, NULL, 0);
  CHECK(old != NULL);
  CHECK(res_int(am_map_get(old, AM_ROOT, "v")) == 1);
  CHECK(strcmp(res_str(am_text(old, t), sbuf, sizeof sbuf), "version one") == 0);
  size_t nf = res_heads(am_get_heads(old), heads2, 64);
  CHECK(nf == n1 && memcmp(heads1, heads2, 32 * n1) == 0);
  am_doc_free(old);
  am_doc_free(d);
}

/* -- merging text conflicts then saving and loading ------------------------- */
static void test_merge_text_conflicts_save_load(void) {
  uint8_t a1[1] = {1}, a2[1] = {2};
  AMdoc *d1 = am_create(a1, 1);
  AMresult *r = am_map_put_object(d1, AM_ROOT, "t", AM_OBJ_TEXT);
  char t[128];
  strncpy(t, am_item_str(r, 0), sizeof t - 1);
  am_result_free(r);
  CHECK_OK(am_splice_text(d1, t, 0, 0, "base"));
  CHECK_OK(am_commit(d1, NULL));
  AMdoc *d2 = am_fork(d1, a2, 1);
  CHECK_OK(am_splice_text(d1, t, 4, 0, " one"));
  CHECK_OK(am_commit(d1, NULL));
  CHECK_OK(am_splice_text(d2, t, 4, 0, " two"));
  CHECK_OK(am_commit(d2, NULL));
  CHECK_OK(am_merge(d1, d2));
  CHECK_OK(am_merge(d2, d1));
  char t1[64], t2[64];
  res_str(am_text(d1, t), t1, sizeof t1);
  res_str(am_text(d2, t), t2, sizeof t2);
  CHECK(strcmp(t1, t2) == 0);
  size_t n = res_bytes(am_save(d1), bbuf, sizeof bbuf);
  AMdoc *l = am_load(bbuf, n);
  res_str(am_text(l, t), t2, sizeof t2);
  CHECK(strcmp(t1, t2) == 0);
  am_doc_free(l);
  am_doc_free(d2);
  am_doc_free(d1);
}

/* -- conflicts surface through get_all -------------------------------------- */
static void test_conflicts(void) {
  uint8_t a1[1] = {1}, a2[1] = {9};
  AMdoc *d1 = am_create(a1, 1);
  CHECK_OK(am_map_put_str(d1, AM_ROOT, "k", "base"));
  CHECK_OK(am_commit(d1, NULL));
  AMdoc *d2 = am_fork(d1, a2, 1);
  CHECK_OK(am_map_put_str(d1, AM_ROOT, "k", "one"));
  CHECK_OK(am_commit(d1, NULL));
  CHECK_OK(am_map_put_str(d2, AM_ROOT, "k", "two"));
  CHECK_OK(am_commit(d2, NULL));
  CHECK_OK(am_merge(d1, d2));
  AMresult *all = am_map_get_all(d1, AM_ROOT, "k");
  CHECK(res_ok(all) && am_result_size(all) == 2);
  am_result_free(all);
  /* winner = higher actor id (lamport tie-break) */
  CHECK(strcmp(res_str(am_map_get(d1, AM_ROOT, "k"), sbuf, sizeof sbuf),
               "two") == 0);
  am_doc_free(d2);
  am_doc_free(d1);
}

/* -- marks ------------------------------------------------------------------ */
static void test_marks(void) {
  AMdoc *d = am_create(NULL, 0);
  AMresult *r = am_map_put_object(d, AM_ROOT, "t", AM_OBJ_TEXT);
  char t[128];
  strncpy(t, am_item_str(r, 0), sizeof t - 1);
  am_result_free(r);
  CHECK_OK(am_splice_text(d, t, 0, 0, "styled text"));
  CHECK_OK(am_mark_bool(d, t, 0, 6, "bold", 1, "after"));
  CHECK_OK(am_commit(d, NULL));
  size_t n1 = res_heads(am_get_heads(d), heads1, 64);
  AMresult *ms = am_marks(d, t);
  CHECK(res_ok(ms) && am_result_size(ms) == 4);
  CHECK(am_item_int(ms, 0) == 0 && am_item_int(ms, 1) == 6);
  CHECK(strcmp(am_item_str(ms, 2), "bold") == 0);
  am_result_free(ms);
  CHECK_OK(am_unmark(d, t, 0, 6, "bold"));
  ms = am_marks(d, t);
  CHECK(res_ok(ms) && am_result_size(ms) == 0);
  am_result_free(ms);
  /* the mark is still visible at the old heads */
  ms = am_marks_at(d, t, heads1, n1);
  CHECK(res_ok(ms) && am_result_size(ms) == 4);
  am_result_free(ms);
  am_doc_free(d);
}

/* -- cursors ---------------------------------------------------------------- */
static void test_cursors(void) {
  AMdoc *d = am_create(NULL, 0);
  AMresult *r = am_map_put_object(d, AM_ROOT, "t", AM_OBJ_TEXT);
  char t[128];
  strncpy(t, am_item_str(r, 0), sizeof t - 1);
  am_result_free(r);
  CHECK_OK(am_splice_text(d, t, 0, 0, "abcdef"));
  char cur[128];
  res_str(am_get_cursor(d, t, 3), cur, sizeof cur);
  CHECK(cur[0] != '\0');
  CHECK_OK(am_splice_text(d, t, 0, 0, "XY"));
  CHECK(res_int(am_get_cursor_position(d, t, cur)) == 5);
  am_doc_free(d);
}

/* -- patches: diff between heads + observer pops ---------------------------- */
static void test_patches(void) {
  AMdoc *d = am_create(NULL, 0);
  CHECK_OK(am_map_put_int(d, AM_ROOT, "a", 1));
  CHECK_OK(am_commit(d, NULL));
  size_t n1 = res_heads(am_get_heads(d), heads1, 64);
  CHECK_OK(am_map_put_str(d, AM_ROOT, "b", "hi"));
  CHECK_OK(am_map_delete(d, AM_ROOT, "a"));
  CHECK_OK(am_commit(d, NULL));
  size_t n2 = res_heads(am_get_heads(d), heads2, 64);

  AMresult *p = am_diff(d, heads1, n1, heads2, n2);
  CHECK(res_ok(p) && am_result_size(p) == 12); /* 2 patches x 6 items */
  /* record 1: del_map a ; record 2: put_map b (sorted by key) */
  CHECK(strcmp(am_item_str(p, 2), "del_map") == 0 ||
        strcmp(am_item_str(p, 2), "put_map") == 0);
  int found_put = 0, found_del = 0;
  for (size_t i = 0; i + 5 < am_result_size(p); i += 6) {
    const char *kind = am_item_str(p, i + 2);
    if (strcmp(kind, "put_map") == 0 && strcmp(am_item_str(p, i + 3), "b") == 0) {
      found_put = strcmp(am_item_str(p, i + 5), "hi") == 0;
    }
    if (strcmp(kind, "del_map") == 0 && strcmp(am_item_str(p, i + 3), "a") == 0)
      found_del = 1;
  }
  CHECK(found_put && found_del);
  am_result_free(p);

  /* observer pops: first activates, then drains per commit batch */
  CHECK_OK(am_pop_patches(d));
  CHECK_OK(am_map_put_int(d, AM_ROOT, "c", 3));
  CHECK_OK(am_commit(d, NULL));
  p = am_pop_patches(d);
  CHECK(res_ok(p) && am_result_size(p) == 6);
  CHECK(strcmp(am_item_str(p, 2), "put_map") == 0);
  CHECK(strcmp(am_item_str(p, 3), "c") == 0);
  CHECK(am_item_int(p, 5) == 3);
  am_result_free(p);
  /* nothing new -> empty pop */
  p = am_pop_patches(d);
  CHECK(res_ok(p) && am_result_size(p) == 0);
  am_result_free(p);
  am_doc_free(d);
}

/* -- splice_text with a list of seq patches (text diff) --------------------- */
static void test_text_diff_patches(void) {
  AMdoc *d = am_create(NULL, 0);
  AMresult *r = am_map_put_object(d, AM_ROOT, "t", AM_OBJ_TEXT);
  char t[128];
  strncpy(t, am_item_str(r, 0), sizeof t - 1);
  am_result_free(r);
  CHECK_OK(am_splice_text(d, t, 0, 0, "hello"));
  CHECK_OK(am_commit(d, NULL));
  size_t n1 = res_heads(am_get_heads(d), heads1, 64);
  CHECK_OK(am_splice_text(d, t, 5, 0, " world"));
  CHECK_OK(am_commit(d, NULL));
  size_t n2 = res_heads(am_get_heads(d), heads2, 64);
  AMresult *p = am_diff(d, heads1, n1, heads2, n2);
  CHECK(res_ok(p) && am_result_size(p) == 6);
  CHECK(strcmp(am_item_str(p, 2), "splice_text") == 0);
  CHECK(am_item_int(p, 4) == 5);
  CHECK(strcmp(am_item_str(p, 5), " world") == 0);
  am_result_free(p);
  am_doc_free(d);
}

/* -- clone / equality / actor id / rollback --------------------------------- */
static void test_clone_equal_actor_rollback(void) {
  uint8_t a1[1] = {1}, a2[1] = {2};
  AMdoc *d = am_create(a1, 1);
  CHECK_OK(am_map_put_int(d, AM_ROOT, "x", 1));
  CHECK_OK(am_commit(d, NULL));
  AMdoc *c = am_clone(d);
  CHECK(c != NULL);
  /* clone keeps the actor; fork mints/uses another */
  AMresult *r = am_actor_id(c);
  size_t len = 0;
  const uint8_t *p = am_item_bytes(r, 0, &len);
  CHECK(len == 1 && p[0] == 1);
  am_result_free(r);
  CHECK(res_int(am_equal(d, c)) == 1);
  CHECK_OK(am_set_actor_id(c, a2, 1));
  r = am_actor_id(c);
  p = am_item_bytes(r, 0, &len);
  CHECK(len == 1 && p[0] == 2);
  am_result_free(r);
  /* divergence flips equality; rollback discards pending ops */
  CHECK_OK(am_map_put_int(c, AM_ROOT, "y", 2));
  CHECK(res_int(am_pending_ops(c)) == 1);
  CHECK(res_int(am_rollback(c)) == 1);
  CHECK(res_int(am_pending_ops(c)) == 0);
  CHECK(res_int(am_equal(d, c)) == 1);
  CHECK_OK(am_map_put_int(c, AM_ROOT, "y", 2));
  CHECK_OK(am_commit(c, NULL));
  CHECK(res_int(am_equal(d, c)) == 0);
  am_doc_free(c);
  /* am_equal is HEADS equality (reference AMequal, doc.rs:42-44): two
   * docs converging to identical content via different histories are not
   * equal; am_equal_content compares the hydrated values instead */
  uint8_t a3[1] = {3};
  AMdoc *e = am_create(a3, 1);
  CHECK_OK(am_map_put_int(e, AM_ROOT, "x", 1));
  CHECK_OK(am_commit(e, NULL));
  CHECK(res_int(am_equal(d, e)) == 0);
  CHECK(res_int(am_equal_content(d, e)) == 1);
  am_doc_free(e);
  am_doc_free(d);
}

/* -- change-level history accessors ------------------------------------------ */
static void test_change_accessors(void) {
  uint8_t a1[1] = {1}, a2[1] = {2};
  AMdoc *d = am_create(a1, 1);
  CHECK_OK(am_map_put_int(d, AM_ROOT, "x", 1));
  CHECK_OK(am_commit(d, NULL));
  size_t n1 = res_heads(am_get_heads(d), heads1, 64);
  CHECK(n1 == 1);
  /* fetch the head change by hash; an unknown hash is empty, not an error */
  AMresult *r = am_get_change_by_hash(d, heads1);
  CHECK(res_ok(r) && am_result_size(r) == 1);
  am_result_free(r);
  uint8_t bogus[32] = {0};
  r = am_get_change_by_hash(d, bogus);
  CHECK(res_ok(r) && am_result_size(r) == 0);
  am_result_free(r);
  /* last local change commits pending ops and returns the chunk */
  CHECK_OK(am_map_put_int(d, AM_ROOT, "y", 2));
  r = am_get_last_local_change(d);
  CHECK(res_ok(r) && am_result_size(r) == 1);
  am_result_free(r);
  /* changes a stale fork would pull from us (the merge direction) */
  AMdoc *old = am_fork_at(d, heads1, n1, a2, 1);
  r = am_get_changes_added(old, d);
  CHECK(res_ok(r) && am_result_size(r) == 1);
  am_result_free(r);
  /* nothing missing when history is complete */
  r = am_get_missing_deps(d, NULL, 0);
  CHECK(res_ok(r) && am_result_size(r) == 0);
  am_result_free(r);
  am_doc_free(old);
  am_doc_free(d);
}

/* -- range reads + list splice ----------------------------------------------- */
static void test_ranges_and_splice(void) {
  AMdoc *d = am_create(NULL, 0);
  AMresult *r = am_map_put_object(d, AM_ROOT, "l", AM_OBJ_LIST);
  char l[128];
  strncpy(l, am_item_str(r, 0), sizeof l - 1);
  am_result_free(r);
  for (int i = 0; i < 8; i++) CHECK_OK(am_list_insert_int(d, l, (size_t)i, i * 10));
  r = am_list_range(d, l, 2, 5);
  CHECK(res_ok(r) && am_result_size(r) == 3);
  CHECK(am_item_int(r, 0) == 20 && am_item_int(r, 2) == 40);
  am_result_free(r);
  CHECK_OK(am_list_splice(d, l, 1, 3)); /* delete 3 at 1 */
  CHECK(res_int(am_length(d, l)) == 5);
  CHECK(res_int(am_list_get(d, l, 1)) == 40);
  CHECK_OK(am_map_put_int(d, AM_ROOT, "alpha", 1));
  CHECK_OK(am_map_put_int(d, AM_ROOT, "beta", 2));
  CHECK_OK(am_map_put_int(d, AM_ROOT, "gamma", 3));
  r = am_map_range(d, AM_ROOT, "alpha", "gamma");
  CHECK(res_ok(r) && am_result_size(r) == 4); /* alpha, beta x (key,value) */
  CHECK(strcmp(am_item_str(r, 0), "alpha") == 0 && am_item_int(r, 3) == 2);
  am_result_free(r);
  r = am_map_range(d, AM_ROOT, "beta", "");
  CHECK(res_ok(r) && am_result_size(r) == 6); /* beta, gamma, l */
  am_result_free(r);
  am_doc_free(d);
}

int main(void) {
  if (am_init() != 0) {
    fprintf(stderr, "am_init failed\n");
    return 2;
  }
  test_clone_equal_actor_rollback();
  test_change_accessors();
  test_ranges_and_splice();
  test_create_fork_free();
  test_start_and_commit();
  test_nonexistent_prop();
  test_simple_values();
  test_bytes();
  test_subobjects();
  test_lists();
  test_delete();
  test_counters();
  test_inc_increments_all_visible_counters();
  test_splice_text();
  test_save_all_or_incrementally();
  test_fetch_changes();
  test_recursive_sets();
  test_empty_objects_preserved();
  test_fork_at_and_historical_reads();
  test_merge_text_conflicts_save_load();
  test_conflicts();
  test_marks();
  test_cursors();
  test_patches();
  test_text_diff_patches();
  int rc = am_test_finish("test_basic");
  am_shutdown();
  return rc;
}
