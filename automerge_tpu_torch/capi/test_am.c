/* C-side exercise of the am.h ABI: create / edit / save / load / merge /
 * sync entirely through the shared library — the analogue of the
 * reference's cmocka suites (reference: automerge-c/test/doc_tests.c,
 * ported_wasm/basic_tests.c, sync_tests.c), with plain asserts.
 */
#include "am.h"

#include <assert.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

static AMresult *ok(AMresult *r) {
  if (am_result_status(r) != AM_STATUS_OK) {
    fprintf(stderr, "FAIL: %s\n", am_result_error(r));
    exit(1);
  }
  return r;
}

static void expect_error(AMresult *r, const char *what) {
  if (am_result_status(r) == AM_STATUS_OK) {
    fprintf(stderr, "FAIL: expected error from %s\n", what);
    exit(1);
  }
  assert(am_result_error(r) != NULL);
  am_result_free(r);
}

int main(void) {
  assert(am_init() == 0);

  uint8_t actor1[16], actor2[16];
  memset(actor1, 0x11, sizeof actor1);
  memset(actor2, 0x22, sizeof actor2);

  /* -- create + scalar puts + reads -- */
  AMdoc *doc1 = am_create(actor1, sizeof actor1);
  assert(doc1 != NULL);
  am_result_free(ok(am_map_put_str(doc1, AM_ROOT, "title", "hello c")));
  am_result_free(ok(am_map_put_int(doc1, AM_ROOT, "n", -42)));
  am_result_free(ok(am_map_put_uint(doc1, AM_ROOT, "u", 7)));
  am_result_free(ok(am_map_put_f64(doc1, AM_ROOT, "pi", 3.25)));
  am_result_free(ok(am_map_put_bool(doc1, AM_ROOT, "flag", 1)));
  am_result_free(ok(am_map_put_null(doc1, AM_ROOT, "nil")));
  am_result_free(ok(am_map_put_counter(doc1, AM_ROOT, "votes", 10)));
  am_result_free(ok(am_map_increment(doc1, AM_ROOT, "votes", 5)));
  uint8_t blob[3] = {1, 2, 3};
  am_result_free(ok(am_map_put_bytes(doc1, AM_ROOT, "blob", blob, 3)));

  AMresult *r = ok(am_map_get(doc1, AM_ROOT, "title"));
  assert(am_result_size(r) == 1);
  assert(am_item_type(r, 0) == AM_VAL_STR);
  assert(strcmp(am_item_str(r, 0), "hello c") == 0);
  am_result_free(r);

  r = ok(am_map_get(doc1, AM_ROOT, "n"));
  assert(am_item_type(r, 0) == AM_VAL_INT && am_item_int(r, 0) == -42);
  am_result_free(r);

  r = ok(am_map_get(doc1, AM_ROOT, "votes"));
  assert(am_item_type(r, 0) == AM_VAL_COUNTER && am_item_int(r, 0) == 15);
  am_result_free(r);

  r = ok(am_map_get(doc1, AM_ROOT, "pi"));
  assert(am_item_type(r, 0) == AM_VAL_F64 && am_item_f64(r, 0) == 3.25);
  am_result_free(r);

  r = ok(am_map_get(doc1, AM_ROOT, "blob"));
  size_t blen = 0;
  const uint8_t *b = am_item_bytes(r, 0, &blen);
  assert(am_item_type(r, 0) == AM_VAL_BYTES && blen == 3 && b[1] == 2);
  am_result_free(r);

  r = ok(am_keys(doc1, AM_ROOT));
  assert(am_result_size(r) == 8);
  am_result_free(r);

  /* -- text object -- */
  r = ok(am_map_put_object(doc1, AM_ROOT, "text", AM_OBJ_TEXT));
  assert(am_item_type(r, 0) == AM_VAL_OBJ_ID);
  char text_id[128];
  snprintf(text_id, sizeof text_id, "%s", am_item_str(r, 0));
  am_result_free(r);
  am_result_free(ok(am_splice_text(doc1, text_id, 0, 0, "hello world")));
  am_result_free(ok(am_splice_text(doc1, text_id, 5, 6, " c!")));
  r = ok(am_text(doc1, text_id));
  assert(strcmp(am_item_str(r, 0), "hello c!") == 0);
  am_result_free(r);
  r = ok(am_length(doc1, text_id));
  assert(am_item_int(r, 0) == 8);
  am_result_free(r);

  /* -- list object -- */
  r = ok(am_map_put_object(doc1, AM_ROOT, "list", AM_OBJ_LIST));
  char list_id[128];
  snprintf(list_id, sizeof list_id, "%s", am_item_str(r, 0));
  am_result_free(r);
  am_result_free(ok(am_list_insert_int(doc1, list_id, 0, 1)));
  am_result_free(ok(am_list_insert_str(doc1, list_id, 1, "two")));
  am_result_free(ok(am_list_insert_counter(doc1, list_id, 2, 100)));
  am_result_free(ok(am_list_increment(doc1, list_id, 2, 1)));
  am_result_free(ok(am_list_delete(doc1, list_id, 0)));
  r = ok(am_length(doc1, list_id));
  assert(am_item_int(r, 0) == 2);
  am_result_free(r);
  r = ok(am_list_get(doc1, list_id, 1));
  assert(am_item_type(r, 0) == AM_VAL_COUNTER && am_item_int(r, 0) == 101);
  am_result_free(r);

  /* -- commit / save / load -- */
  r = ok(am_commit(doc1, "from c"));
  assert(am_result_size(r) == 1 && am_item_type(r, 0) == AM_VAL_BYTES);
  am_result_free(r);
  r = ok(am_save(doc1));
  size_t saved_len = 0;
  const uint8_t *saved = am_item_bytes(r, 0, &saved_len);
  assert(saved_len > 0);
  AMdoc *loaded = am_load(saved, saved_len);
  assert(loaded != NULL);
  am_result_free(r);
  r = ok(am_text(loaded, text_id));
  assert(strcmp(am_item_str(r, 0), "hello c!") == 0);
  am_result_free(r);

  /* -- fork + concurrent edits + merge (both orders converge) -- */
  AMdoc *doc2 = am_fork(doc1, actor2, sizeof actor2);
  assert(doc2 != NULL);
  am_result_free(ok(am_splice_text(doc1, text_id, 0, 0, "1:")));
  am_result_free(ok(am_splice_text(doc2, text_id, 8, 0, " [2]")));
  am_result_free(ok(am_map_put_str(doc1, AM_ROOT, "who", "one")));
  am_result_free(ok(am_map_put_str(doc2, AM_ROOT, "who", "two")));
  AMdoc *m1 = am_fork(doc1, NULL, 0);
  AMdoc *m2 = am_fork(doc2, NULL, 0);
  am_result_free(ok(am_merge(m1, doc2)));
  am_result_free(ok(am_merge(m2, doc1)));
  AMresult *t1 = ok(am_text(m1, text_id));
  AMresult *t2 = ok(am_text(m2, text_id));
  assert(strcmp(am_item_str(t1, 0), am_item_str(t2, 0)) == 0);
  am_result_free(t1);
  am_result_free(t2);
  r = ok(am_map_get_all(m1, AM_ROOT, "who")); /* conflict: both values */
  assert(am_result_size(r) == 2);
  am_result_free(r);

  /* -- sync protocol over the ABI -- */
  AMdoc *peer = am_create(NULL, 0);
  AMsyncState *s1 = am_sync_state_new();
  AMsyncState *s2 = am_sync_state_new();
  assert(peer && s1 && s2);
  for (int round = 0; round < 32; round++) {
    AMresult *ma = ok(am_generate_sync_message(m1, s1));
    AMresult *mb = ok(am_generate_sync_message(peer, s2));
    int done = am_result_size(ma) == 0 && am_result_size(mb) == 0;
    if (am_result_size(ma)) {
      size_t len = 0;
      const uint8_t *msg = am_item_bytes(ma, 0, &len);
      am_result_free(ok(am_receive_sync_message(peer, s2, msg, len)));
    }
    if (am_result_size(mb)) {
      size_t len = 0;
      const uint8_t *msg = am_item_bytes(mb, 0, &len);
      am_result_free(ok(am_receive_sync_message(m1, s1, msg, len)));
    }
    am_result_free(ma);
    am_result_free(mb);
    if (done) break;
  }
  AMresult *h1 = ok(am_get_heads(m1));
  AMresult *h2 = ok(am_get_heads(peer));
  assert(am_result_size(h1) == am_result_size(h2));
  for (size_t i = 0; i < am_result_size(h1); i++) {
    size_t l1, l2;
    const uint8_t *x = am_item_bytes(h1, i, &l1);
    const uint8_t *y = am_item_bytes(h2, i, &l2);
    assert(l1 == 32 && l2 == 32 && memcmp(x, y, 32) == 0);
  }
  am_result_free(h1);
  am_result_free(h2);
  AMresult *pt = ok(am_text(peer, text_id));
  AMresult *mt = ok(am_text(m1, text_id));
  assert(strcmp(am_item_str(pt, 0), am_item_str(mt, 0)) == 0);
  am_result_free(pt);
  am_result_free(mt);

  /* -- marks + cursors (reference: automerge-c marks/cursor surface) -- */
  AMdoc *md = am_create(NULL, 0);
  assert(md != NULL);
  r = ok(am_map_put_object(md, AM_ROOT, "note", AM_OBJ_TEXT));
  char note_id[64];
  strncpy(note_id, am_item_str(r, 0), sizeof(note_id) - 1);
  note_id[sizeof(note_id) - 1] = 0;
  am_result_free(r);
  am_result_free(ok(am_splice_text(md, note_id, 0, 0, "mark me up")));
  am_result_free(ok(am_mark_bool(md, note_id, 0, 4, "bold", 1, "both")));
  am_result_free(ok(am_mark_str(md, note_id, 5, 7, "link", "https://x", "none")));
  r = ok(am_marks(md, note_id));
  assert(am_result_size(r) == 8); /* 2 marks x (start, end, name, value) */
  assert(am_item_int(r, 0) == 0 && am_item_int(r, 1) == 4);
  assert(strcmp(am_item_str(r, 2), "bold") == 0);
  assert(am_item_type(r, 3) == AM_VAL_BOOL && am_item_int(r, 3) == 1);
  assert(strcmp(am_item_str(r, 6), "link") == 0);
  assert(strcmp(am_item_str(r, 7), "https://x") == 0);
  am_result_free(r);
  am_result_free(ok(am_unmark(md, note_id, 0, 4, "bold")));
  r = ok(am_marks(md, note_id));
  assert(am_result_size(r) == 4); /* only the link span remains */
  am_result_free(r);
  /* NULL value = null mark (clears the name over the span) */
  am_result_free(ok(am_mark_str(md, note_id, 5, 7, "link", NULL, "none")));
  r = ok(am_marks(md, note_id));
  assert(am_result_size(r) == 0);
  am_result_free(r);
  expect_error(am_mark_bool(md, note_id, 0, 2, "b", 1, "sideways"),
               "invalid expand policy");
  r = ok(am_get_cursor(md, note_id, 5));
  char cursor[64];
  strncpy(cursor, am_item_str(r, 0), sizeof(cursor) - 1);
  cursor[sizeof(cursor) - 1] = 0;
  am_result_free(r);
  am_result_free(ok(am_splice_text(md, note_id, 0, 0, ">> ")));
  r = ok(am_get_cursor_position(md, note_id, cursor));
  assert(am_item_int(r, 0) == 8); /* cursor tracked the insertion */
  am_result_free(r);

  /* -- incremental history exchange -- */
  am_result_free(ok(am_commit(md, NULL)));
  AMresult *heads0 = ok(am_get_heads(md));
  size_t nh = am_result_size(heads0);
  uint8_t heads_blob[8 * 32];
  assert(nh <= 8);
  for (size_t i = 0; i < nh; i++) {
    size_t hl;
    const uint8_t *hb = am_item_bytes(heads0, i, &hl);
    assert(hl == 32);
    memcpy(heads_blob + i * 32, hb, 32);
  }
  am_result_free(heads0);
  AMdoc *mirror = am_create(NULL, 0);
  r = ok(am_save(md));
  {
    size_t sl;
    const uint8_t *sb = am_item_bytes(r, 0, &sl);
    am_result_free(ok(am_apply_changes(mirror, sb, sl)));
  }
  am_result_free(r);
  am_result_free(ok(am_splice_text(md, note_id, 0, 0, "A")));
  am_result_free(ok(am_commit(md, NULL)));
  /* NULL heads = the full history */
  r = ok(am_save_incremental(md, NULL, 0));
  {
    size_t fl;
    am_item_bytes(r, 0, &fl);
    assert(fl > 0);
  }
  am_result_free(r);
  r = ok(am_save_incremental(md, heads_blob, nh));
  {
    size_t il;
    const uint8_t *ib = am_item_bytes(r, 0, &il);
    assert(il > 0);
    am_result_free(ok(am_apply_changes(mirror, ib, il)));
  }
  am_result_free(r);
  AMresult *mdt = ok(am_text(md, note_id));
  AMresult *mrt = ok(am_text(mirror, note_id));
  assert(strcmp(am_item_str(mdt, 0), am_item_str(mrt, 0)) == 0);
  am_result_free(mdt);
  am_result_free(mrt);
  am_doc_free(mirror);
  am_doc_free(md);

  /* -- error paths -- */
  expect_error(am_map_get(doc1, "7@deadbeef", "x"), "get on unknown object");
  expect_error(am_map_increment(doc1, AM_ROOT, "title", 1),
               "increment of a non-counter");
  assert(am_load((const uint8_t *)"garbage", 7) == NULL);

  am_sync_state_free(s1);
  am_sync_state_free(s2);
  am_doc_free(peer);
  am_doc_free(m1);
  am_doc_free(m2);
  am_doc_free(doc2);
  am_doc_free(loaded);
  am_doc_free(doc1);
  am_shutdown();
  printf("capi: all assertions passed\n");
  return 0;
}
