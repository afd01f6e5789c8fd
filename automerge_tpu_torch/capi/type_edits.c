/* Types an edit file into a new document through am.h alone: splices
 * through am_splice_text and puts through am_map_put_*, so a run of them
 * goes through the library's hot-call cache, with am_commit every EVERY
 * records and once at the end.
 *
 *   type_edits EDITS EVERY OUT.automerge [ACTOR_HEX]
 *
 * writes the document's am_save bytes to OUT.automerge and prints one line
 * per record that failed ("record N: <error>"), then the records' count,
 * the seconds of am_init (the embedded interpreter's start and imports),
 * of the typing and of the first am_text (on the card, a process's first
 * CUDA work: the context, the kernels' library and the merge), and the
 * text's length. Built with
 * -DAM_TYPE_EDITS_NO_MAIN as a shared library, type_edits() does the
 * typing for a caller in the same process.
 *
 * The edit file is a run of little-endian records:
 *   u8 0 (splice), u32 pos, u32 ndel, u32 n, n bytes of text (UTF-8)
 *   u8 1 (put), u8 AMvalType, u32 n, n bytes of key, then the value:
 *     INT/UINT/COUNTER/TIMESTAMP/BOOL: i64; F64: f64; STR/BYTES: u32 n and
 *     n bytes; NULL: nothing
 * The document's root holds "text" (a text object), made in a first
 * commit, and "map" (a map), made at the first put.
 */
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <time.h>

#include "am.h"

typedef struct {
  const uint8_t *p, *end;
} Reader;

static double since(const struct timespec *t0) {
  struct timespec t1;
  clock_gettime(CLOCK_MONOTONIC, &t1);
  return (double)(t1.tv_sec - t0->tv_sec) + 1e-9 * (t1.tv_nsec - t0->tv_nsec);
}

static int rd(Reader *r, void *out, size_t n) {
  if ((size_t)(r->end - r->p) < n) return 0;
  memcpy(out, r->p, n);
  r->p += n;
  return 1;
}

static uint8_t *read_file(const char *path, size_t *len) {
  FILE *f = fopen(path, "rb");
  if (!f) return NULL;
  fseek(f, 0, SEEK_END);
  long n = ftell(f);
  fseek(f, 0, SEEK_SET);
  uint8_t *buf = (uint8_t *)malloc(n > 0 ? (size_t)n : 1);
  if (buf && fread(buf, 1, (size_t)n, f) != (size_t)n) {
    free(buf);
    buf = NULL;
  }
  fclose(f);
  *len = (size_t)n;
  return buf;
}

/* a NUL-terminated copy of n bytes */
static char *cstr(const uint8_t *p, size_t n) {
  char *s = (char *)malloc(n + 1);
  memcpy(s, p, n);
  s[n] = '\0';
  return s;
}

static AMresult *put(AMdoc *d, const char *map, const char *key, uint8_t tag,
                     Reader *r) {
  int64_t i = 0;
  double f = 0.0;
  uint32_t n = 0;
  switch (tag) {
    case AM_VAL_NULL:
      return am_map_put_null(d, map, key);
    case AM_VAL_F64:
      rd(r, &f, 8);
      return am_map_put_f64(d, map, key, f);
    case AM_VAL_STR:
    case AM_VAL_BYTES: {
      rd(r, &n, 4);
      const uint8_t *v = r->p;
      r->p += n;
      if (tag == AM_VAL_BYTES) return am_map_put_bytes(d, map, key, v, n);
      char *s = cstr(v, n);
      AMresult *res = am_map_put_str(d, map, key, s);
      free(s);
      return res;
    }
    default:
      rd(r, &i, 8);
      if (tag == AM_VAL_BOOL) return am_map_put_bool(d, map, key, (int)i);
      if (tag == AM_VAL_UINT) return am_map_put_uint(d, map, key, (uint64_t)i);
      if (tag == AM_VAL_COUNTER) return am_map_put_counter(d, map, key, i);
      if (tag == AM_VAL_TIMESTAMP) return am_map_put_timestamp(d, map, key, i);
      return am_map_put_int(d, map, key, i);
  }
}

/* The object id of a new root entry `key` of type t, into out (64 bytes). */
static int make_object(AMdoc *d, const char *key, AMobjType t, char *out) {
  AMresult *r = am_map_put_object(d, AM_ROOT, key, t);
  int ok = am_result_status(r) == AM_STATUS_OK && am_result_size(r) == 1;
  if (ok) snprintf(out, 64, "%s", am_item_str(r, 0));
  am_result_free(r);
  return ok;
}

/* Types the file at `path` into a new document of actor `actor` (16
 * bytes). Fills text_obj (64 bytes) with the text object's id, *seconds
 * with the typing loop's seconds and *records with the records typed;
 * writes "record N: <error>" lines to `errors` (NULL: stdout). Returns the
 * document, or NULL when the file or the document cannot be made. */
AMdoc *type_edits(const char *path, long every, const uint8_t *actor,
                  const char *errors, char *text_obj, double *seconds,
                  long *records) {
  size_t len = 0;
  uint8_t *buf = read_file(path, &len);
  if (!buf || am_init() != 0) {
    free(buf);
    return NULL;
  }
  FILE *err = errors ? fopen(errors, "w") : stdout;
  AMdoc *d = am_create(actor, 16);
  char map[64] = "";
  if (!err || !d || !make_object(d, "text", AM_OBJ_TEXT, text_obj)) {
    if (err && err != stdout) fclose(err);
    if (d) am_doc_free(d);
    free(buf);
    return NULL;
  }
  am_result_free(am_commit(d, NULL));
  Reader r = {buf, buf + len};
  long k = 0;
  struct timespec t0;
  clock_gettime(CLOCK_MONOTONIC, &t0);
  for (uint8_t kind; rd(&r, &kind, 1); k++) {
    AMresult *res;
    if (kind == 0) {
      uint32_t a[3];
      rd(&r, a, 12);
      char *text = cstr(r.p, a[2]);
      r.p += a[2];
      res = am_splice_text(d, text_obj, a[0], a[1], text);
      free(text);
    } else {
      uint8_t tag;
      uint32_t n;
      rd(&r, &tag, 1);
      rd(&r, &n, 4);
      char *key = cstr(r.p, n);
      r.p += n;
      /* a map that cannot be made leaves map empty: the put then fails */
      if (!map[0]) make_object(d, "map", AM_OBJ_MAP, map);
      res = put(d, map, key, tag, &r);
      free(key);
    }
    if (am_result_status(res) != AM_STATUS_OK)
      fprintf(err, "record %ld: %s\n", k, am_result_error(res));
    am_result_free(res);
    if (every > 0 && k % every == every - 1)
      am_result_free(am_commit(d, NULL));
  }
  am_result_free(am_commit(d, NULL));
  *seconds = since(&t0);
  *records = k;
  if (err != stdout) fclose(err);
  free(buf);
  return d;
}

#ifndef AM_TYPE_EDITS_NO_MAIN
int main(int argc, char **argv) {
  if (argc < 4) {
    fprintf(stderr, "usage: %s EDITS EVERY OUT.automerge [ACTOR_HEX]\n", argv[0]);
    return 2;
  }
  uint8_t actor[16];
  for (int i = 0; i < 16; i++) {
    unsigned v = 0x75;
    if (argc > 4 && strlen(argv[4]) == 32) sscanf(argv[4] + 2 * i, "%2x", &v);
    actor[i] = (uint8_t)v;
  }
  char text_obj[64];
  double seconds = 0.0;
  long records = 0;
  struct timespec t0;
  clock_gettime(CLOCK_MONOTONIC, &t0);
  if (am_init() != 0) {
    fprintf(stderr, "type_edits: am_init failed\n");
    return 1;
  }
  const double init_s = since(&t0);
  AMdoc *d = type_edits(argv[1], atol(argv[2]), actor, NULL, text_obj,
                        &seconds, &records);
  if (!d) {
    fprintf(stderr, "type_edits: cannot type %s\n", argv[1]);
    return 1;
  }
  clock_gettime(CLOCK_MONOTONIC, &t0);
  AMresult *text = am_text(d, text_obj);
  const double read_s = since(&t0);
  AMresult *saved = am_save(d);
  size_t n = 0;
  const uint8_t *bytes = am_item_bytes(saved, 0, &n);
  FILE *out = fopen(argv[3], "wb");
  int ok = am_result_status(text) == AM_STATUS_OK &&
           am_result_status(saved) == AM_STATUS_OK && out &&
           fwrite(bytes, 1, n, out) == n;
  if (out) fclose(out);
  printf("typed %ld records in %.6f s (am_init %.6f s, first am_text %.6f s), "
         "text %zu bytes, save %zu bytes\n",
         records, seconds, init_s, read_s, strlen(am_item_str(text, 0)), n);
  am_result_free(text);
  am_result_free(saved);
  am_doc_free(d);
  am_shutdown();
  return ok ? 0 : 1;
}
#endif
