/* Minimal assertion harness for the C ABI test programs (no cmocka in
 * this image). Each CHECK counts; a failure prints location + expression
 * and the program exits 1 at the end of main via am_test_finish(). */
#ifndef AM_TEST_UTIL_H
#define AM_TEST_UTIL_H

#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#include "am.h"

static int am_checks = 0;
static int am_failures = 0;

#define CHECK(cond)                                                        \
  do {                                                                     \
    am_checks++;                                                           \
    if (!(cond)) {                                                         \
      am_failures++;                                                       \
      fprintf(stderr, "CHECK failed at %s:%d: %s\n", __FILE__, __LINE__,   \
              #cond);                                                      \
    }                                                                      \
  } while (0)

/* Result helpers: assert OK (printing the error if not) and free. */
static int res_ok(AMresult *r) {
  int ok = r && am_result_status(r) == AM_STATUS_OK;
  if (!ok && r)
    fprintf(stderr, "  result error: %s\n", am_result_error(r));
  return ok;
}

#define CHECK_OK(r)                                                        \
  do {                                                                     \
    AMresult *_r = (r);                                                    \
    CHECK(res_ok(_r));                                                     \
    am_result_free(_r);                                                    \
  } while (0)

/* One-item accessors that free the result. */
static int64_t res_int(AMresult *r) {
  int64_t v = res_ok(r) && am_result_size(r) > 0 ? am_item_int(r, 0) : -999999;
  am_result_free(r);
  return v;
}

static double res_f64(AMresult *r) {
  double v = res_ok(r) && am_result_size(r) > 0 ? am_item_f64(r, 0) : -1e300;
  am_result_free(r);
  return v;
}

/* Copies the first item's string into buf (NUL-terminated). */
static const char *res_str(AMresult *r, char *buf, size_t cap) {
  buf[0] = '\0';
  if (res_ok(r) && am_result_size(r) > 0) {
    strncpy(buf, am_item_str(r, 0), cap - 1);
    buf[cap - 1] = '\0';
  }
  am_result_free(r);
  return buf;
}

/* Copies the first item's bytes; returns the length. */
static size_t res_bytes(AMresult *r, uint8_t *buf, size_t cap) {
  size_t n = 0;
  if (res_ok(r) && am_result_size(r) > 0) {
    size_t len = 0;
    const uint8_t *p = am_item_bytes(r, 0, &len);
    n = len < cap ? len : cap;
    if (p) memcpy(buf, p, n);
  }
  am_result_free(r);
  return n;
}

/* Concatenate every BYTES item (the heads-blob convention); returns the
 * number of items copied. */
static size_t res_heads(AMresult *r, uint8_t *blob, size_t max_heads) {
  size_t n = 0;
  if (res_ok(r)) {
    size_t count = am_result_size(r);
    for (size_t i = 0; i < count && n < max_heads; i++) {
      size_t len = 0;
      const uint8_t *p = am_item_bytes(r, i, &len);
      if (p && len == 32) memcpy(blob + 32 * n++, p, 32);
    }
  }
  am_result_free(r);
  return n;
}

static int am_test_finish(const char *name) {
  if (am_failures) {
    fprintf(stderr, "%s: %d/%d assertions FAILED\n", name, am_failures,
            am_checks);
    return 1;
  }
  printf("%s: all assertions passed (%d)\n", name, am_checks);
  return 0;
}

#endif /* AM_TEST_UTIL_H */
