/* C ABI implementation: embeds the Python runtime and dispatches every
 * call through automerge_tpu_torch.capi.shim.call(fn, *args), converting
 * the returned (tag, payload) tuples into AMresult items.
 *
 * The reference's C frontend wraps its Rust core the same way — a thin
 * marshalling layer over the real document engine (reference:
 * rust/automerge-c/src/doc.rs); here the engine is the PyTorch/CUDA
 * framework, reached through one embedded interpreter. Its documents live
 * on the device AUTOMERGE_TPU_TORCH_DEVICE names (the card when unset; see
 * shim.py).
 */
#include "am.h"

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Item {
  AMvalType type = AM_VAL_VOID;
  int64_t i = 0;
  double f = 0.0;
  std::string s;          // STR / OBJ_ID (NUL-terminated via c_str)
  std::vector<uint8_t> b; // BYTES
};

} // namespace

struct AMresult {
  AMstatus status = AM_STATUS_OK;
  std::string error;
  std::vector<Item> items;
};

struct AMdoc {
  int64_t handle;
};

struct AMsyncState {
  int64_t handle;
};

static PyObject *g_shim = nullptr; // the shim module (owned)

/* -- hot-call fast cache ----------------------------------------------------
 *
 * Per-op callers (am_splice_text / am_map_put_*) were interpreter-bound:
 * every call crossed into Python dispatch. The shim's fast_begin exposes
 * the SAME native session the Python hot paths use (core/transaction.py
 * fast_splice_fn / fast_put_fn) as raw handles; while armed, this layer
 * calls am_edit_splice / am_map_put directly — no GIL, no Python. The
 * safety contract: dispatch() is the single funnel for everything else,
 * and it resyncs Python's op-id accounting (shim.fast_sync) and disarms
 * BEFORE running any other function. kind -2 is the neg-cache: the object
 * proved ineligible, keep dispatching without re-probing per call. An
 * error raised while arming (shim.fast_addrs / fast_begin: no native
 * library, say) is never neg-cached: it is the call's result. */
typedef int64_t (*am_edit_splice_fn)(void *, int64_t, int64_t, int64_t,
                                     const int32_t *, const int32_t *,
                                     int64_t);
typedef int64_t (*am_op_count_fn)(void *);
typedef int64_t (*am_map_put_fn)(void *, int64_t, const char *, int64_t,
                                 int32_t, int64_t, double, const uint8_t *,
                                 int64_t);

static struct {
  int64_t handle = 0;    /* doc handle (0 = inactive) */
  std::string obj;
  int kind = -1;         /* 0 text, 1 map, -2 neg-cached, -1 inactive */
  int neg = 0;           /* per-kind neg bits: 1<<kind proved ineligible */
  void *sess = nullptr;
  int64_t base = 0;      /* next ctr = base + op_count(sess) */
  int64_t enc = 0;       /* 0 codepoints, 1 utf-8 units, 2 utf-16 units */
} g_fast;
static am_edit_splice_fn g_f_splice = nullptr;
static am_op_count_fn g_f_splice_count = nullptr;
static am_map_put_fn g_f_map_put = nullptr;
static am_op_count_fn g_f_map_count = nullptr;

static AMresult *dispatch(const char *fn, PyObject *args);
static int64_t g_sync_pending = 0; /* handle whose resync failed (OOM) */

static bool fast_sync_dispatch(long long h) {
  PyGILState_STATE gil = PyGILState_Ensure();
  PyObject *args = Py_BuildValue("(L)", h);
  PyGILState_Release(gil);
  if (!args) return false;
  AMresult *r = dispatch("fast_sync", args);
  const bool ok = r->status == AM_STATUS_OK;
  am_result_free(r);
  return ok;
}

static void fast_disarm_sync(void) {
  if (g_fast.kind != 0 && g_fast.kind != 1) return;
  const long long h = (long long)g_fast.handle;
  g_fast.kind = -1;
  g_fast.handle = 0;
  g_fast.sess = nullptr;
  /* the resync is a hard invariant (op-id accounting); if it cannot run
   * now (OOM building the args tuple), dispatch() retries it before the
   * next operation and refuses to proceed until it lands */
  if (!fast_sync_dispatch(h)) g_sync_pending = h;
}

/* Strict UTF-8: reject what CPython would (stray/overlong leads,
 * surrogates, > U+10FFFF) so the fast path never accepts bytes the
 * dispatch path errors on. Appends to cps/ws when given (enc selects the
 * width unit); pure validation otherwise. */
static bool utf8_next(const char *s, size_t n, size_t *i, uint32_t *out,
                      int *blen) {
  const uint8_t c = (uint8_t)s[*i];
  if (c < 0x80) {
    *out = c;
    *blen = 1;
    (*i)++;
    return true;
  }
  int len;
  uint32_t cp;
  uint8_t lo = 0x80, hi = 0xBF;
  if (c >= 0xC2 && c <= 0xDF) {
    len = 2;
    cp = c & 0x1F;
  } else if (c == 0xE0) {
    len = 3;
    cp = 0;
    lo = 0xA0;
  } else if (c >= 0xE1 && c <= 0xEC) {
    len = 3;
    cp = c & 0x0F;
  } else if (c == 0xED) {
    len = 3;
    cp = 0x0D;
    hi = 0x9F; /* no surrogates */
  } else if (c >= 0xEE && c <= 0xEF) {
    len = 3;
    cp = c & 0x0F;
  } else if (c == 0xF0) {
    len = 4;
    cp = 0;
    lo = 0x90;
  } else if (c >= 0xF1 && c <= 0xF3) {
    len = 4;
    cp = c & 0x07;
  } else if (c == 0xF4) {
    len = 4;
    cp = 4;
    hi = 0x8F; /* <= U+10FFFF */
  } else {
    return false; /* 0x80-0xC1, 0xF5-0xFF */
  }
  if (*i + (size_t)len > n) return false;
  for (int k = 1; k < len; k++) {
    const uint8_t cc = (uint8_t)s[*i + k];
    const uint8_t l = k == 1 ? lo : 0x80, h = k == 1 ? hi : 0xBF;
    if (cc < l || cc > h) return false;
    cp = (cp << 6) | (cc & 0x3F);
  }
  *i += (size_t)len;
  *out = cp;
  *blen = len;
  return true;
}

static bool utf8_valid(const char *s, size_t n) {
  uint32_t cp;
  int blen;
  for (size_t i = 0; i < n;)
    if (!utf8_next(s, n, &i, &cp, &blen)) return false;
  return true;
}

extern "C" int am_init(void) {
  if (g_shim) return 0;
  bool we_initialized = false;
  if (!Py_IsInitialized()) {
    Py_InitializeEx(0);
    we_initialized = true;
  }
  PyGILState_STATE gil = PyGILState_Ensure();
  const char *root = getenv("AUTOMERGE_TPU_TORCH_PYROOT");
#ifdef AM_PYROOT
  if (!root) root = AM_PYROOT;
#endif
  if (root) {
    PyObject *sys_path = PySys_GetObject("path"); // borrowed
    PyObject *p = PyUnicode_FromString(root);
    if (sys_path && p) PyList_Insert(sys_path, 0, p);
    Py_XDECREF(p);
  }
  g_shim = PyImport_ImportModule("automerge_tpu_torch.capi.shim");
  if (!g_shim) {
    PyErr_Print();
    PyGILState_Release(gil);
    if (we_initialized) PyEval_SaveThread(); // never exit still holding the GIL
    return -1;
  }
  PyGILState_Release(gil);
  if (we_initialized) {
    // Py_InitializeEx leaves this thread holding the GIL; release it so
    // other threads' PyGILState_Ensure calls can ever succeed
    PyEval_SaveThread();
  }
  return 0;
}

extern "C" void am_shutdown(void) {
  if (!g_shim) return;
  PyGILState_STATE gil = PyGILState_Ensure();
  Py_CLEAR(g_shim);
  PyGILState_Release(gil);
  // the interpreter stays up: cheap, and safe for repeated init cycles
}

static std::string format_exception() {
  PyObject *type = nullptr, *value = nullptr, *tb = nullptr;
  PyErr_Fetch(&type, &value, &tb);
  PyErr_NormalizeException(&type, &value, &tb);
  std::string msg = "unknown error";
  if (value) {
    PyObject *s = PyObject_Str(value);
    if (s) {
      const char *c = PyUnicode_AsUTF8(s);
      if (c) msg = c;
      Py_DECREF(s);
    }
  }
  if (type) {
    PyObject *n = PyObject_GetAttrString(type, "__name__");
    if (n) {
      const char *c = PyUnicode_AsUTF8(n);
      if (c) msg = std::string(c) + ": " + msg;
      Py_DECREF(n);
    }
  }
  Py_XDECREF(type);
  Py_XDECREF(value);
  Py_XDECREF(tb);
  return msg;
}

/* Convert shim items [(tag, payload), ...] into the result. */
static bool convert_items(PyObject *list, AMresult *r) {
  PyObject *seq = PySequence_Fast(list, "shim must return a sequence");
  if (!seq) return false;
  Py_ssize_t n = PySequence_Fast_GET_SIZE(seq);
  for (Py_ssize_t i = 0; i < n; i++) {
    PyObject *t = PySequence_Fast_GET_ITEM(seq, i); // borrowed
    PyObject *tag_o = PyTuple_GetItem(t, 0);
    PyObject *val = PyTuple_GetItem(t, 1);
    if (!tag_o || !val) {
      Py_DECREF(seq);
      return false;
    }
    Item item;
    item.type = static_cast<AMvalType>(PyLong_AsLong(tag_o));
    switch (item.type) {
      case AM_VAL_F64:
        item.f = PyFloat_AsDouble(val);
        break;
      case AM_VAL_STR:
      case AM_VAL_OBJ_ID: {
        const char *c = PyUnicode_AsUTF8(val);
        if (!c) {
          Py_DECREF(seq);
          return false;
        }
        item.s = c;
        break;
      }
      case AM_VAL_BYTES: {
        char *buf = nullptr;
        Py_ssize_t len = 0;
        if (PyBytes_AsStringAndSize(val, &buf, &len) != 0) {
          Py_DECREF(seq);
          return false;
        }
        item.b.assign(buf, buf + len);
        break;
      }
      case AM_VAL_NULL:
      case AM_VAL_VOID:
        break;
      default: // ints, bools, counters, timestamps, handles
        item.i = PyLong_AsLongLong(val);
        break;
    }
    if (PyErr_Occurred()) {
      Py_DECREF(seq);
      return false;
    }
    r->items.push_back(std::move(item));
  }
  Py_DECREF(seq);
  return true;
}

/* Call shim.call(fn, *args); args is a NEW reference to a tuple (stolen). */
static AMresult *dispatch(const char *fn, PyObject *args) {
  /* the single funnel: resync + disarm the hot-call cache before any
   * other operation can mint op ids or change session state. The
   * neg-cache survives put/splice dispatches (value-shape fallbacks on
   * the same hot loop) but clears on anything that could change
   * eligibility (commit, merge, mark, load, ...). */
  if (fn[0] != 'f' || strncmp(fn, "fast_", 5) != 0) {
    if (g_fast.kind >= 0) fast_disarm_sync();
    if (g_fast.kind == -2 && strcmp(fn, "put") != 0 &&
        strcmp(fn, "splice_text") != 0) {
      g_fast.kind = -1;
      g_fast.neg = 0;
    }
    if (g_sync_pending) {
      if (fast_sync_dispatch((long long)g_sync_pending)) {
        g_sync_pending = 0;
      } else {
        AMresult *err = new AMresult();
        err->status = AM_STATUS_ERROR;
        err->error = "op-id accounting desynchronized (out of memory "
                     "during fast-path resync)";
        if (args) {
          PyGILState_STATE gil = PyGILState_Ensure();
          Py_DECREF(args);
          PyGILState_Release(gil);
        }
        return err;
      }
    }
  }
  AMresult *r = new AMresult();
  if (!g_shim) {
    Py_XDECREF(args);
    r->status = AM_STATUS_ERROR;
    r->error = "am_init() has not been called";
    return r;
  }
  PyGILState_STATE gil = PyGILState_Ensure();
  PyObject *out = nullptr;
  if (args) {
    PyObject *call = PyObject_GetAttrString(g_shim, "call");
    PyObject *fn_o = PyUnicode_FromString(fn);
    Py_ssize_t n = PyTuple_GET_SIZE(args);
    PyObject *full = PyTuple_New(n + 1);
    if (call && fn_o && full) {
      PyTuple_SET_ITEM(full, 0, fn_o); // stolen
      fn_o = nullptr;
      for (Py_ssize_t i = 0; i < n; i++) {
        PyObject *it = PyTuple_GET_ITEM(args, i);
        Py_INCREF(it);
        PyTuple_SET_ITEM(full, i + 1, it);
      }
      out = PyObject_CallObject(call, full);
    }
    Py_XDECREF(call);
    Py_XDECREF(fn_o);
    Py_XDECREF(full);
    Py_DECREF(args);
  } else {
    r->status = AM_STATUS_ERROR;
    r->error = g_shim ? "argument marshalling failed"
                      : "am_init() has not been called";
    if (g_shim && PyErr_Occurred()) PyErr_Clear();
  }
  if (out) {
    if (!convert_items(out, r)) {
      r->status = AM_STATUS_ERROR;
      r->error = format_exception();
      r->items.clear();
    }
    Py_DECREF(out);
  } else if (r->status == AM_STATUS_OK) {
    r->status = AM_STATUS_ERROR;
    r->error = format_exception();
  }
  PyGILState_Release(gil);
  return r;
}

/* -- hot-call cache: arming + direct entries -------------------------------*/

/* The native entry addresses; false without them, and then *err holds
 * the error shim.fast_addrs raised (nullptr: none, dispatch instead). */
static bool fast_fetch_addrs(AMresult **err) {
  if (g_f_map_put) return true;
  PyGILState_STATE gil = PyGILState_Ensure();
  PyObject *args = PyTuple_New(0);
  PyGILState_Release(gil);
  if (!args) return false;
  AMresult *r = dispatch("fast_addrs", args);
  if (r->status != AM_STATUS_OK) {
    *err = r;
    return false;
  }
  if (r->items.size() >= 4) {
    g_f_splice = (am_edit_splice_fn)(uintptr_t)r->items[0].i;
    g_f_splice_count = (am_op_count_fn)(uintptr_t)r->items[1].i;
    g_f_map_put = (am_map_put_fn)(uintptr_t)r->items[2].i;
    g_f_map_count = (am_op_count_fn)(uintptr_t)r->items[3].i;
  }
  am_result_free(r);
  return g_f_map_put != nullptr;
}

/* Arm the cache for (doc, obj, kind); on an eligible session returns true.
 * An ineligible object neg-caches so per-call re-probing stops; an error
 * raised while arming leaves the cache inactive and comes back in *err. */
static bool fast_arm(AMdoc *d, const char *obj, int kind, AMresult **err) {
  if (!fast_fetch_addrs(err)) return false;
  PyGILState_STATE gil = PyGILState_Ensure();
  PyObject *args = Py_BuildValue("(Lsi)", (long long)d->handle, obj, kind);
  PyGILState_Release(gil);
  if (!args) return false;
  AMresult *r = dispatch("fast_begin", args);
  if (r->status != AM_STATUS_OK) {
    g_fast.kind = -1;
    g_fast.handle = 0;
    g_fast.neg = 0;
    g_fast.sess = nullptr;
    *err = r;
    return false;
  }
  const bool ok = r->items.size() >= 3 && r->items[0].i != 0;
  if (g_fast.handle != d->handle || g_fast.obj != obj) g_fast.neg = 0;
  g_fast.handle = d->handle;
  g_fast.obj = obj;
  if (ok) {
    g_fast.kind = kind;
    g_fast.sess = (void *)(uintptr_t)r->items[0].i;
    g_fast.base = r->items[1].i;
    g_fast.enc = r->items[2].i;
  } else {
    /* per-kind neg-cache; a text-ineligible object can still arm the
     * map fast path & v.v. */
    g_fast.kind = -2;
    g_fast.neg |= 1 << kind;
    g_fast.sess = nullptr;
  }
  am_result_free(r);
  return ok;
}

/* Armed text splice: utf-8 -> codepoints + per-codepoint widths in the
 * document's index unit, then one native call. nullptr = fall back to the
 * dispatch path (malformed utf-8). */
static AMresult *fast_splice_armed(const char *text, size_t pos, size_t del) {
  const size_t n = text ? strlen(text) : 0;
  std::vector<int32_t> cps, ws;
  cps.reserve(n);
  ws.reserve(n);
  for (size_t i = 0; i < n;) {
    uint32_t c;
    int blen;
    if (!utf8_next(text, n, &i, &c, &blen))
      return nullptr; /* invalid utf-8: dispatch path reports the error */
    const int32_t w =
        g_fast.enc == 1 ? blen : (g_fast.enc == 2 ? 1 + (c > 0xFFFF) : 1);
    cps.push_back((int32_t)c);
    ws.push_back(w);
  }
  const int64_t ctr = g_fast.base + g_f_splice_count(g_fast.sess);
  const int64_t rr = g_f_splice(g_fast.sess, ctr, (int64_t)pos, (int64_t)del,
                                cps.data(), ws.data(), (int64_t)cps.size());
  AMresult *r = new AMresult();
  if (rr < 0) {
    r->status = AM_STATUS_ERROR;
    r->error = rr == -2 ? "splice: delete past end of sequence"
                        : "splice: index out of bounds";
  }
  return r;
}

/* Armed (or arm-now) check shared by the splice and map-put entries:
 * true = g_fast holds a live session for (doc, obj, kind); false with
 * *err set = arming raised, and that error is the call's result. */
static bool fast_ready(AMdoc *d, const char *o, int kind, AMresult **err) {
  if (g_fast.handle == d->handle && g_fast.obj == o) {
    if (g_fast.kind == kind) return true;
    if (g_fast.kind == -2 && (g_fast.neg & (1 << kind))) return false;
  }
  fast_disarm_sync();
  return fast_arm(d, o, kind, err);
}

/* Armed map put; nullptr = use the dispatch path (ineligible object,
 * empty/invalid key, or a value shape the session rejects). An error
 * raised while arming is returned as the put's result. */
static AMresult *fast_map_put_try(AMdoc *d, const char *o, const char *k,
                                  int32_t code, int64_t ival, double fval,
                                  const uint8_t *raw, int64_t rawlen) {
  if (!g_shim || !d || !o || !k || !k[0]) return nullptr;
  const size_t klen = strlen(k);
  if (!utf8_valid(k, klen)) return nullptr;
  if (code == 6 && !utf8_valid((const char *)raw, (size_t)rawlen))
    return nullptr; /* invalid utf-8 value: dispatch path reports */
  AMresult *err = nullptr;
  if (!fast_ready(d, o, 1, &err)) return err;
  const int64_t ctr = g_fast.base + g_f_map_count(g_fast.sess);
  const int64_t rr = g_f_map_put(g_fast.sess, ctr, k, (int64_t)klen, code,
                                 ival, fval, raw, rawlen);
  if (rr < 0) {
    fast_disarm_sync();
    return nullptr;
  }
  return new AMresult();
}

/* -- results / items -------------------------------------------------------*/

extern "C" AMstatus am_result_status(const AMresult *r) { return r->status; }

extern "C" const char *am_result_error(const AMresult *r) {
  return r->status == AM_STATUS_OK ? nullptr : r->error.c_str();
}

extern "C" size_t am_result_size(const AMresult *r) { return r->items.size(); }

extern "C" AMvalType am_item_type(const AMresult *r, size_t i) {
  return i < r->items.size() ? r->items[i].type : AM_VAL_VOID;
}

extern "C" int64_t am_item_int(const AMresult *r, size_t i) {
  return i < r->items.size() ? r->items[i].i : 0;
}

extern "C" double am_item_f64(const AMresult *r, size_t i) {
  return i < r->items.size() ? r->items[i].f : 0.0;
}

extern "C" const char *am_item_str(const AMresult *r, size_t i) {
  return i < r->items.size() ? r->items[i].s.c_str() : "";
}

extern "C" const uint8_t *am_item_bytes(const AMresult *r, size_t i, size_t *len) {
  if (i >= r->items.size()) {
    if (len) *len = 0;
    return nullptr;
  }
  if (len) *len = r->items[i].b.size();
  return r->items[i].b.data();
}

extern "C" void am_result_free(AMresult *r) { delete r; }

/* -- documents -------------------------------------------------------------*/

/* The document a call made, or NULL; am.h gives these calls no result to
 * carry an error in, so its text goes to stderr (no GPU and no device
 * setting, say) rather than nowhere. */
static AMdoc *handle_doc(AMresult *r, const char *fn) {
  AMdoc *doc = nullptr;
  if (r->status == AM_STATUS_OK && !r->items.empty()) {
    doc = new AMdoc{r->items[0].i};
  } else if (r->status != AM_STATUS_OK) {
    fprintf(stderr, "%s: %s\n", fn, r->error.c_str());
  }
  am_result_free(r);
  return doc;
}

extern "C" AMdoc *am_create(const uint8_t *actor, size_t actor_len) {
  if (!g_shim) return nullptr;
  PyGILState_STATE gil = PyGILState_Ensure();
  PyObject *args = Py_BuildValue("(y#)", (const char *)actor, (Py_ssize_t)actor_len);
  PyGILState_Release(gil);
  return handle_doc(dispatch("create", args), "am_create");
}

extern "C" AMdoc *am_load(const uint8_t *data, size_t len) {
  if (!g_shim) return nullptr;
  PyGILState_STATE gil = PyGILState_Ensure();
  PyObject *args = Py_BuildValue("(y#)", (const char *)data, (Py_ssize_t)len);
  PyGILState_Release(gil);
  return handle_doc(dispatch("load", args), "am_load");
}

extern "C" AMdoc *am_fork(AMdoc *doc, const uint8_t *actor, size_t actor_len) {
  if (!g_shim) return nullptr;
  PyGILState_STATE gil = PyGILState_Ensure();
  PyObject *args = Py_BuildValue("(Ly#)", (long long)doc->handle,
                                 (const char *)actor, (Py_ssize_t)actor_len);
  PyGILState_Release(gil);
  return handle_doc(dispatch("fork", args), "am_fork");
}

extern "C" void am_doc_free(AMdoc *doc) {
  if (!doc) return;
  if (!g_shim) { delete doc; return; }
  PyGILState_STATE gil = PyGILState_Ensure();
  PyObject *args = Py_BuildValue("(L)", (long long)doc->handle);
  PyGILState_Release(gil);
  am_result_free(dispatch("free", args));
  delete doc;
}

/* convenience: build args under the GIL, then dispatch */
/* build args under the GIL — but only once am_init has run; calling
 * PyGILState_Ensure on an uninitialized interpreter aborts the process,
 * so an un-initialized library must flow through dispatch's error path */
#define AM_ARGS(...)                                        \
  PyObject *args = nullptr;                                 \
  if (g_shim) {                                             \
    PyGILState_STATE gil = PyGILState_Ensure();             \
    args = Py_BuildValue(__VA_ARGS__);                      \
    PyGILState_Release(gil);                                \
  }

extern "C" AMresult *am_save(AMdoc *doc) {
  AM_ARGS("(L)", (long long)doc->handle);
  return dispatch("save", args);
}

extern "C" AMresult *am_commit(AMdoc *doc, const char *message) {
  AM_ARGS("(Ls)", (long long)doc->handle, message ? message : "");
  return dispatch("commit", args);
}

extern "C" AMresult *am_merge(AMdoc *doc, AMdoc *other) {
  AM_ARGS("(LL)", (long long)doc->handle, (long long)other->handle);
  return dispatch("merge", args);
}

extern "C" AMresult *am_get_heads(AMdoc *doc) {
  AM_ARGS("(L)", (long long)doc->handle);
  return dispatch("get_heads", args);
}

extern "C" AMresult *am_actor_id(AMdoc *doc) {
  AM_ARGS("(L)", (long long)doc->handle);
  return dispatch("actor_id", args);
}

/* -- map mutation ----------------------------------------------------------*/

static AMresult *put_tagged(AMdoc *doc, const char *obj, const char *key,
                            int tag, PyObject *payload /* stolen */) {
  if (!g_shim) return dispatch("put", nullptr);
  PyGILState_STATE gil = PyGILState_Ensure();
  PyObject *args = payload
      ? Py_BuildValue("(LssiN)", (long long)doc->handle, obj, key, tag, payload)
      : nullptr;
  PyGILState_Release(gil);
  return dispatch("put", args);
}

extern "C" AMresult *am_map_put_null(AMdoc *d, const char *o, const char *k) {
  if (!g_shim) return dispatch("put", nullptr);
  if (AMresult *fr = fast_map_put_try(d, o, k, 0, 0, 0.0, nullptr, 0)) return fr;
  PyGILState_STATE gil = PyGILState_Ensure();
  PyObject *zero = PyLong_FromLong(0);
  PyGILState_Release(gil);
  return put_tagged(d, o, k, AM_VAL_NULL, zero);
}

extern "C" AMresult *am_map_put_bool(AMdoc *d, const char *o, const char *k, int v) {
  if (!g_shim) return dispatch("put", nullptr);
  if (AMresult *fr = fast_map_put_try(d, o, k, v ? 2 : 1, 0, 0.0, nullptr, 0)) return fr;
  PyGILState_STATE gil = PyGILState_Ensure();
  PyObject *p = PyLong_FromLong(v ? 1 : 0);
  PyGILState_Release(gil);
  return put_tagged(d, o, k, AM_VAL_BOOL, p);
}

extern "C" AMresult *am_map_put_int(AMdoc *d, const char *o, const char *k, int64_t v) {
  if (!g_shim) return dispatch("put", nullptr);
  if (AMresult *fr = fast_map_put_try(d, o, k, 4, v, 0.0, nullptr, 0)) return fr;
  PyGILState_STATE gil = PyGILState_Ensure();
  PyObject *p = PyLong_FromLongLong(v);
  PyGILState_Release(gil);
  return put_tagged(d, o, k, AM_VAL_INT, p);
}

extern "C" AMresult *am_map_put_uint(AMdoc *d, const char *o, const char *k, uint64_t v) {
  if (!g_shim) return dispatch("put", nullptr);
  if (v <= (uint64_t)INT64_MAX)
    if (AMresult *fr = fast_map_put_try(d, o, k, 3, (int64_t)v, 0.0, nullptr, 0)) return fr;
  PyGILState_STATE gil = PyGILState_Ensure();
  PyObject *p = PyLong_FromUnsignedLongLong(v);
  PyGILState_Release(gil);
  return put_tagged(d, o, k, AM_VAL_UINT, p);
}

extern "C" AMresult *am_map_put_f64(AMdoc *d, const char *o, const char *k, double v) {
  if (!g_shim) return dispatch("put", nullptr);
  if (AMresult *fr = fast_map_put_try(d, o, k, 5, 0, v, nullptr, 0)) return fr;
  PyGILState_STATE gil = PyGILState_Ensure();
  PyObject *p = PyFloat_FromDouble(v);
  PyGILState_Release(gil);
  return put_tagged(d, o, k, AM_VAL_F64, p);
}

extern "C" AMresult *am_map_put_str(AMdoc *d, const char *o, const char *k,
                                    const char *v) {
  if (!g_shim) return dispatch("put", nullptr);
  if (AMresult *fr = fast_map_put_try(
          d, o, k, 6, 0, 0.0, (const uint8_t *)(v ? v : ""),
          (int64_t)strlen(v ? v : "")))
    return fr;
  PyGILState_STATE gil = PyGILState_Ensure();
  PyObject *p = PyUnicode_FromString(v ? v : "");
  PyGILState_Release(gil);
  return put_tagged(d, o, k, AM_VAL_STR, p);
}

extern "C" AMresult *am_map_put_bytes(AMdoc *d, const char *o, const char *k,
                                      const uint8_t *v, size_t len) {
  if (!g_shim) return dispatch("put", nullptr);
  if (v || len == 0)
    if (AMresult *fr = fast_map_put_try(d, o, k, 7, 0, 0.0, v, (int64_t)len))
      return fr;
  PyGILState_STATE gil = PyGILState_Ensure();
  PyObject *p = PyBytes_FromStringAndSize((const char *)v, (Py_ssize_t)len);
  PyGILState_Release(gil);
  return put_tagged(d, o, k, AM_VAL_BYTES, p);
}

extern "C" AMresult *am_map_put_counter(AMdoc *d, const char *o, const char *k,
                                        int64_t v) {
  if (!g_shim) return dispatch("put", nullptr);
  if (AMresult *fr = fast_map_put_try(d, o, k, 8, v, 0.0, nullptr, 0)) return fr;
  PyGILState_STATE gil = PyGILState_Ensure();
  PyObject *p = PyLong_FromLongLong(v);
  PyGILState_Release(gil);
  return put_tagged(d, o, k, AM_VAL_COUNTER, p);
}

extern "C" AMresult *am_map_put_timestamp(AMdoc *d, const char *o, const char *k,
                                          int64_t v) {
  if (!g_shim) return dispatch("put", nullptr);
  PyGILState_STATE gil = PyGILState_Ensure();
  PyObject *p = PyLong_FromLongLong(v);
  PyGILState_Release(gil);
  return put_tagged(d, o, k, AM_VAL_TIMESTAMP, p);
}

extern "C" AMresult *am_map_put_object(AMdoc *d, const char *o, const char *k,
                                       AMobjType t) {
  AM_ARGS("(Lssi)", (long long)d->handle, o, k, (int)t);
  return dispatch("put_object", args);
}

extern "C" AMresult *am_map_delete(AMdoc *d, const char *o, const char *k) {
  AM_ARGS("(Lss)", (long long)d->handle, o, k);
  return dispatch("delete", args);
}

extern "C" AMresult *am_map_increment(AMdoc *d, const char *o, const char *k,
                                      int64_t by) {
  AM_ARGS("(LssL)", (long long)d->handle, o, k, (long long)by);
  return dispatch("increment", args);
}

/* -- list mutation ---------------------------------------------------------*/

/* the full scalar matrix for both list verbs routes through ONE pair of
 * shim entries (list_put / insert) with a tag + payload, so each wrapper
 * is a marshalling one-liner — the reference needs a macro forest for the
 * same surface (automerge-c/src/doc/list.rs) */
#define AM_LIST_SCALAR(name, verb, tag, fmt, ...)                            \
  extern "C" AMresult *name {                                                \
    AM_ARGS("(Lsni" fmt ")", (long long)d->handle, o, (Py_ssize_t)i, tag,    \
            __VA_ARGS__);                                                    \
    return dispatch(verb, args);                                             \
  }

AM_LIST_SCALAR(am_list_put_null(AMdoc *d, const char *o, size_t i),
               "list_put", AM_VAL_NULL, "i", 0)
AM_LIST_SCALAR(am_list_put_bool(AMdoc *d, const char *o, size_t i, int v),
               "list_put", AM_VAL_BOOL, "i", v ? 1 : 0)
AM_LIST_SCALAR(am_list_put_int(AMdoc *d, const char *o, size_t i, int64_t v),
               "list_put", AM_VAL_INT, "L", (long long)v)
AM_LIST_SCALAR(am_list_put_uint(AMdoc *d, const char *o, size_t i, uint64_t v),
               "list_put", AM_VAL_UINT, "K", (unsigned long long)v)
AM_LIST_SCALAR(am_list_put_f64(AMdoc *d, const char *o, size_t i, double v),
               "list_put", AM_VAL_F64, "d", v)
AM_LIST_SCALAR(am_list_put_str(AMdoc *d, const char *o, size_t i, const char *v),
               "list_put", AM_VAL_STR, "s", v ? v : "")
/* NULL bytes marshal as an empty payload, never None (same hazard the
 * AM_HEADS macro guards) */
AM_LIST_SCALAR(am_list_put_bytes(AMdoc *d, const char *o, size_t i,
                                 const uint8_t *v, size_t len),
               "list_put", AM_VAL_BYTES, "y#", v ? (const char *)v : "",
               (Py_ssize_t)(v ? len : 0))
AM_LIST_SCALAR(am_list_put_counter(AMdoc *d, const char *o, size_t i, int64_t v),
               "list_put", AM_VAL_COUNTER, "L", (long long)v)
AM_LIST_SCALAR(am_list_put_timestamp(AMdoc *d, const char *o, size_t i, int64_t v),
               "list_put", AM_VAL_TIMESTAMP, "L", (long long)v)

AM_LIST_SCALAR(am_list_insert_null(AMdoc *d, const char *o, size_t i),
               "insert", AM_VAL_NULL, "i", 0)
AM_LIST_SCALAR(am_list_insert_bool(AMdoc *d, const char *o, size_t i, int v),
               "insert", AM_VAL_BOOL, "i", v ? 1 : 0)
AM_LIST_SCALAR(am_list_insert_int(AMdoc *d, const char *o, size_t i, int64_t v),
               "insert", AM_VAL_INT, "L", (long long)v)
AM_LIST_SCALAR(am_list_insert_uint(AMdoc *d, const char *o, size_t i, uint64_t v),
               "insert", AM_VAL_UINT, "K", (unsigned long long)v)
AM_LIST_SCALAR(am_list_insert_f64(AMdoc *d, const char *o, size_t i, double v),
               "insert", AM_VAL_F64, "d", v)
AM_LIST_SCALAR(am_list_insert_str(AMdoc *d, const char *o, size_t i, const char *v),
               "insert", AM_VAL_STR, "s", v ? v : "")
AM_LIST_SCALAR(am_list_insert_bytes(AMdoc *d, const char *o, size_t i,
                                    const uint8_t *v, size_t len),
               "insert", AM_VAL_BYTES, "y#", v ? (const char *)v : "",
               (Py_ssize_t)(v ? len : 0))
AM_LIST_SCALAR(am_list_insert_counter(AMdoc *d, const char *o, size_t i, int64_t v),
               "insert", AM_VAL_COUNTER, "L", (long long)v)
AM_LIST_SCALAR(am_list_insert_timestamp(AMdoc *d, const char *o, size_t i,
                                        int64_t v),
               "insert", AM_VAL_TIMESTAMP, "L", (long long)v)

extern "C" AMresult *am_list_put_object(AMdoc *d, const char *o, size_t i,
                                        AMobjType t) {
  AM_ARGS("(Lsni)", (long long)d->handle, o, (Py_ssize_t)i, (int)t);
  return dispatch("list_put_object", args);
}

extern "C" AMresult *am_list_insert_object(AMdoc *d, const char *o, size_t i,
                                           AMobjType t) {
  AM_ARGS("(Lsni)", (long long)d->handle, o, (Py_ssize_t)i, (int)t);
  return dispatch("insert_object", args);
}

extern "C" AMresult *am_list_delete(AMdoc *d, const char *o, size_t i) {
  AM_ARGS("(Lsn)", (long long)d->handle, o, (Py_ssize_t)i);
  return dispatch("list_delete", args);
}

extern "C" AMresult *am_list_increment(AMdoc *d, const char *o, size_t i, int64_t by) {
  AM_ARGS("(LsnL)", (long long)d->handle, o, (Py_ssize_t)i, (long long)by);
  return dispatch("list_increment", args);
}

/* -- text ------------------------------------------------------------------*/

extern "C" AMresult *am_splice_text(AMdoc *d, const char *o, size_t pos, size_t del,
                                    const char *text) {
  if (g_shim && d && o) {
    AMresult *err = nullptr;
    if (fast_ready(d, o, 0, &err)) {
      AMresult *fr = fast_splice_armed(text, pos, del);
      if (fr) return fr;
      fast_disarm_sync(); /* malformed utf-8: report via dispatch */
    } else if (err) {
      return err;
    }
  }
  AM_ARGS("(Lsnns)", (long long)d->handle, o, (Py_ssize_t)pos, (Py_ssize_t)del,
          text ? text : "");
  return dispatch("splice_text", args);
}

extern "C" AMresult *am_text(AMdoc *d, const char *o) {
  AM_ARGS("(Ls)", (long long)d->handle, o);
  return dispatch("text", args);
}

/* -- reads -----------------------------------------------------------------*/

extern "C" AMresult *am_map_get(AMdoc *d, const char *o, const char *k) {
  AM_ARGS("(Lss)", (long long)d->handle, o, k);
  return dispatch("get", args);
}

extern "C" AMresult *am_map_get_all(AMdoc *d, const char *o, const char *k) {
  AM_ARGS("(Lss)", (long long)d->handle, o, k);
  return dispatch("get_all", args);
}

extern "C" AMresult *am_list_get(AMdoc *d, const char *o, size_t i) {
  AM_ARGS("(Lsn)", (long long)d->handle, o, (Py_ssize_t)i);
  return dispatch("list_get", args);
}

extern "C" AMresult *am_keys(AMdoc *d, const char *o) {
  AM_ARGS("(Ls)", (long long)d->handle, o);
  return dispatch("keys", args);
}

extern "C" AMresult *am_length(AMdoc *d, const char *o) {
  AM_ARGS("(Ls)", (long long)d->handle, o);
  return dispatch("length", args);
}

extern "C" AMresult *am_object_type(AMdoc *d, const char *o) {
  AM_ARGS("(Ls)", (long long)d->handle, o);
  return dispatch("object_type", args);
}

extern "C" AMresult *am_list_items(AMdoc *d, const char *o) {
  AM_ARGS("(Ls)", (long long)d->handle, o);
  return dispatch("list_items", args);
}

extern "C" AMresult *am_map_entries(AMdoc *d, const char *o) {
  AM_ARGS("(Ls)", (long long)d->handle, o);
  return dispatch("map_entries", args);
}

/* -- historical reads ------------------------------------------------------*/

/* NULL heads = "no heads": marshal an empty byte string, never a NULL
 * pointer (Py_BuildValue "y#" would turn NULL into None) */
#define AM_HEADS(h, n)                                      \
  (const char *)((h) ? (const char *)(h) : ""),             \
      (Py_ssize_t)((h) ? (n) * 32 : 0)

extern "C" AMresult *am_map_get_at(AMdoc *d, const char *o, const char *k,
                                   const uint8_t *heads, size_t n_heads) {
  AM_ARGS("(Lssy#)", (long long)d->handle, o, k, AM_HEADS(heads, n_heads));
  return dispatch("get_at", args);
}

extern "C" AMresult *am_map_get_all_at(AMdoc *d, const char *o, const char *k,
                                       const uint8_t *heads, size_t n_heads) {
  AM_ARGS("(Lssy#)", (long long)d->handle, o, k, AM_HEADS(heads, n_heads));
  return dispatch("get_all_at", args);
}

extern "C" AMresult *am_list_get_at(AMdoc *d, const char *o, size_t i,
                                    const uint8_t *heads, size_t n_heads) {
  AM_ARGS("(Lsny#)", (long long)d->handle, o, (Py_ssize_t)i,
          AM_HEADS(heads, n_heads));
  return dispatch("list_get_at", args);
}

extern "C" AMresult *am_keys_at(AMdoc *d, const char *o, const uint8_t *heads,
                                size_t n_heads) {
  AM_ARGS("(Lsy#)", (long long)d->handle, o, AM_HEADS(heads, n_heads));
  return dispatch("keys_at", args);
}

extern "C" AMresult *am_length_at(AMdoc *d, const char *o, const uint8_t *heads,
                                  size_t n_heads) {
  AM_ARGS("(Lsy#)", (long long)d->handle, o, AM_HEADS(heads, n_heads));
  return dispatch("length_at", args);
}

extern "C" AMresult *am_text_at(AMdoc *d, const char *o, const uint8_t *heads,
                                size_t n_heads) {
  AM_ARGS("(Lsy#)", (long long)d->handle, o, AM_HEADS(heads, n_heads));
  return dispatch("text_at", args);
}

extern "C" AMresult *am_marks_at(AMdoc *d, const char *o, const uint8_t *heads,
                                 size_t n_heads) {
  AM_ARGS("(Lsy#)", (long long)d->handle, o, AM_HEADS(heads, n_heads));
  return dispatch("marks_at", args);
}

extern "C" AMdoc *am_fork_at(AMdoc *d, const uint8_t *heads, size_t n_heads,
                             const uint8_t *actor, size_t actor_len) {
  if (!g_shim) return nullptr;
  PyGILState_STATE gil = PyGILState_Ensure();
  PyObject *args = Py_BuildValue("(Ly#y#)", (long long)d->handle,
                                 AM_HEADS(heads, n_heads),
                                 (const char *)actor, (Py_ssize_t)actor_len);
  PyGILState_Release(gil);
  return handle_doc(dispatch("fork_at", args), "am_fork_at");
}

/* -- patches ---------------------------------------------------------------*/

extern "C" AMresult *am_diff(AMdoc *d, const uint8_t *before, size_t n_before,
                             const uint8_t *after, size_t n_after) {
  AM_ARGS("(Ly#y#)", (long long)d->handle, AM_HEADS(before, n_before),
          AM_HEADS(after, n_after));
  return dispatch("diff", args);
}

extern "C" AMresult *am_pop_patches(AMdoc *d) {
  AM_ARGS("(L)", (long long)d->handle);
  return dispatch("pop_patches", args);
}

extern "C" AMresult *am_get_changes(AMdoc *d, const uint8_t *heads,
                                    size_t n_heads) {
  AM_ARGS("(Ly#)", (long long)d->handle, AM_HEADS(heads, n_heads));
  return dispatch("get_changes", args);
}

/* -- round-3 breadth -------------------------------------------------------*/

extern "C" AMdoc *am_clone(AMdoc *d) {
  if (!g_shim) return nullptr;
  PyGILState_STATE gil = PyGILState_Ensure();
  PyObject *args = Py_BuildValue("(L)", (long long)d->handle);
  PyGILState_Release(gil);
  return handle_doc(dispatch("clone", args), "am_clone");
}

extern "C" AMresult *am_set_actor_id(AMdoc *d, const uint8_t *actor,
                                     size_t actor_len) {
  AM_ARGS("(Ly#)", (long long)d->handle, (const char *)actor,
          (Py_ssize_t)actor_len);
  return dispatch("set_actor", args);
}

extern "C" AMresult *am_equal(AMdoc *d, AMdoc *other) {
  AM_ARGS("(LL)", (long long)d->handle, (long long)other->handle);
  return dispatch("equal", args);
}

extern "C" AMresult *am_equal_content(AMdoc *d, AMdoc *other) {
  AM_ARGS("(LL)", (long long)d->handle, (long long)other->handle);
  return dispatch("equal_content", args);
}

extern "C" AMresult *am_pending_ops(AMdoc *d) {
  AM_ARGS("(L)", (long long)d->handle);
  return dispatch("pending_ops", args);
}

extern "C" AMresult *am_rollback(AMdoc *d) {
  AM_ARGS("(L)", (long long)d->handle);
  return dispatch("rollback", args);
}

extern "C" AMresult *am_get_change_by_hash(AMdoc *d, const uint8_t *hash) {
  /* NULL hash = empty payload (never dereferenced), same convention as
   * AM_HEADS; the shim answers with an empty result */
  AM_ARGS("(Ly#)", (long long)d->handle, hash ? (const char *)hash : "",
          (Py_ssize_t)(hash ? 32 : 0));
  return dispatch("get_change_by_hash", args);
}

extern "C" AMresult *am_get_changes_added(AMdoc *d, AMdoc *other) {
  AM_ARGS("(LL)", (long long)d->handle, (long long)other->handle);
  return dispatch("get_changes_added", args);
}

extern "C" AMresult *am_get_last_local_change(AMdoc *d) {
  AM_ARGS("(L)", (long long)d->handle);
  return dispatch("get_last_local_change", args);
}

extern "C" AMresult *am_get_missing_deps(AMdoc *d, const uint8_t *heads,
                                         size_t n_heads) {
  AM_ARGS("(Ly#)", (long long)d->handle, AM_HEADS(heads, n_heads));
  return dispatch("get_missing_deps", args);
}

extern "C" AMresult *am_list_range(AMdoc *d, const char *o, size_t start,
                                   size_t end) {
  // reference idiom: end = SIZE_MAX means unbounded (automerge-c
  // AMlistRange) — clamp before the size_t -> Py_ssize_t narrowing,
  // which would otherwise turn it into -1 and yield an empty range
  if (end > (size_t)PY_SSIZE_T_MAX) end = (size_t)PY_SSIZE_T_MAX;
  if (start > (size_t)PY_SSIZE_T_MAX) start = (size_t)PY_SSIZE_T_MAX;
  AM_ARGS("(Lsnn)", (long long)d->handle, o, (Py_ssize_t)start,
          (Py_ssize_t)end);
  return dispatch("list_range", args);
}

extern "C" AMresult *am_map_range(AMdoc *d, const char *o, const char *begin,
                                  const char *end) {
  AM_ARGS("(Lsss)", (long long)d->handle, o, begin ? begin : "",
          end ? end : "");
  return dispatch("map_range", args);
}

extern "C" AMresult *am_list_splice(AMdoc *d, const char *o, size_t pos,
                                    size_t del) {
  AM_ARGS("(Lsnn)", (long long)d->handle, o, (Py_ssize_t)pos, (Py_ssize_t)del);
  return dispatch("list_splice", args);
}

extern "C" AMresult *am_sync_state_shared_heads(AMsyncState *s) {
  AM_ARGS("(L)", (long long)s->handle);
  return dispatch("sync_state_shared_heads", args);
}

/* -- sync ------------------------------------------------------------------*/

extern "C" AMsyncState *am_sync_state_new(void) {
  if (!g_shim) return nullptr;
  PyGILState_STATE gil = PyGILState_Ensure();
  PyObject *empty = PyTuple_New(0);
  PyGILState_Release(gil);
  AMresult *r = dispatch("sync_state_new", empty);
  AMsyncState *s = nullptr;
  if (r->status == AM_STATUS_OK && !r->items.empty()) {
    s = new AMsyncState{r->items[0].i};
  }
  am_result_free(r);
  return s;
}

extern "C" void am_sync_state_free(AMsyncState *s) {
  if (!s) return;
  if (!g_shim) { delete s; return; }
  AM_ARGS("(L)", (long long)s->handle);
  am_result_free(dispatch("sync_state_free", args));
  delete s;
}

extern "C" AMresult *am_sync_state_encode(AMsyncState *s) {
  AM_ARGS("(L)", (long long)s->handle);
  return dispatch("sync_state_encode", args);
}

extern "C" AMsyncState *am_sync_state_decode(const uint8_t *data, size_t len) {
  if (!g_shim) return nullptr;
  PyGILState_STATE gil = PyGILState_Ensure();
  PyObject *args = Py_BuildValue("(y#)", (const char *)data, (Py_ssize_t)len);
  PyGILState_Release(gil);
  AMresult *r = dispatch("sync_state_decode", args);
  AMsyncState *s = nullptr;
  if (r->status == AM_STATUS_OK && !r->items.empty()) {
    s = new AMsyncState{r->items[0].i};
  }
  am_result_free(r);
  return s;
}

/* -- marks / cursors -------------------------------------------------------*/

extern "C" AMresult *am_mark_str(AMdoc *d, const char *o, size_t start, size_t end,
                                 const char *name, const char *value,
                                 const char *expand) {
  if (value == NULL) {
    /* a NULL value means a null-valued mark: clears the name (Peritext) */
    AM_ARGS("(Lsnnss)", (long long)d->handle, o, (Py_ssize_t)start,
            (Py_ssize_t)end, name, expand ? expand : "after");
    return dispatch("mark_null", args);
  }
  AM_ARGS("(Lsnnsss)", (long long)d->handle, o, (Py_ssize_t)start,
          (Py_ssize_t)end, name, value, expand ? expand : "after");
  return dispatch("mark_str", args);
}

extern "C" AMresult *am_mark_bool(AMdoc *d, const char *o, size_t start, size_t end,
                                  const char *name, int value,
                                  const char *expand) {
  AM_ARGS("(Lsnnsis)", (long long)d->handle, o, (Py_ssize_t)start,
          (Py_ssize_t)end, name, value, expand ? expand : "after");
  return dispatch("mark_bool", args);
}

extern "C" AMresult *am_unmark(AMdoc *d, const char *o, size_t start, size_t end,
                               const char *name) {
  AM_ARGS("(Lsnns)", (long long)d->handle, o, (Py_ssize_t)start,
          (Py_ssize_t)end, name);
  return dispatch("unmark", args);
}

extern "C" AMresult *am_marks(AMdoc *d, const char *o) {
  AM_ARGS("(Ls)", (long long)d->handle, o);
  return dispatch("marks", args);
}

extern "C" AMresult *am_get_cursor(AMdoc *d, const char *o, size_t pos) {
  AM_ARGS("(Lsn)", (long long)d->handle, o, (Py_ssize_t)pos);
  return dispatch("get_cursor", args);
}

extern "C" AMresult *am_get_cursor_position(AMdoc *d, const char *o,
                                            const char *cursor) {
  AM_ARGS("(Lss)", (long long)d->handle, o, cursor);
  return dispatch("get_cursor_position", args);
}

/* -- history exchange ------------------------------------------------------*/

extern "C" AMresult *am_apply_changes(AMdoc *d, const uint8_t *data, size_t len) {
  AM_ARGS("(Ly#)", (long long)d->handle, (const char *)data, (Py_ssize_t)len);
  return dispatch("apply_change_bytes", args);
}

extern "C" AMresult *am_save_incremental(AMdoc *d, const uint8_t *heads,
                                         size_t n_heads) {
  /* NULL/0 means "everything": full change history */
  static const uint8_t empty[1] = {0};
  const uint8_t *p = (heads && n_heads) ? heads : empty;
  size_t len = heads ? n_heads * 32 : 0;
  AM_ARGS("(Ly#)", (long long)d->handle, (const char *)p, (Py_ssize_t)len);
  return dispatch("save_incremental", args);
}

extern "C" AMresult *am_generate_sync_message(AMdoc *d, AMsyncState *s) {
  AM_ARGS("(LL)", (long long)d->handle, (long long)s->handle);
  return dispatch("generate_sync_message", args);
}

extern "C" AMresult *am_receive_sync_message(AMdoc *d, AMsyncState *s,
                                             const uint8_t *msg, size_t len) {
  AM_ARGS("(LLy#)", (long long)d->handle, (long long)s->handle, (const char *)msg,
          (Py_ssize_t)len);
  return dispatch("receive_sync_message", args);
}
