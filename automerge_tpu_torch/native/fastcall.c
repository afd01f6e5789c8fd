/* CPython fast-call shim for the per-edit hot path.
 *
 * ctypes costs ~1us per foreign call (argument marshalling through
 * libffi); a METH_FASTCALL extension entry is ~10x cheaper and can read
 * the codepoints straight out of the PyUnicode object instead of round-
 * tripping through numpy. This is the difference between the per-edit
 * replay API meeting the reference's transaction-replay throughput
 * (rust/edit-trace/benches/main.rs) and losing to it on call overhead.
 *
 * The session library (session.cpp, built into libamt_native) is
 * reached through a function pointer installed by setup() — the address
 * comes from the ctypes CDLL that already loaded it, so there is exactly
 * one copy of the session code and no link-time coupling.
 */
#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <stdint.h>
#include <stdlib.h>

typedef int64_t i64;
typedef int32_t i32;

typedef i64 (*splice_fn_t)(void *, i64, i64, i64, const i32 *, const i32 *,
                           i64);
typedef i64 (*map_put_fn_t)(void *, i64, const char *, i64, i32, i64, double,
                            const uint8_t *, i64);

static splice_fn_t g_splice = NULL;
static map_put_fn_t g_map_put = NULL;

static PyObject *setup(PyObject *self, PyObject *args) {
  unsigned long long addr;
  if (!PyArg_ParseTuple(args, "K", &addr)) return NULL;
  g_splice = (splice_fn_t)(uintptr_t)addr;
  Py_RETURN_NONE;
}

static PyObject *setup_map(PyObject *self, PyObject *args) {
  unsigned long long addr;
  if (!PyArg_ParseTuple(args, "K", &addr)) return NULL;
  g_map_put = (map_put_fn_t)(uintptr_t)addr;
  Py_RETURN_NONE;
}

/* splice(handle:int, ctr0:int, pos:int, ndel:int, text:str, enc:int) -> int
 *
 * enc selects the width unit: 0 = unicode codepoints (width 1),
 * 1 = utf-8 bytes, 2 = utf-16 code units (types.get_text_encoding).
 * Returns ops emitted, or the session's negative error code (the caller
 * maps it to the same exception the ctypes path raises). */
static PyObject *splice(PyObject *self, PyObject *const *args,
                        Py_ssize_t nargs) {
  if (nargs != 6) {
    PyErr_SetString(PyExc_TypeError, "splice expects 6 arguments");
    return NULL;
  }
  if (g_splice == NULL) {
    PyErr_SetString(PyExc_RuntimeError, "fastcall.setup() not called");
    return NULL;
  }
  void *h = (void *)(uintptr_t)PyLong_AsUnsignedLongLong(args[0]);
  i64 ctr0 = PyLong_AsLongLong(args[1]);
  i64 pos = PyLong_AsLongLong(args[2]);
  i64 ndel = PyLong_AsLongLong(args[3]);
  PyObject *text = args[4];
  long enc = PyLong_AsLong(args[5]);
  if (PyErr_Occurred()) return NULL;
  if (!PyUnicode_Check(text)) {
    PyErr_SetString(PyExc_TypeError, "splice text must be str");
    return NULL;
  }
  Py_ssize_t nt = PyUnicode_GET_LENGTH(text);
  i32 stack_cp[128];
  i32 stack_w[128];
  i32 *cp = stack_cp, *w = stack_w;
  if (nt > 128) {
    cp = (i32 *)malloc(sizeof(i32) * (size_t)nt * 2);
    if (cp == NULL) return PyErr_NoMemory();
    w = cp + nt;
  }
  const int kind = PyUnicode_KIND(text);
  const void *data = PyUnicode_DATA(text);
  for (Py_ssize_t i = 0; i < nt; i++) {
    Py_UCS4 c = PyUnicode_READ(kind, data, i);
    cp[i] = (i32)c;
    w[i] = enc == 1 ? 1 + (c > 0x7F) + (c > 0x7FF) + (c > 0xFFFF)
           : enc == 2 ? 1 + (c > 0xFFFF)
                      : 1;
  }
  i64 n = g_splice(h, ctr0, pos, ndel, cp, w, nt);
  if (cp != stack_cp) free(cp);
  return PyLong_FromLongLong(n);
}

/* map_put(handle:int, ctr:int, key:str, value) -> int
 *
 * The per-op map hot path: dispatches the Python value to the session's
 * column payload form (value_meta type code + raw bytes) without building
 * a ScalarValue, then records the op natively (map_session.cpp am_map_put:
 * pred = the key's current winner). Returns ops emitted (1), or -3 when
 * the key/value shape isn't session-eligible (empty key, non-str key,
 * big int, exotic type) — the caller falls back to the generic path,
 * which raises the proper typed errors. */
static PyObject *map_put(PyObject *self, PyObject *const *args,
                         Py_ssize_t nargs) {
  if (nargs != 4) {
    PyErr_SetString(PyExc_TypeError, "map_put expects 4 arguments");
    return NULL;
  }
  if (g_map_put == NULL) {
    PyErr_SetString(PyExc_RuntimeError, "fastcall.setup_map() not called");
    return NULL;
  }
  void *h = (void *)(uintptr_t)PyLong_AsUnsignedLongLong(args[0]);
  i64 ctr = PyLong_AsLongLong(args[1]);
  if (PyErr_Occurred()) return NULL;
  PyObject *key = args[2];
  PyObject *val = args[3];
  if (!PyUnicode_Check(key)) return PyLong_FromLong(-3);
  Py_ssize_t klen;
  const char *kbuf = PyUnicode_AsUTF8AndSize(key, &klen);
  if (kbuf == NULL) return NULL;
  if (klen == 0) return PyLong_FromLong(-3); /* empty key: python path raises */

  i32 code;
  i64 ival = 0;
  double fval = 0.0;
  const uint8_t *raw = NULL;
  i64 raw_len = 0;
  if (val == Py_None) {
    code = 0; /* null */
  } else if (PyBool_Check(val)) {
    code = (val == Py_True) ? 2 : 1;
  } else if (PyLong_Check(val)) {
    int overflow = 0;
    ival = PyLong_AsLongLongAndOverflow(val, &overflow);
    if (overflow || (ival == -1 && PyErr_Occurred())) {
      PyErr_Clear();
      return PyLong_FromLong(-3); /* bigint: python path */
    }
    code = 4; /* int (sleb) — matches ScalarValue.from_py(int) */
  } else if (PyFloat_Check(val)) {
    fval = PyFloat_AS_DOUBLE(val);
    code = 5;
  } else if (PyUnicode_Check(val)) {
    Py_ssize_t n;
    raw = (const uint8_t *)PyUnicode_AsUTF8AndSize(val, &n);
    if (raw == NULL) return NULL;
    raw_len = n;
    code = 6;
  } else if (PyBytes_Check(val)) {
    raw = (const uint8_t *)PyBytes_AS_STRING(val);
    raw_len = PyBytes_GET_SIZE(val);
    code = 7;
  } else {
    return PyLong_FromLong(-3); /* Counter/ScalarValue/objects: python path */
  }
  i64 n = g_map_put(h, ctr, kbuf, (i64)klen, code, ival, fval, raw, raw_len);
  return PyLong_FromLongLong(n);
}

static PyMethodDef methods[] = {
    {"setup", setup, METH_VARARGS, "Install the am_edit_splice address."},
    {"setup_map", setup_map, METH_VARARGS, "Install the am_map_put address."},
    {"splice", (PyCFunction)(void (*)(void))splice, METH_FASTCALL,
     "splice(handle, ctr0, pos, ndel, text, enc) -> ops emitted"},
    {"map_put", (PyCFunction)(void (*)(void))map_put, METH_FASTCALL,
     "map_put(handle, ctr, key, value) -> ops emitted"},
    {NULL, NULL, 0, NULL}};

static struct PyModuleDef module = {PyModuleDef_HEAD_INIT, "amt_fastcall",
                                    NULL, -1, methods};

PyMODINIT_FUNC PyInit_amt_fastcall(void) { return PyModule_Create(&module); }
