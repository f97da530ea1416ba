// pyobjects -- the decoder's per-container work on Python objects, in C.
//
// A decode call of N containers needs each source's buffer address and
// length, and N fresh output bytes objects with their buffer addresses, for
// the native walk, gather and rebuild of runtime/src/tpulzfse.cpp. Done in
// Python, each is a pass of the interpreter over N objects, and at N =
// 16,384 those passes hold the interpreter lock for milliseconds a call.
// Here each is one loop in C.
//
// Loaded with ctypes.PyDLL (runtime/native.py), so every function runs with
// the interpreter lock held, as the C API requires, and never releases it.
// An error sets a Python exception, which ctypes raises after the call.
//
// C ABI:
//   lzt_source_spans(sources, n, addrs, lens) -> 0, or -1 with an exception
//   lzt_new_outputs(sizes, n, addrs)          -> new list, or NULL with one

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <stdint.h>

// addrs[i], lens[i] = the buffer address and length of sources[i], for a
// list or tuple of n bytes objects (subclasses too). Anything else raises
// TypeError naming its type, as the Python version did; a sequence whose
// length is not n raises ValueError.
int lzt_source_spans(PyObject* sources, Py_ssize_t n, int64_t* addrs,
                     int64_t* lens) {
  PyObject* seq = PySequence_Fast(sources, "src_ptrs takes a sequence");
  if (seq == NULL) return -1;
  if (PySequence_Fast_GET_SIZE(seq) != n) {
    PyErr_Format(PyExc_ValueError, "src_ptrs: %zd sources, not %zd",
                 PySequence_Fast_GET_SIZE(seq), n);
    Py_DECREF(seq);
    return -1;
  }
  PyObject** items = PySequence_Fast_ITEMS(seq);
  for (Py_ssize_t i = 0; i < n; i++) {
    PyObject* src = items[i];
    if (!PyBytes_Check(src)) {
      PyObject* name = PyType_GetName(Py_TYPE(src));
      if (name != NULL) {
        PyErr_Format(PyExc_TypeError, "src_ptrs takes bytes objects, not %U",
                     name);
        Py_DECREF(name);
      }
      Py_DECREF(seq);
      return -1;
    }
    addrs[i] = (int64_t)(intptr_t)PyBytes_AS_STRING(src);
    lens[i] = (int64_t)PyBytes_GET_SIZE(src);
  }
  Py_DECREF(seq);
  return 0;
}

// A new list of n bytes objects of sizes[0..n), their contents
// uninitialized (the native rebuild writes them), and each one's buffer
// address in addrs[i]. Size 0 gives the interpreter's shared empty bytes.
// On a failed allocation the objects made so far are released with the
// list, and the exception (MemoryError) is left set.
PyObject* lzt_new_outputs(const int64_t* sizes, Py_ssize_t n,
                          int64_t* addrs) {
  PyObject* out = PyList_New(n);
  if (out == NULL) return NULL;
  for (Py_ssize_t i = 0; i < n; i++) {
    PyObject* b = PyBytes_FromStringAndSize(NULL, (Py_ssize_t)sizes[i]);
    if (b == NULL) {
      Py_DECREF(out);
      return NULL;
    }
    PyList_SET_ITEM(out, i, b);
    addrs[i] = (int64_t)(intptr_t)PyBytes_AS_STRING(b);
  }
  return out;
}
