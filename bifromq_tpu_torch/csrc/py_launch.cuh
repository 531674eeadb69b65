// The Python entry of a kernel's C launch function.
//
// Each csrc/*.cu ends with PY_LAUNCH_MODULE(module, entry) and is built by
// nvcc as a Python extension module (the interpreter's include directory,
// no PyTorch headers, so the build takes seconds). The module has one
// METH_FASTCALL function, `entry(*args)`, that converts each Python int to
// the C entry's argument type (int, or a pointer as an address), calls the
// entry and returns its int result, the launch's cudaGetLastError(). At the
// serving path's widths a launch is nearly all host time, and this call
// costs a fraction of what ctypes' per-call argument marshalling does.

#pragma once

#include <Python.h>

#include <cstddef>
#include <tuple>
#include <utility>

namespace py_launch {

template <typename T>
struct arg;
template <>
struct arg<int> {
  static int get(PyObject* o) { return (int)PyLong_AsLong(o); }
};
template <>
struct arg<void*> {
  static void* get(PyObject* o) { return PyLong_AsVoidPtr(o); }
};
template <>
struct arg<const void*> {
  static const void* get(PyObject* o) { return PyLong_AsVoidPtr(o); }
};

template <typename... A, std::size_t... I>
PyObject* call(int (*entry)(A...), PyObject* const* args,
               std::index_sequence<I...>) {
  // a braced list converts left to right; a bad argument sets an error
  const std::tuple<A...> v{arg<A>::get(args[I])...};
  if (PyErr_Occurred()) return nullptr;
  return PyLong_FromLong(entry(std::get<I>(v)...));
}

template <typename... A>
PyObject* call(int (*entry)(A...), PyObject* const* args, Py_ssize_t n,
               const char* name) {
  if (n != (Py_ssize_t)sizeof...(A)) {
    PyErr_Format(PyExc_TypeError, "%s takes %d arguments, got %zd", name,
                 (int)sizeof...(A), n);
    return nullptr;
  }
  return call(entry, args, std::index_sequence_for<A...>{});
}

}  // namespace py_launch

#define PY_LAUNCH_MODULE(module, entry)                                    \
  static PyObject* py_##entry(PyObject*, PyObject* const* args,           \
                              Py_ssize_t n) {                              \
    return py_launch::call(entry, args, n, #entry);                       \
  }                                                                        \
  static PyMethodDef module##_methods[] = {                                \
      {#entry, (PyCFunction)(void (*)(void))py_##entry, METH_FASTCALL,     \
       "launch " #entry "; returns cudaGetLastError()"},                   \
      {nullptr, nullptr, 0, nullptr}};                                     \
  static PyModuleDef module##_def = {PyModuleDef_HEAD_INIT, #module,       \
                                     nullptr, -1, module##_methods};       \
  PyMODINIT_FUNC PyInit_##module(void) { return PyModule_Create(&module##_def); }
