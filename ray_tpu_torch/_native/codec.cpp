// Native data-plane codec for the object store / RPC framing.
//
// Capability parity with the reference's C++ data plane (reference:
// src/ray/object_manager/plasma/ arena + src/ray/common/buffer.h — frame
// assembly and scatter/gather happen in C++, never in Python): the hot
// pack/unpack of pickle-5 frame lists into single contiguous blobs is a
// single-pass memcpy here instead of Python-level bytes concatenation.
//
// Layout (matches ray_tpu_torch/_private/serialization.py pack_frames):
//   [u32 nframes][u64 size_0]...[u64 size_{n-1}] frame_0 ... frame_{n-1}
//
// Built as a plain CPython extension (no pybind11 — not in the image).

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <atomic>
#include <cstdint>
#include <cstring>

namespace {

// pack_frames(list[buffer]) -> bytes
PyObject* pack_frames(PyObject* /*self*/, PyObject* arg) {
  PyObject* seq = PySequence_Fast(arg, "pack_frames expects a sequence");
  if (seq == nullptr) return nullptr;
  Py_ssize_t n = PySequence_Fast_GET_SIZE(seq);

  // First pass: acquire buffers, total size.
  Py_buffer* views =
      static_cast<Py_buffer*>(PyMem_Malloc(sizeof(Py_buffer) * (n ? n : 1)));
  if (views == nullptr) {
    Py_DECREF(seq);
    return PyErr_NoMemory();
  }
  Py_ssize_t acquired = 0;
  uint64_t total = 4 + 8 * static_cast<uint64_t>(n);
  for (Py_ssize_t i = 0; i < n; i++) {
    PyObject* item = PySequence_Fast_GET_ITEM(seq, i);
    if (PyObject_GetBuffer(item, &views[i], PyBUF_CONTIG_RO) != 0) {
      goto fail;
    }
    acquired++;
    total += static_cast<uint64_t>(views[i].len);
  }

  {
    PyObject* out = PyBytes_FromStringAndSize(nullptr, (Py_ssize_t)total);
    if (out == nullptr) goto fail;
    char* p = PyBytes_AS_STRING(out);
    uint32_t n32 = static_cast<uint32_t>(n);
    std::memcpy(p, &n32, 4);
    p += 4;
    for (Py_ssize_t i = 0; i < n; i++) {
      uint64_t len = static_cast<uint64_t>(views[i].len);
      std::memcpy(p, &len, 8);
      p += 8;
    }
    for (Py_ssize_t i = 0; i < n; i++) {
      if (views[i].len > 0) std::memcpy(p, views[i].buf, views[i].len);
      p += views[i].len;
    }
    for (Py_ssize_t i = 0; i < acquired; i++) PyBuffer_Release(&views[i]);
    PyMem_Free(views);
    Py_DECREF(seq);
    return out;
  }

fail:
  for (Py_ssize_t i = 0; i < acquired; i++) PyBuffer_Release(&views[i]);
  PyMem_Free(views);
  Py_DECREF(seq);
  return nullptr;
}

// frame_offsets(buffer) -> list[(offset, size)]  (zero-copy: caller slices
// its own memoryview, so the blob's lifetime stays with the caller)
PyObject* frame_offsets(PyObject* /*self*/, PyObject* arg) {
  Py_buffer view;
  if (PyObject_GetBuffer(arg, &view, PyBUF_CONTIG_RO) != 0) return nullptr;
  const char* p = static_cast<const char*>(view.buf);
  uint64_t remaining = static_cast<uint64_t>(view.len);
  if (remaining < 4) {
    PyBuffer_Release(&view);
    PyErr_SetString(PyExc_ValueError, "blob too short for header");
    return nullptr;
  }
  uint32_t n;
  std::memcpy(&n, p, 4);
  // Pairs with the writer's release fence in write_into: once a nonzero
  // count is observed, the size table and frame bytes published before
  // it must be visible too (matters on weakly-ordered CPUs; x86 TSO
  // gets this for free).
  std::atomic_thread_fence(std::memory_order_acquire);
  if (remaining < 4 + 8ull * n) {
    PyBuffer_Release(&view);
    PyErr_SetString(PyExc_ValueError, "blob too short for size table");
    return nullptr;
  }
  PyObject* out = PyList_New(n);
  if (out == nullptr) {
    PyBuffer_Release(&view);
    return nullptr;
  }
  uint64_t off = 4 + 8ull * n;
  for (uint32_t i = 0; i < n; i++) {
    uint64_t len;
    std::memcpy(&len, p + 4 + 8ull * i, 8);
    // Subtraction form: `off + len` can wrap for a torn/corrupt u64 size
    // (off <= remaining holds inductively, so the subtraction is safe).
    if (len > remaining - off) {
      Py_DECREF(out);
      PyBuffer_Release(&view);
      PyErr_SetString(PyExc_ValueError, "frame overruns blob");
      return nullptr;
    }
    PyObject* tup = Py_BuildValue("(KK)", (unsigned long long)off,
                                  (unsigned long long)len);
    if (tup == nullptr) {
      Py_DECREF(out);
      PyBuffer_Release(&view);
      return nullptr;
    }
    PyList_SET_ITEM(out, i, tup);
    off += len;
  }
  PyBuffer_Release(&view);
  return out;
}

// write_into(dst_buffer, offset, frames) -> total_written
// One-pass scatter of a frame list into a writable buffer (the shm
// segment), skipping the intermediate bytes object entirely.
PyObject* write_into(PyObject* /*self*/, PyObject* args) {
  PyObject* dst_obj;
  unsigned long long offset;
  PyObject* frames;
  if (!PyArg_ParseTuple(args, "OKO", &dst_obj, &offset, &frames)) {
    return nullptr;
  }
  Py_buffer dst;
  if (PyObject_GetBuffer(dst_obj, &dst, PyBUF_CONTIG) != 0) return nullptr;
  PyObject* seq = PySequence_Fast(frames, "write_into expects a sequence");
  if (seq == nullptr) {
    PyBuffer_Release(&dst);
    return nullptr;
  }
  Py_ssize_t n = PySequence_Fast_GET_SIZE(seq);
  uint64_t total = 4 + 8ull * n;
  char* base = static_cast<char*>(dst.buf);
  uint64_t cap = static_cast<uint64_t>(dst.len);
  uint32_t n32 = static_cast<uint32_t>(n);
  uint64_t pos = offset;
  if (pos + total > cap) goto overflow;
  pos += 4 + 8ull * n;  // sizes written in the loop below
  for (Py_ssize_t i = 0; i < n; i++) {
    PyObject* item = PySequence_Fast_GET_ITEM(seq, i);
    Py_buffer v;
    if (PyObject_GetBuffer(item, &v, PyBUF_CONTIG_RO) != 0) {
      Py_DECREF(seq);
      PyBuffer_Release(&dst);
      return nullptr;
    }
    uint64_t len = static_cast<uint64_t>(v.len);
    if (pos + len > cap) {
      PyBuffer_Release(&v);
      goto overflow;
    }
    std::memcpy(base + offset + 4 + 8ull * i, &len, 8);
    if (len > 0) std::memcpy(base + pos, v.buf, len);
    pos += len;
    total += len;
    PyBuffer_Release(&v);
  }
  // Publish-after-write: the frame count lands LAST, so a concurrent
  // reader of a shared segment sees either count=0 (not ready → retry)
  // or a fully written table + data — never a torn structure.
  std::atomic_thread_fence(std::memory_order_release);
  std::memcpy(base + offset, &n32, 4);
  Py_DECREF(seq);
  PyBuffer_Release(&dst);
  return PyLong_FromUnsignedLongLong(total);

overflow:
  Py_DECREF(seq);
  PyBuffer_Release(&dst);
  PyErr_SetString(PyExc_ValueError, "destination buffer too small");
  return nullptr;
}

PyMethodDef methods[] = {
    {"pack_frames", pack_frames, METH_O,
     "Pack a list of buffers into one length-prefixed blob."},
    {"frame_offsets", frame_offsets, METH_O,
     "Parse a packed blob's header into (offset, size) pairs."},
    {"write_into", write_into, METH_VARARGS,
     "Scatter a frame list into a writable buffer at an offset."},
    {nullptr, nullptr, 0, nullptr}};

PyModuleDef module = {PyModuleDef_HEAD_INIT, "_rt_native",
                      "Native data-plane codec.", -1, methods,
                      nullptr, nullptr, nullptr, nullptr};

}  // namespace

PyMODINIT_FUNC PyInit__rt_native(void) { return PyModule_Create(&module); }
