// Native data-loading core: parallel file read + zstd decompression.
//
// The PyTorch port's own copy of the JAX package's native loader
// (arcflow_tpu/data/_fastloader/fastloader.cpp), so that the port imports
// nothing of that package: a CPython extension whose std::thread pool reads
// and zstd-decompresses a batch of cache records with the GIL released, so
// the host keeps the card fed while Python only does the final (cheap)
// unpickling. It links libzstd's C library, not the Python `zstandard`
// package.
//
// Built lazily by arcflow_tpu_torch/data/_fastloader/__init__.py
// (g++ -O3 -std=c++17 -shared -fPIC ... -lzstd -lpthread) into the port's
// build directory.

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#define ZSTD_STATIC_LINKING_ONLY   // ZSTD_decompressBound is in the staging API
#include <zstd.h>

#include <atomic>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

bool ReadFile(const std::string& path, std::string* out) {
  FILE* f = std::fopen(path.c_str(), "rb");
  if (f == nullptr) return false;
  std::fseek(f, 0, SEEK_END);
  long size = std::ftell(f);
  if (size < 0) {
    std::fclose(f);
    return false;
  }
  std::fseek(f, 0, SEEK_SET);
  out->resize(static_cast<size_t>(size));
  size_t got = size ? std::fread(&(*out)[0], 1, out->size(), f) : 0;
  std::fclose(f);
  return got == out->size();
}

// Streaming decompression writing directly into a geometrically grown output
// buffer (no per-chunk copies). Frames from streaming compressors usually
// omit the content size, so the one-shot API is not applicable; when the
// size IS known we pre-size exactly.
struct Buffer {
  char* data = nullptr;
  size_t size = 0;
  ~Buffer() { std::free(data); }
};

// One-shot decompression into a ZSTD_decompressBound-sized malloc buffer
// (virtual alloc, never zero-filled) — measurably faster than the streaming
// API for the cache's record sizes; falls back to streaming when the bound
// is unavailable.
bool ZstdDecompress(ZSTD_DCtx* dctx, const std::string& src, Buffer* dst) {
  ZSTD_DCtx_reset(dctx, ZSTD_reset_session_only);
  unsigned long long bound = ZSTD_decompressBound(src.data(), src.size());
  if (bound != ZSTD_CONTENTSIZE_ERROR && bound > 0) {
    char* buf = static_cast<char*>(std::malloc(bound));
    if (buf == nullptr) return false;
    size_t const ret =
        ZSTD_decompressDCtx(dctx, buf, bound, src.data(), src.size());
    if (ZSTD_isError(ret)) {
      std::free(buf);
      return false;
    }
    dst->data = buf;
    dst->size = ret;
    return true;
  }
  // streaming fallback (unbounded window)
  size_t cap = src.size() * 4 + (1 << 16);
  char* buf = static_cast<char*>(std::malloc(cap));
  if (buf == nullptr) return false;
  ZSTD_inBuffer in = {src.data(), src.size(), 0};
  size_t out_pos = 0;
  while (true) {
    if (out_pos == cap) {
      cap *= 2;
      char* grown = static_cast<char*>(std::realloc(buf, cap));
      if (grown == nullptr) {
        std::free(buf);
        return false;
      }
      buf = grown;
    }
    ZSTD_outBuffer ob = {buf, cap, out_pos};
    size_t const ret = ZSTD_decompressStream(dctx, &ob, &in);
    if (ZSTD_isError(ret)) {
      std::free(buf);
      return false;
    }
    out_pos = ob.pos;
    if (ret == 0) break;             // frame complete
    if (in.pos >= in.size && ob.pos < ob.size) {
      // input exhausted mid-frame: the record is truncated/corrupt —
      // fail instead of silently returning partial bytes
      std::free(buf);
      return false;
    }
  }
  dst->data = buf;
  dst->size = out_pos;
  return true;
}

struct Task {
  std::string path;
  Buffer data;
  bool decompress = false;
  bool ok = false;
};

void RunPool(std::vector<Task>* tasks, int n_threads) {
  std::atomic<size_t> next(0);
  auto worker = [tasks, &next]() {
    ZSTD_DCtx* dctx = ZSTD_createDCtx();   // one context per worker, reused
    while (true) {
      size_t i = next.fetch_add(1);
      if (i >= tasks->size()) break;
      Task& t = (*tasks)[i];
      std::string raw;
      if (!ReadFile(t.path, &raw)) {
        t.ok = false;
        continue;
      }
      if (t.decompress) {
        t.ok = dctx != nullptr && ZstdDecompress(dctx, raw, &t.data);
      } else {
        t.data.data = static_cast<char*>(std::malloc(raw.size()));
        t.ok = t.data.data != nullptr;
        if (t.ok) {
          std::memcpy(t.data.data, raw.data(), raw.size());
          t.data.size = raw.size();
        }
      }
    }
    if (dctx != nullptr) ZSTD_freeDCtx(dctx);
  };
  int n = n_threads;
  if (n <= 0) n = static_cast<int>(std::thread::hardware_concurrency());
  if (n < 1) n = 1;
  std::vector<std::thread> threads;
  threads.reserve(static_cast<size_t>(n));
  for (int i = 0; i < n; ++i) threads.emplace_back(worker);
  for (auto& th : threads) th.join();
}

PyObject* LoadBatch(PyObject* /*self*/, PyObject* args, PyObject* kwargs) {
  PyObject* path_list = nullptr;
  int n_threads = 0;
  int decompress = 1;
  static const char* kwlist[] = {"paths", "num_threads", "decompress",
                                 nullptr};
  if (!PyArg_ParseTupleAndKeywords(args, kwargs, "O|ip",
                                   const_cast<char**>(kwlist), &path_list,
                                   &n_threads, &decompress)) {
    return nullptr;
  }
  PyObject* seq = PySequence_Fast(path_list, "paths must be a sequence");
  if (seq == nullptr) return nullptr;
  Py_ssize_t n = PySequence_Fast_GET_SIZE(seq);
  std::vector<Task> tasks(static_cast<size_t>(n));
  for (Py_ssize_t i = 0; i < n; ++i) {
    PyObject* item = PySequence_Fast_GET_ITEM(seq, i);
    const char* s = PyUnicode_AsUTF8(item);
    if (s == nullptr) {
      Py_DECREF(seq);
      return nullptr;
    }
    tasks[static_cast<size_t>(i)].path = s;
    tasks[static_cast<size_t>(i)].decompress = decompress != 0;
  }
  Py_DECREF(seq);

  Py_BEGIN_ALLOW_THREADS
  RunPool(&tasks, n_threads);
  Py_END_ALLOW_THREADS

  PyObject* result = PyList_New(n);
  if (result == nullptr) return nullptr;
  for (Py_ssize_t i = 0; i < n; ++i) {
    Task& t = tasks[static_cast<size_t>(i)];
    if (!t.ok) {
      Py_DECREF(result);
      PyErr_Format(PyExc_IOError, "failed to load %s", t.path.c_str());
      return nullptr;
    }
    PyObject* b = PyBytes_FromStringAndSize(
        t.data.data, static_cast<Py_ssize_t>(t.data.size));
    if (b == nullptr) {
      Py_DECREF(result);
      return nullptr;
    }
    PyList_SET_ITEM(result, i, b);
  }
  return result;
}

PyMethodDef kMethods[] = {
    {"load_batch", reinterpret_cast<PyCFunction>(LoadBatch),
     METH_VARARGS | METH_KEYWORDS,
     "load_batch(paths, num_threads=0, decompress=True) -> list[bytes]\n"
     "Parallel read (+ zstd decompress) with the GIL released."},
    {nullptr, nullptr, 0, nullptr}};

PyModuleDef kModule = {PyModuleDef_HEAD_INIT, "_arcflow_fastloader",
                       "native batched record loader", -1, kMethods};

}  // namespace

PyMODINIT_FUNC PyInit__arcflow_fastloader() {
  return PyModule_Create(&kModule);
}
