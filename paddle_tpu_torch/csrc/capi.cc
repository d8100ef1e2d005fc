// C inference API of paddle_tpu_torch — the serving surface outside
// Python, with the symbols and signatures of the reference's
// native/capi.cc (reference paddle/capi/gradient_machine.h:27-73
// create/load/forward/release, paddle/capi/main.h:27 init, and the
// multi-thread serving example). The engine is the port's Executor (or a
// bucketed ServingEngine), so this library embeds (or joins) a CPython
// interpreter and drives paddle_tpu_torch.capi_bridge. A C program links
// it with libpython and calls ptc_init(repo_path); loaded with ctypes it
// joins the host interpreter. All entry points are GIL-safe from any
// thread. Built by g++ at first use (paddle_tpu_torch/native.py) into
// paddle_tpu_torch/build/.
//
// Models load on CUDA unless the bridge's default device was set
// (capi_bridge.set_default_device("cpu")).
//
// C ABI (all returns: 0 = ok, negative = error):
//   ptc_init(repo_path)            — start/join interpreter
//   ptc_model_load(dir) -> handle  — load JSON __model__ + params
//   ptc_model_forward(...)         — run one batch
//   ptc_model_release(handle)
//
// Output buffers are owned by the handle and valid until the next
// forward/release on that handle (the reference's paddle_matrix
// lifetime contract).

#include <Python.h>

#include <cstdint>
#include <cstring>
#include <mutex>
#include <string>
#include <vector>

namespace {

PyObject* g_bridge = nullptr;  // paddle_tpu_torch.capi_bridge module

struct Model {
  long id = 0;
  // last forward's outputs (C-owned copies)
  std::vector<std::string> out_names;
  std::vector<std::vector<float>> out_bufs;
  std::vector<std::vector<int64_t>> out_shapes;
  std::mutex mu;
};

struct Gil {
  PyGILState_STATE st;
  Gil() { st = PyGILState_Ensure(); }
  ~Gil() { PyGILState_Release(st); }
};

}  // namespace

extern "C" {

// ptc_tensor: one named input. dtype: 0=float32, 1=int32, 2=int64.
typedef struct {
  const char* name;
  const void* data;
  const int64_t* shape;
  int ndim;
  int dtype;
} ptc_tensor;

int ptc_init(const char* repo_path) {
  if (!Py_IsInitialized()) {
    Py_InitializeEx(0);
    // embedded standalone: drop the GIL so worker threads can take it
    PyEval_SaveThread();
  }
  Gil gil;
  if (g_bridge != nullptr) return 0;
  if (repo_path && repo_path[0]) {
    PyObject* sys_path = PySys_GetObject("path");
    PyObject* p = PyUnicode_FromString(repo_path);
    PyList_Insert(sys_path, 0, p);
    Py_DECREF(p);
  }
  g_bridge = PyImport_ImportModule("paddle_tpu_torch.capi_bridge");
  if (g_bridge == nullptr) {
    PyErr_Print();
    return -1;
  }
  return 0;
}

void* ptc_model_load(const char* dirname) {
  Gil gil;
  if (g_bridge == nullptr) return nullptr;
  PyObject* r = PyObject_CallMethod(g_bridge, "load_model", "s", dirname);
  if (r == nullptr) {
    PyErr_Print();
    return nullptr;
  }
  Model* m = new Model();
  m->id = PyLong_AsLong(r);
  Py_DECREF(r);
  return m;
}

int ptc_model_forward(void* model, const ptc_tensor* inputs, int n_inputs) {
  Model* m = static_cast<Model*>(model);
  if (m == nullptr) return -1;
  std::lock_guard<std::mutex> lk(m->mu);
  Gil gil;
  PyObject* in_list = PyList_New(n_inputs);
  for (int i = 0; i < n_inputs; i++) {
    const ptc_tensor& t = inputs[i];
    int64_t numel = 1;
    for (int d = 0; d < t.ndim; d++) numel *= t.shape[d];
    int elt = (t.dtype == 2) ? 8 : 4;
    PyObject* buf = PyBytes_FromStringAndSize(
        static_cast<const char*>(t.data), numel * elt);
    PyObject* shape = PyTuple_New(t.ndim);
    for (int d = 0; d < t.ndim; d++)
      PyTuple_SET_ITEM(shape, d, PyLong_FromLongLong(t.shape[d]));
    PyObject* item = Py_BuildValue("(sNNi)", t.name, buf, shape, t.dtype);
    PyList_SET_ITEM(in_list, i, item);
  }
  PyObject* r = PyObject_CallMethod(g_bridge, "forward", "lN", m->id,
                                    in_list);
  if (r == nullptr) {
    PyErr_Print();
    return -2;
  }
  // r: [(name, float32 ndarray (buffer-protocol), shape list)].
  // Parse into locals; swap into the handle only on full success, so a
  // mid-parse failure leaves the previous forward's outputs intact and
  // the name/buf/shape vectors never disagree in length. Every bridge
  // access is checked — a malformed return yields an error code, never
  // UB in the embedding process.
  if (!PyList_Check(r)) {
    Py_DECREF(r);
    return -3;
  }
  Py_ssize_t n_out = PyList_Size(r);
  std::vector<std::string> names;
  std::vector<std::vector<float>> bufs;
  std::vector<std::vector<int64_t>> shapes;
  for (Py_ssize_t i = 0; i < n_out; i++) {
    PyObject* item = PyList_GetItem(r, i);
    if (item == nullptr || !PyTuple_Check(item) ||
        PyTuple_Size(item) < 3) {
      PyErr_Clear();
      Py_DECREF(r);
      return -3;
    }
    PyObject* name = PyTuple_GetItem(item, 0);
    PyObject* arr = PyTuple_GetItem(item, 1);
    PyObject* shape = PyTuple_GetItem(item, 2);
    const char* name_c =
        (name != nullptr) ? PyUnicode_AsUTF8(name) : nullptr;
    if (name_c == nullptr || arr == nullptr || shape == nullptr ||
        !PyList_Check(shape)) {
      PyErr_Clear();
      Py_DECREF(r);
      return -3;
    }
    names.push_back(name_c);
    Py_buffer view;
    if (PyObject_GetBuffer(arr, &view, PyBUF_CONTIG_RO) != 0) {
      PyErr_Print();
      Py_DECREF(r);
      return -3;
    }
    size_t n = view.len / sizeof(float);
    bufs.emplace_back(n);
    std::memcpy(bufs.back().data(), view.buf, view.len);
    PyBuffer_Release(&view);
    Py_ssize_t nd = PyList_Size(shape);
    std::vector<int64_t> dims;
    for (Py_ssize_t d = 0; d < nd; d++) {
      PyObject* dim = PyList_GetItem(shape, d);
      long long v = (dim != nullptr) ? PyLong_AsLongLong(dim) : -1;
      if (v == -1 && PyErr_Occurred()) {
        PyErr_Clear();
        Py_DECREF(r);
        return -3;
      }
      dims.push_back(v);
    }
    shapes.push_back(std::move(dims));
  }
  Py_DECREF(r);
  m->out_names = std::move(names);
  m->out_bufs = std::move(bufs);
  m->out_shapes = std::move(shapes);
  return static_cast<int>(n_out);
}

int ptc_model_num_outputs(void* model) {
  Model* m = static_cast<Model*>(model);
  return static_cast<int>(m->out_bufs.size());
}

const char* ptc_model_output_name(void* model, int i) {
  Model* m = static_cast<Model*>(model);
  return m->out_names[i].c_str();
}

// The outputs of a handle live in ONE buffer per handle, as in the
// reference's ABI: the handle's next ptc_model_forward replaces them, and
// these accessors read them without taking the handle's lock. A caller
// that forwards one handle from several threads holds its own lock
// around each forward and the reads of that forward's outputs, or gives
// each thread a handle of its own.
const float* ptc_model_output_data(void* model, int i, int64_t* numel) {
  Model* m = static_cast<Model*>(model);
  if (numel) *numel = static_cast<int64_t>(m->out_bufs[i].size());
  return m->out_bufs[i].data();
}

int ptc_model_output_ndim(void* model, int i) {
  Model* m = static_cast<Model*>(model);
  return static_cast<int>(m->out_shapes[i].size());
}

int64_t ptc_model_output_dim(void* model, int i, int d) {
  Model* m = static_cast<Model*>(model);
  return m->out_shapes[i][d];
}

void ptc_model_release(void* model) {
  Model* m = static_cast<Model*>(model);
  if (m == nullptr) return;
  {
    Gil gil;
    PyObject* r = PyObject_CallMethod(g_bridge, "release", "l", m->id);
    Py_XDECREF(r);
  }
  delete m;
}

}  // extern "C"
