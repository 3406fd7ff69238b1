// Training-side C API: Dataset creation + boosting from C callers.
//
// Counterpart of the reference's training ABI
// (ref: include/LightGBM/c_api.h:186 LGBM_DatasetCreateFromMat, :810
// LGBM_BoosterUpdateOneIter, src/c_api.cpp Booster::TrainOneIter). The
// compute path of this framework is PyTorch, so these entry points embed
// a Python interpreter (lazily, via dlopen of libpython — the serving
// surface in c_api.cpp stays interpreter-free) and drive the same engine
// the Python API uses. State lives in the embedded interpreter; handles
// carry an id into it. The interpreter's names carry the _lgbt prefix,
// so another library of this ABI embedding the same interpreter keeps its
// own state. The engine trains on the device its parameters name (the
// card unless device_type=cpu).
//
// Threading: entry points serialize on RunGuarded's mutex and
// acquire/release the GIL symmetrically (PyGILState_Ensure around every
// interpreter entry; the self-embedding path drops the GIL after
// initialization), so calls may come from any host thread — including
// Python hosts whose FFI released the GIL — one at a time. The
// lock-free fast predict paths live on the serving side (c_api.cpp).
#include <dlfcn.h>

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <atomic>
#include <functional>
#include <mutex>
#include <utility>
#include <set>
#include <string>
#include <vector>

namespace {

void SetTrainError(const std::string& msg);  // fwd; shared with c_api.cpp

// ---- embedded python ---------------------------------------------------
typedef int (*PyRun_t)(const char*);
typedef void (*PyInit_t)(int);
typedef int (*PyIsInit_t)();
typedef int (*PyGilEnsure_t)();
typedef void (*PyGilRelease_t)(int);

PyRun_t g_pyrun_raw = nullptr;
PyGilEnsure_t g_gil_ensure = nullptr;
PyGilRelease_t g_gil_release = nullptr;
// kept as a flag name used throughout: non-null once bootstrapped
PyRun_t g_pyrun = nullptr;

// Every interpreter entry must hold the GIL. When the host process IS
// python (ctypes callers: the FFI releases the GIL around the foreign
// call), PyGILState_Ensure re-acquires it; when this library embedded
// the interpreter itself, the pair is a no-op-ish recursion.
int PyRunGil(const char* code) {
  int st = g_gil_ensure ? g_gil_ensure() : 0;
  int rc = g_pyrun_raw(code);
  if (g_gil_release) g_gil_release(st);
  return rc;
}

bool EnsurePython() {
  if (g_pyrun) return true;
  const char* names[] = {"libpython3.12.so.1.0", "libpython3.12.so",
                         "libpython3.so",        "libpython3.11.so.1.0",
                         "libpython3.11.so",     nullptr};
  // A Python host (ctypes) has its interpreter's symbols in the process
  // already, in a libpython or in the executable itself (a python built
  // statically, exporting them for its extension modules). Use those: a
  // libpython loaded beside such an executable would be a second
  // interpreter runtime in the process.
  // (RTLD_DEFAULT is the null handle: dlsym then searches the process.)
  void* lib = RTLD_DEFAULT;
  if (!dlsym(RTLD_DEFAULT, "Py_IsInitialized")) {
    const char* env = std::getenv("LGBM_TPU_LIBPYTHON");
    lib = env ? dlopen(env, RTLD_NOW | RTLD_GLOBAL) : nullptr;
    for (int i = 0; !lib && names[i]; ++i)
      lib = dlopen(names[i], RTLD_NOW | RTLD_GLOBAL);
    if (!lib) {
      SetTrainError("training C API: could not dlopen libpython (set "
                    "LGBM_TPU_LIBPYTHON to its path)");
      return false;
    }
  }
  auto is_init = reinterpret_cast<PyIsInit_t>(dlsym(lib, "Py_IsInitialized"));
  auto init = reinterpret_cast<PyInit_t>(dlsym(lib, "Py_InitializeEx"));
  g_pyrun_raw = reinterpret_cast<PyRun_t>(dlsym(lib, "PyRun_SimpleString"));
  g_gil_ensure = reinterpret_cast<PyGilEnsure_t>(
      dlsym(lib, "PyGILState_Ensure"));
  g_gil_release = reinterpret_cast<PyGilRelease_t>(
      dlsym(lib, "PyGILState_Release"));
  if (!is_init || !init || !g_pyrun_raw) {
    SetTrainError("training C API: libpython is missing required symbols");
    g_pyrun_raw = nullptr;
    return false;
  }
  if (!is_init()) {
    init(0);
    // drop the GIL the initializing thread holds so that every entry
    // goes through PyGILState_Ensure symmetrically — otherwise a later
    // call from a DIFFERENT host thread would deadlock in Ensure.
    // Only safe when the Ensure/Release pair resolved; without them,
    // keeping the GIL on this thread is the working single-threaded
    // contract.
    if (g_gil_ensure && g_gil_release) {
      typedef void* (*PySave_t)();
      auto save = reinterpret_cast<PySave_t>(
          dlsym(lib, "PyEval_SaveThread"));
      if (save) save();
    }
  }
  g_pyrun = &PyRunGil;

  // bootstrap: make the package importable from the .so's own location
  // (<repo>/lightgbm_tpu_torch/_build/native/lgbm_native-<hash>.so ->
  // <repo>)
  Dl_info info;
  std::string root;
  if (dladdr(reinterpret_cast<void*>(&EnsurePython), &info) &&
      info.dli_fname) {
    root = info.dli_fname;
    for (int up = 0; up < 4; ++up) {
      size_t pos = root.find_last_of('/');
      if (pos == std::string::npos) break;
      root.resize(pos);
    }
  }
  std::string code =
      "import sys\n"
      "sys.path.insert(0, '" + root + "')\n"
      "import numpy as _np, ctypes as _ct\n"
      "import lightgbm_tpu_torch as _lgbt\n"
      "_lgbt_capi = {'next': 1, 'obj': {}}\n"
      "def _lgbt_np(a):\n"
      "    return a.detach().cpu().numpy() if hasattr(a, 'detach') "
      "else a\n"
      "def _lgbt_capi_call(fn, rc_addr, err_addr):\n"
      "    try:\n"
      "        fn()\n"
      "        _ct.c_int.from_address(rc_addr).value = 0\n"
      "    except Exception as e:\n"
      "        m = str(e).encode()[:4000] + b'\\0'\n"
      "        _ct.memmove(err_addr, m, len(m))\n"
      "        _ct.c_int.from_address(rc_addr).value = 1\n";
  if (g_pyrun(code.c_str()) != 0) {
    SetTrainError("training C API: interpreter bootstrap failed (is "
                  "lightgbm_tpu_torch importable next to the shared library?)");
    g_pyrun = nullptr;
    return false;
  }
  return true;
}

// Run `body` (python statements operating on _lgbt_capi) under the
// error-capture harness. Returns 0 on success, -1 with the python
// exception message in the shared error slot otherwise.
}  // namespace
extern "C" void* LgbmGetLogCallback();  // c_api.cpp
namespace {

// route the framework's python logger into a registered C callback
// (ref: c_api.h:82 LGBM_RegisterLogCallback). Synced lazily: the
// bridge re-registers whenever the callback pointer changes.
void SyncLogCallback() {
  static void* synced = nullptr;
  void* cb = LgbmGetLogCallback();
  if (cb == synced) return;
  synced = cb;
  if (!cb) {
    g_pyrun("import lightgbm_tpu_torch as _lt\n_lt.register_logger(None)\n");
    return;
  }
  char buf[512];
  std::snprintf(buf, sizeof(buf),
                "import ctypes as _ct2\n"
                "import lightgbm_tpu_torch as _lt\n"
                "_lgbt_logcb = _ct2.CFUNCTYPE(None, _ct2.c_char_p)"
                "(%llu)\n"
                "_lt.register_logger("
                "lambda m: _lgbt_logcb(str(m).encode()))\n",
                static_cast<unsigned long long>(
                    reinterpret_cast<uintptr_t>(cb)));
  g_pyrun(buf);
}

// ---- handle registry ---------------------------------------------------
struct TrainHandle {
  uint64_t id;
  bool is_booster;
  // per-handle lock: entry points serialize calls on the SAME handle
  // (a booster's engine state is not re-entrant) while independent
  // boosters/datasets proceed concurrently — the reference's
  // per-Booster lock semantics (ref: src/c_api.cpp:170 yamc
  // shared_mutex per Booster wrapper). Python-side dict/state access
  // is additionally GIL-serialized; true overlap happens where the
  // engine releases the GIL (torch compute, numpy).
  std::mutex mu;
};

std::mutex g_handles_mu;
std::set<TrainHandle*> g_handles;
uint64_t g_next_id = 1;

TrainHandle* NewHandle(bool is_booster) {
  std::lock_guard<std::mutex> lk(g_handles_mu);
  auto* h = new TrainHandle{g_next_id++, is_booster, {}};
  g_handles.insert(h);
  return h;
}

std::atomic<uint64_t> g_call_seq{1};

int RunGuarded(const std::string& body, TrainHandle* h = nullptr) {
  // Re-entrant across handles: only interpreter bootstrap is globally
  // serialized; each call gets stack-local result slots and a unique
  // harness function name, and locks only its own handle (single lock
  // per call — two-handle entry points lock the mutated handle only,
  // so there is no lock-order cycle).
  {
    static std::mutex init_mu;
    std::lock_guard<std::mutex> lk(init_mu);
    if (!EnsurePython()) return -1;
    SyncLogCallback();
  }
  std::unique_lock<std::mutex> hlk;
  if (h) hlk = std::unique_lock<std::mutex>(h->mu);
  int rc_slot = -9;
  char err_slot[4096];
  err_slot[0] = '\0';
  const uint64_t seq = g_call_seq.fetch_add(1, std::memory_order_relaxed);
  char fname[64];
  std::snprintf(fname, sizeof(fname), "_lgbt_tmp_fn_%llu",
                static_cast<unsigned long long>(seq));
  std::string indented;
  size_t start = 0;
  while (start <= body.size()) {
    size_t end = body.find('\n', start);
    if (end == std::string::npos) end = body.size();
    indented += "    " + body.substr(start, end - start) + "\n";
    start = end + 1;
  }
  char tail[256];
  std::snprintf(tail, sizeof(tail),
                "_lgbt_capi_call(%s, %llu, %llu)\n"
                "del %s\n",
                fname,
                static_cast<unsigned long long>(
                    reinterpret_cast<uintptr_t>(&rc_slot)),
                static_cast<unsigned long long>(
                    reinterpret_cast<uintptr_t>(err_slot)),
                fname);
  std::string code = std::string("def ") + fname + "():\n" +
                     indented + tail;
  if (g_pyrun(code.c_str()) != 0 || rc_slot != 0) {
    SetTrainError(err_slot[0] ? err_slot
                              : "training C API: python execution failed");
    return -1;
  }
  return 0;
}

TrainHandle* AsTrainHandle(void* p) {
  std::lock_guard<std::mutex> lk(g_handles_mu);
  auto it = g_handles.find(static_cast<TrainHandle*>(p));
  return it == g_handles.end() ? nullptr : *it;
}

void DropHandle(TrainHandle* h) {
  std::lock_guard<std::mutex> lk(g_handles_mu);
  g_handles.erase(h);
  delete h;
}

std::string Addr(const void* p) {
  char buf[32];
  std::snprintf(buf, sizeof(buf), "%llu",
                static_cast<unsigned long long>(
                    reinterpret_cast<uintptr_t>(p)));
  return buf;
}

std::string PyStr(const char* s) {
  std::string out = "'";
  for (const char* c = s ? s : ""; *c; ++c) {
    if (*c == '\'' || *c == '\\') out += '\\';
    if (*c == '\n') { out += "\\n"; continue; }
    out += *c;
  }
  out += "'";
  return out;
}

// python snippet: parse a "k=v k2=v2" / comma-separated parameter
// string into dict `p` (single definition — keep call sites in sync)
std::string ParamsDict(const char* parameters) {
  return "p = dict(kv.split('=', 1) for kv in " + PyStr(parameters) +
         ".replace(',', ' ').split() if '=' in kv)\n";
}

}  // namespace

// hooks shared with c_api.cpp (serving side routes through these)
extern "C" {

// 1 if `handle` belongs to the training registry.
int LgbmTrainOwns(void* handle) { return AsTrainHandle(handle) ? 1 : 0; }

void LgbmTrainSetError(const char* msg);  // provided by c_api.cpp

int LGBM_DatasetCreateFromMat(const void* data, int data_type,
                              int32_t nrow, int32_t ncol,
                              int is_row_major, const char* parameters,
                              const void* reference, void** out) {
  (void)reference;  // shared bin mappers not needed: binning re-runs
  if (!data || !out) {
    LgbmTrainSetError("DatasetCreateFromMat: null argument");
    return -1;
  }
  // C_API_DTYPE_FLOAT32 = 0, C_API_DTYPE_FLOAT64 = 1 (ref: c_api.h:33)
  if (data_type != 0 && data_type != 1) {
    LgbmTrainSetError("DatasetCreateFromMat: only float32 (0) / "
                      "float64 (1) data are supported");
    return -1;
  }
  const char* ct = data_type == 0 ? "_ct.c_float" : "_ct.c_double";
  TrainHandle* h = NewHandle(false);
  char idbuf[32];
  std::snprintf(idbuf, sizeof(idbuf), "%llu",
                static_cast<unsigned long long>(h->id));
  std::string body =
      std::string("n, f = ") + std::to_string(nrow) + ", " +
      std::to_string(ncol) + "\n" +
      "buf = (" + ct + " * (n * f)).from_address(" + Addr(data) + ")\n" +
      "a = _np.ctypeslib.as_array(buf).astype(_np.float64).copy()\n" +
      (is_row_major ? "a = a.reshape(n, f)\n"
                    : "a = a.reshape(f, n).T.copy()\n") +
      ParamsDict(parameters) +
      "_lgbt_capi['obj'][" + idbuf + "] = {'X': a, 'params': p, "
      "'fields': {}}\n";
  if (RunGuarded(body) != 0) {
    DropHandle(h);
    return -1;
  }
  *out = h;
  return 0;
}

int LGBM_DatasetSetField(void* handle, const char* field_name,
                         const void* field_data, int32_t num_element,
                         int data_type) {
  TrainHandle* h = AsTrainHandle(handle);
  if (!h || h->is_booster) {
    LgbmTrainSetError("DatasetSetField: not a training Dataset handle");
    return -1;
  }
  // C_API_DTYPE: 0=f32 1=f64 2=i32 3=i64 (ref: c_api.h:33-41)
  const char* ct = data_type == 0   ? "_ct.c_float"
                   : data_type == 1 ? "_ct.c_double"
                   : data_type == 2 ? "_ct.c_int32"
                                    : "_ct.c_int64";
  std::string body =
      std::string("buf = (") + ct + " * " + std::to_string(num_element) +
      ").from_address(" + Addr(field_data) + ")\n" +
      "v = _np.ctypeslib.as_array(buf).copy()\n" +
      "_lgbt_capi['obj'][" + std::to_string(h->id) + "]['fields'][" +
      PyStr(field_name) + "] = v\n";
  return RunGuarded(body, h);
}

int LGBM_DatasetGetNumData(void* handle, int32_t* out) {
  TrainHandle* h = AsTrainHandle(handle);
  if (!h || h->is_booster || !out) {
    LgbmTrainSetError("DatasetGetNumData: not a training Dataset handle");
    return -1;
  }
  std::string body =
      "_ct.c_int32.from_address(" + Addr(out) + ").value = "
      "_lgbt_capi['obj'][" + std::to_string(h->id) + "]['X'].shape[0]\n";
  return RunGuarded(body, h);
}

int LGBM_DatasetGetNumFeature(void* handle, int32_t* out) {
  TrainHandle* h = AsTrainHandle(handle);
  if (!h || h->is_booster || !out) {
    LgbmTrainSetError("DatasetGetNumFeature: not a training Dataset handle");
    return -1;
  }
  std::string body =
      "_ct.c_int32.from_address(" + Addr(out) + ").value = "
      "_lgbt_capi['obj'][" + std::to_string(h->id) + "]['X'].shape[1]\n";
  return RunGuarded(body, h);
}

int LGBM_DatasetFree(void* handle) {
  TrainHandle* h = AsTrainHandle(handle);
  if (!h || h->is_booster) {
    LgbmTrainSetError("DatasetFree: not a training Dataset handle");
    return -1;
  }
  std::string body = "_lgbt_capi['obj'].pop(" + std::to_string(h->id) +
                     ", None)\n";
  int rc = RunGuarded(body, h);
  DropHandle(h);
  return rc;
}

int LGBM_DatasetCreateFromFile(const char* filename,
                               const char* parameters,
                               const void* reference, void** out) {
  (void)reference;
  if (!filename || !out) {
    LgbmTrainSetError("DatasetCreateFromFile: null argument");
    return -1;
  }
  TrainHandle* h = NewHandle(false);
  std::string body =
      "from lightgbm_tpu_torch.io.file_loader import load_svm_or_csv\n"
      "from lightgbm_tpu_torch.config import Config\n"
      "p = dict(kv.split('=', 1) for kv in " + PyStr(parameters) +
      ".replace(',', ' ').split() if '=' in kv)\n"
      "X, y, w, g = load_svm_or_csv(" + PyStr(filename) +
      ", Config(dict(p)))\n"
      "fl = {}\n"
      "if y is not None: fl['label'] = y\n"
      "if w is not None: fl['weight'] = w\n"
      "if g is not None: fl['group'] = g\n"
      "_lgbt_capi['obj'][" + std::to_string(h->id) + "] = "
      "{'X': X, 'params': p, 'fields': fl}\n";
  if (RunGuarded(body) != 0) {
    DropHandle(h);
    return -1;
  }
  *out = h;
  return 0;
}

namespace {

// shared python snippet: rebuild a scipy CSR from raw buffers
std::string CsrFromBuffers(const void* indptr, int indptr_type,
                           const int32_t* indices, const void* data,
                           int data_type, int64_t nindptr, int64_t nelem,
                           int64_t num_col) {
  const char* it = indptr_type == 2 ? "_ct.c_int32" : "_ct.c_int64";
  const char* dt = data_type == 0 ? "_ct.c_float" : "_ct.c_double";
  return std::string("import scipy.sparse as _sp\n") +
         "ip = _np.ctypeslib.as_array((" + it + " * " +
         std::to_string(nindptr) + ").from_address(" + Addr(indptr) +
         ")).copy()\n" +
         "ix = _np.ctypeslib.as_array((_ct.c_int32 * " +
         std::to_string(nelem) + ").from_address(" + Addr(indices) +
         ")).copy()\n" +
         "dv = _np.ctypeslib.as_array((" + dt + " * " +
         std::to_string(nelem) + ").from_address(" + Addr(data) +
         ")).astype(_np.float64).copy()\n" +
         "csr = _sp.csr_matrix((dv, ix, ip), shape=(" +
         std::to_string(nindptr - 1) + ", " + std::to_string(num_col) +
         "))\n";
}

}  // namespace

int LGBM_DatasetCreateFromCSR(const void* indptr, int indptr_type,
                              const int32_t* indices, const void* data,
                              int data_type, int64_t nindptr,
                              int64_t nelem, int64_t num_col,
                              const char* parameters,
                              const void* reference, void** out) {
  (void)reference;
  if (!indptr || !indices || !data || !out) {
    LgbmTrainSetError("DatasetCreateFromCSR: null argument");
    return -1;
  }
  if ((indptr_type != 2 && indptr_type != 3) ||
      (data_type != 0 && data_type != 1)) {
    LgbmTrainSetError("DatasetCreateFromCSR: indptr must be int32/int64 "
                      "(2/3), data float32/float64 (0/1)");
    return -1;
  }
  TrainHandle* h = NewHandle(false);
  std::string body =
      CsrFromBuffers(indptr, indptr_type, indices, data, data_type,
                     nindptr, nelem, num_col) +
      ParamsDict(parameters) +
      "_lgbt_capi['obj'][" + std::to_string(h->id) + "] = "
      "{'X': csr, 'params': p, 'fields': {}}\n";
  if (RunGuarded(body) != 0) {
    DropHandle(h);
    return -1;
  }
  *out = h;
  return 0;
}

int LGBM_DatasetCreateFromCSRFunc(void* get_row_funptr, int num_rows,
                                  int64_t num_col, const char* parameters,
                                  const void* reference, void** out) {
  // ref: include/LightGBM/c_api.h:436 / src/c_api.cpp:1487 — the
  // row-iterator variant used by the SWIG wrapper: get_row_funptr is a
  // pointer to a C++ std::function<void(int, vector<pair<int,double>>&)>
  // producing one sparse row per call. Rows are materialized into CSR
  // once (two passes are unnecessary: the vectors grow amortized) and
  // handed to the buffer-based CSR ingest above.
  if (!get_row_funptr || !out || num_rows < 0) {
    LgbmTrainSetError("DatasetCreateFromCSRFunc: null/invalid argument");
    return -1;
  }
  if (num_col <= 0 || num_col >= INT32_MAX) {
    LgbmTrainSetError("DatasetCreateFromCSRFunc: num_col out of range");
    return -1;
  }
  auto& get_row = *static_cast<
      std::function<void(int, std::vector<std::pair<int, double>>&)>*>(
      get_row_funptr);
  std::vector<int64_t> indptr(static_cast<size_t>(num_rows) + 1, 0);
  std::vector<int32_t> cols;
  std::vector<double> vals;
  std::vector<std::pair<int, double>> buffer;
  try {
    for (int r = 0; r < num_rows; ++r) {
      buffer.clear();
      get_row(r, buffer);
      for (const auto& kv : buffer) {
        if (kv.first < 0 || kv.first >= num_col) {
          LgbmTrainSetError("DatasetCreateFromCSRFunc: column index "
                            "out of range");
          return -1;
        }
        cols.push_back(static_cast<int32_t>(kv.first));
        vals.push_back(kv.second);
      }
      indptr[static_cast<size_t>(r) + 1] =
          static_cast<int64_t>(cols.size());
    }
  } catch (const std::exception& e) {
    LgbmTrainSetError(
        (std::string("DatasetCreateFromCSRFunc: row callback threw: ") +
         e.what()).c_str());
    return -1;
  }
  return LGBM_DatasetCreateFromCSR(
      indptr.data(), 3 /*int64*/, cols.data(), vals.data(),
      1 /*float64*/, static_cast<int64_t>(indptr.size()),
      static_cast<int64_t>(vals.size()), num_col, parameters, reference,
      out);
}

int LGBM_BoosterCreate(void* train_data, const char* parameters,
                       void** out) {
  TrainHandle* d = AsTrainHandle(train_data);
  if (!d || d->is_booster || !out) {
    LgbmTrainSetError("BoosterCreate: train_data is not a training "
                      "Dataset handle");
    return -1;
  }
  TrainHandle* h = NewHandle(true);
  std::string did = std::to_string(d->id), bid = std::to_string(h->id);
  std::string body =
      "d = _lgbt_capi['obj'][" + did + "]\n" +
      "p = dict(d['params'])\n" +
      "p.update(kv.split('=', 1) for kv in " + PyStr(parameters) +
      ".replace(',', ' ').split() if '=' in kv)\n" +
      "fl = d['fields']\n" +
      "grp = fl.get('group')\n" +
      "if grp is not None and grp.dtype != _np.int32:\n" +
      "    grp = grp.astype(_np.int32)\n" +
      "ds = _lgbt.Dataset(d['X'], label=fl.get('label'), "
      "weight=fl.get('weight'), group=grp, "
      "init_score=fl.get('init_score'), "
      "feature_name=d.get('feature_names', 'auto'), params=p)\n" +
      "_lgbt_capi['obj'][" + bid + "] = {'booster': _lgbt.Booster(p, ds), "
      "'finished': False}\n";
  if (RunGuarded(body, d) != 0) {
    DropHandle(h);
    return -1;
  }
  *out = h;
  return 0;
}

int LGBM_BoosterUpdateOneIter(void* handle, int* is_finished) {
  TrainHandle* h = AsTrainHandle(handle);
  if (!h || !h->is_booster || !is_finished) {
    LgbmTrainSetError("BoosterUpdateOneIter: not a training Booster handle");
    return -1;
  }
  std::string body =
      "b = _lgbt_capi['obj'][" + std::to_string(h->id) + "]\n" +
      "fin = b['booster'].update()\n" +
      "b['finished'] = bool(fin)\n" +
      "_ct.c_int.from_address(" + Addr(is_finished) +
      ").value = 1 if fin else 0\n";
  return RunGuarded(body, h);
}

int LGBM_BoosterAddValidData(void* handle, void* valid_data) {
  TrainHandle* h = AsTrainHandle(handle);
  TrainHandle* d = AsTrainHandle(valid_data);
  if (!h || !h->is_booster || !d || d->is_booster) {
    LgbmTrainSetError("BoosterAddValidData: bad handle(s)");
    return -1;
  }
  std::string body =
      "v = _lgbt_capi['obj'][" + std::to_string(d->id) + "]\n" +
      "b = _lgbt_capi['obj'][" + std::to_string(h->id) + "]\n" +
      "fl = v['fields']\n" +
      "grp = fl.get('group')\n" +
      "if grp is not None and grp.dtype != _np.int32:\n" +
      "    grp = grp.astype(_np.int32)\n" +
      "ds = _lgbt.Dataset(v['X'], label=fl.get('label'), "
      "weight=fl.get('weight'), group=grp, "
      "reference=b['booster'].train_set)\n" +
      "b['booster'].add_valid(ds, 'valid_' + str(len(b.setdefault("
      "'valids', [])) ))\n" +
      "b['valids'].append(ds)\n";
  return RunGuarded(body, h);
}

int LGBM_BoosterGetEval(void* handle, int data_idx, int* out_len,
                        double* out_results) {
  TrainHandle* h = AsTrainHandle(handle);
  if (!h || !h->is_booster || !out_len || !out_results) {
    LgbmTrainSetError("BoosterGetEval: not a training Booster handle");
    return -1;
  }
  std::string body =
      "b = _lgbt_capi['obj'][" + std::to_string(h->id) + "]['booster']\n" +
      "res = (b.eval_train() if " + std::to_string(data_idx) +
      " == 0 else b.eval_valid())\n" +
      "want = " + std::to_string(data_idx) + "\n" +
      "vals = [r[2] for r in res if want == 0 or "
      "r[0] == 'valid_' + str(want - 1)]\n" +
      "a = _np.asarray(vals, _np.float64)\n" +
      "_ct.c_int.from_address(" + Addr(out_len) +
      ").value = a.size\n" +
      "if a.size:\n" +
      "    _ct.memmove(" + Addr(out_results) +
      ", a.ctypes.data, a.size * 8)\n";
  return RunGuarded(body, h);
}

int LGBM_BoosterGetEvalCounts(void* handle, int* out_len) {
  TrainHandle* h = AsTrainHandle(handle);
  if (!h || !h->is_booster || !out_len) {
    LgbmTrainSetError("BoosterGetEvalCounts: not a training Booster "
                      "handle");
    return -1;
  }
  std::string body =
      "b = _lgbt_capi['obj'][" + std::to_string(h->id) + "]['booster']\n" +
      "_ct.c_int.from_address(" + Addr(out_len) +
      ").value = len(b.eval_train())\n";
  return RunGuarded(body, h);
}

namespace {
int CopyNameList(const std::string& names_expr, uint64_t obj_id,
                 int len, int* out_len, size_t buffer_len,
                 size_t* out_buffer_len, char** out_strs);
}  // namespace

int LGBM_BoosterGetEvalNames(void* handle, const int len,
                             int* out_len, const size_t buffer_len,
                             size_t* out_buffer_len, char** out_strs) {
  TrainHandle* h = AsTrainHandle(handle);
  if (!h || !h->is_booster || !out_len || !out_buffer_len) {
    LgbmTrainSetError("BoosterGetEvalNames: not a training Booster "
                      "handle");
    return -1;
  }
  // reference two-call sizing protocol via the shared per-call-buffer
  // name-list copier (no static scratch, no size cap)
  return CopyNameList("[r[1] for r in o['booster'].eval_train()]",
                      h->id, len, out_len, buffer_len, out_buffer_len,
                      out_strs);
}

int LGBM_BoosterSaveModel(void* handle, int start_iteration,
                          int num_iteration, int feature_importance_type,
                          const char* filename) {
  TrainHandle* h = AsTrainHandle(handle);
  if (!h || !h->is_booster) {
    LgbmTrainSetError("BoosterSaveModel: not a training Booster handle");
    return -1;
  }
  std::string body =
      "b = _lgbt_capi['obj'][" + std::to_string(h->id) + "]['booster']\n" +
      "b.save_model(" + PyStr(filename) + ", num_iteration=" +
      (num_iteration > 0 ? std::to_string(num_iteration) : "None") +
      ", start_iteration=" + std::to_string(start_iteration > 0
                                                ? start_iteration
                                                : 0) +
      ", importance_type=" +
      (feature_importance_type == 1 ? "'gain'" : "'split'") + ")\n";
  return RunGuarded(body, h);
}

namespace {

// shared python snippet: the engine-side raw score of train (idx 0) or
// the (idx-1)-th valid set, flattened [K*N] f64 as variable `sc`
std::string ScoreSnippet(uint64_t id, int data_idx) {
  std::string eng = "_e = _lgbt_capi['obj'][" + std::to_string(id) +
                    "]['booster']._engine\n";
  if (data_idx == 0)
    return eng + "sc = _np.asarray(_lgbt_np(_e.score), _np.float64)"
                 ".reshape(-1)\n";
  return eng + "sc = _np.asarray(_lgbt_np(_e.valid_sets[" +
         std::to_string(data_idx - 1) +
         "].score), _np.float64).reshape(-1)\n";
}

}  // namespace

int LGBM_BoosterGetNumPredict(void* handle, int data_idx,
                              int64_t* out_len) {
  TrainHandle* h = AsTrainHandle(handle);
  if (!h || !h->is_booster || !out_len) {
    LgbmTrainSetError("BoosterGetNumPredict: not a training Booster "
                      "handle");
    return -1;
  }
  std::string body =
      ScoreSnippet(h->id, data_idx) +
      "_ct.c_int64.from_address(" + Addr(out_len) +
      ").value = sc.size\n";
  return RunGuarded(body, h);
}

int LGBM_BoosterGetPredict(void* handle, int data_idx, int64_t* out_len,
                           double* out_result) {
  TrainHandle* h = AsTrainHandle(handle);
  if (!h || !h->is_booster || !out_len || !out_result) {
    LgbmTrainSetError("BoosterGetPredict: not a training Booster handle");
    return -1;
  }
  std::string body =
      ScoreSnippet(h->id, data_idx) +
      "_ct.c_int64.from_address(" + Addr(out_len) +
      ").value = sc.size\n" +
      "_ct.memmove(" + Addr(out_result) +
      ", _np.ascontiguousarray(sc).ctypes.data, sc.size * 8)\n";
  return RunGuarded(body, h);
}

int LGBM_BoosterGetLeafValue(void* handle, int tree_idx, int leaf_idx,
                             double* out_val) {
  TrainHandle* h = AsTrainHandle(handle);
  if (!h || !h->is_booster || !out_val) {
    LgbmTrainSetError("BoosterGetLeafValue: not a training Booster handle");
    return -1;
  }
  std::string body =
      "b = _lgbt_capi['obj'][" + std::to_string(h->id) + "]['booster']\n" +
      "_ct.c_double.from_address(" + Addr(out_val) + ").value = "
      "float(b.get_leaf_output(" + std::to_string(tree_idx) + ", " +
      std::to_string(leaf_idx) + "))\n";
  return RunGuarded(body, h);
}

int LGBM_BoosterSetLeafValue(void* handle, int tree_idx, int leaf_idx,
                             double val) {
  TrainHandle* h = AsTrainHandle(handle);
  if (!h || !h->is_booster) {
    LgbmTrainSetError("BoosterSetLeafValue: not a training Booster handle");
    return -1;
  }
  char vbuf[40];
  std::snprintf(vbuf, sizeof(vbuf), "%.17g", val);
  std::string body =
      "b = _lgbt_capi['obj'][" + std::to_string(h->id) + "]['booster']\n" +
      "b.set_leaf_output(" + std::to_string(tree_idx) + ", " +
      std::to_string(leaf_idx) + ", " + vbuf + ")\n";
  return RunGuarded(body, h);
}

int LGBM_BoosterRefit(void* handle, const double* leaf_preds,
                      int32_t nrow, int32_t ncol) {
  // the reference refits from externally computed leaf predictions
  // (c_api.h:821); this engine refits from the booster's own training
  // data (Booster.refit semantics), recomputing the traversal itself —
  // the leaf_preds buffer and its shape are ignored
  (void)leaf_preds;
  (void)nrow;
  (void)ncol;
  TrainHandle* h = AsTrainHandle(handle);
  if (!h || !h->is_booster) {
    LgbmTrainSetError("BoosterRefit: not a training Booster handle");
    return -1;
  }
  std::string body =
      "b = _lgbt_capi['obj'][" + std::to_string(h->id) + "]['booster']\n" +
      "ts = b.train_set\n" +
      "if ts is None or ts.data is None:\n" +
      "    raise ValueError('refit needs the training data; construct "
      "the Dataset with free_raw_data=False')\n" +
      "b2 = b.refit(ts.data, ts.label)\n" +
      "_lgbt_capi['obj'][" + std::to_string(h->id) +
      "]['booster'] = b2\n";
  return RunGuarded(body, h);
}

int LGBM_BoosterRollbackOneIter(void* handle) {
  TrainHandle* h = AsTrainHandle(handle);
  if (!h || !h->is_booster) {
    LgbmTrainSetError("BoosterRollbackOneIter: not a training Booster "
                      "handle");
    return -1;
  }
  std::string body =
      "_lgbt_capi['obj'][" + std::to_string(h->id) +
      "]['booster'].rollback_one_iter()\n";
  return RunGuarded(body, h);
}

int LgbmTrainBoosterIntProp(void* handle, const char* prop, int* out);

int LGBM_BoosterNumberOfTotalModel(void* handle, int* out_models) {
  TrainHandle* h = AsTrainHandle(handle);
  if (!h || !h->is_booster || !out_models) {
    LgbmTrainSetError("BoosterNumberOfTotalModel: not a training Booster "
                      "handle");
    return -1;
  }
  return LgbmTrainBoosterIntProp(handle, "b.num_trees()", out_models);
}

int LGBM_BoosterSaveModelToString(void* handle, int start_iteration,
                                  int num_iteration,
                                  int feature_importance_type,
                                  int64_t buffer_len, int64_t* out_len,
                                  char* out_str) {
  TrainHandle* h = AsTrainHandle(handle);
  if (!h || !h->is_booster || !out_len) {
    LgbmTrainSetError("BoosterSaveModelToString: not a training Booster "
                      "handle");
    return -1;
  }
  std::string body =
      "b = _lgbt_capi['obj'][" + std::to_string(h->id) + "]['booster']\n" +
      "s = b.model_to_string(num_iteration=" +
      (num_iteration > 0 ? std::to_string(num_iteration) : "None") +
      ", start_iteration=" + std::to_string(
          start_iteration > 0 ? start_iteration : 0) +
      ", importance_type=" +
      (feature_importance_type == 1 ? "'gain'" : "'split'") +
      ").encode() + b'\\0'\n" +
      "_ct.c_int64.from_address(" + Addr(out_len) +
      ").value = len(s)\n" +
      (out_str ? std::string("_ct.memmove(") + Addr(out_str) +
                     ", s, min(len(s), " + std::to_string(buffer_len) +
                     "))\n"
               : std::string()) +
      (out_str && buffer_len > 0
           ? "_ct.c_char.from_address(" +
                 Addr(out_str + (buffer_len - 1)) + ").value = b'\\0'\n"
           : std::string());
  return RunGuarded(body, h);
}

// ---- training-handle implementations used by c_api.cpp routers ---------

int LgbmTrainBoosterFree(void* handle) {
  TrainHandle* h = AsTrainHandle(handle);
  if (!h) return -1;
  std::string body = "_lgbt_capi['obj'].pop(" + std::to_string(h->id) +
                     ", None)\n";
  int rc = RunGuarded(body, h);
  DropHandle(h);
  return rc;
}

int LgbmTrainBoosterIntProp(void* handle, const char* prop, int* out) {
  TrainHandle* h = AsTrainHandle(handle);
  if (!h || !h->is_booster || !out) return -1;
  std::string body =
      "b = _lgbt_capi['obj'][" + std::to_string(h->id) + "]['booster']\n" +
      "_ct.c_int.from_address(" + Addr(out) + ").value = int(" + prop +
      ")\n";
  return RunGuarded(body, h);
}

int LgbmTrainBoosterPredictForMat(void* handle, const void* data,
                                  int data_type, int32_t nrow,
                                  int32_t ncol, int is_row_major,
                                  int predict_type, int start_iteration,
                                  int num_iteration, int64_t* out_len,
                                  double* out_result) {
  TrainHandle* h = AsTrainHandle(handle);
  if (!h || !h->is_booster || !out_len || !out_result) return -1;
  if (data_type != 0 && data_type != 1) {
    LgbmTrainSetError("PredictForMat: only float32 (0) / float64 (1) "
                      "data are supported");
    return -1;
  }
  const char* ct = data_type == 0 ? "_ct.c_float" : "_ct.c_double";
  // C_API_PREDICT_NORMAL=0 RAW_SCORE=1 LEAF_INDEX=2 CONTRIB=3
  std::string kw = predict_type == 1   ? "raw_score=True"
                   : predict_type == 2 ? "pred_leaf=True"
                   : predict_type == 3 ? "pred_contrib=True"
                                       : "";
  std::string body =
      std::string("n, f = ") + std::to_string(nrow) + ", " +
      std::to_string(ncol) + "\n" +
      "buf = (" + ct + " * (n * f)).from_address(" + Addr(data) + ")\n" +
      "a = _np.ctypeslib.as_array(buf).astype(_np.float64).copy()\n" +
      (is_row_major ? "a = a.reshape(n, f)\n"
                    : "a = a.reshape(f, n).T.copy()\n") +
      "b = _lgbt_capi['obj'][" + std::to_string(h->id) + "]['booster']\n" +
      "pred = _np.ascontiguousarray(b.predict(a" +
      ", start_iteration=" + std::to_string(
          start_iteration > 0 ? start_iteration : 0) +
      (num_iteration > 0
           ? ", num_iteration=" + std::to_string(num_iteration)
           : "") +
      (kw.empty() ? "" : ", " + kw) + "), dtype=_np.float64)\n" +
      "_ct.c_int64.from_address(" + Addr(out_len) +
      ").value = pred.size\n" +
      "_ct.memmove(" + Addr(out_result) +
      ", pred.ctypes.data, pred.size * 8)\n";
  return RunGuarded(body, h);
}

int LgbmTrainBoosterPredictForCSR(void* handle, const void* indptr,
                                  int indptr_type, const int32_t* indices,
                                  const void* data, int data_type,
                                  int64_t nindptr, int64_t nelem,
                                  int64_t num_col, int predict_type,
                                  int start_iteration, int num_iteration,
                                  int64_t* out_len, double* out_result) {
  TrainHandle* h = AsTrainHandle(handle);
  if (!h || !h->is_booster || !out_len || !out_result) return -1;
  if ((indptr_type != 2 && indptr_type != 3) ||
      (data_type != 0 && data_type != 1)) {
    LgbmTrainSetError("PredictForCSR: indptr must be int32/int64 (2/3), "
                      "data float32/float64 (0/1)");
    return -1;
  }
  std::string kw = predict_type == 1   ? "raw_score=True"
                   : predict_type == 2 ? "pred_leaf=True"
                   : predict_type == 3 ? "pred_contrib=True"
                                       : "";
  std::string body =
      CsrFromBuffers(indptr, indptr_type, indices, data, data_type,
                     nindptr, nelem, num_col) +
      "b = _lgbt_capi['obj'][" + std::to_string(h->id) + "]['booster']\n" +
      "pred = b.predict(csr, start_iteration=" +
      std::to_string(start_iteration > 0 ? start_iteration : 0) +
      (num_iteration > 0
           ? ", num_iteration=" + std::to_string(num_iteration)
           : "") +
      (kw.empty() ? "" : ", " + kw) + ")\n" +
      "if _sp.issparse(pred): pred = pred.toarray()\n" +
      "pred = _np.ascontiguousarray(pred, dtype=_np.float64)\n" +
      "_ct.c_int64.from_address(" + Addr(out_len) +
      ").value = pred.size\n" +
      "_ct.memmove(" + Addr(out_result) +
      ", pred.ctypes.data, pred.size * 8)\n";
  return RunGuarded(body, h);
}

int LGBM_DatasetGetField(void* handle, const char* field_name,
                         int* out_len, const void** out_ptr,
                         int* out_type) {
  // ref: c_api.cpp LGBM_DatasetGetField — the returned buffer is owned
  // by the Dataset (here: pinned in the embedded interpreter under
  // 'fields_c') and stays valid until the handle is freed
  TrainHandle* h = AsTrainHandle(handle);
  if (!h || h->is_booster || !out_len || !out_ptr || !out_type) {
    LgbmTrainSetError("DatasetGetField: not a training Dataset handle");
    return -1;
  }
  // per-call result slots (stack addresses embedded in the generated
  // code): concurrent callers each write their own frame — the reference
  // documents these getters as thread-safe (ref: c_api.cpp shared_lock
  // Booster pattern)
  int64_t ptr_slot = 0;
  int32_t len_slot = 0, type_slot = 0;
  std::string body =
      "d = _lgbt_capi['obj'][" + std::to_string(h->id) + "]\n" +
      "fn = " + PyStr(field_name) + "\n" +
      "cache = d.setdefault('fields_c', {})\n" +
      // the cached conversion is REUSED so previously returned pointers
      // stay valid until the handle is freed (reference buffer-ownership
      // semantics); rebuilding each call would free the old buffer under
      // a caller still holding it
      "if fn not in cache:\n" +
      "    v = d['fields'].get(fn)\n" +
      "    if v is None: raise KeyError('field not set: ' + fn)\n" +
      // reference field dtypes: label/weight f32, group int32
      // boundaries, init_score f64 (C_API_DTYPE codes 0/2/1). 'group'
      // is SET as per-query sizes but READ as cumulative boundaries of
      // length num_queries+1 (ref: c_api.cpp DatasetGetField -> "
      // query boundaries; the reference python wrapper np.diff()s it)
      "    if fn == 'init_score': v = v.astype(_np.float64); t = 1\n" +
      "    elif fn == 'group':\n" +
      "        v = _np.concatenate([[0], _np.cumsum(v)])"
      ".astype(_np.int32); t = 2\n" +
      "    else: v = v.astype(_np.float32); t = 0\n" +
      "    cache[fn] = (_np.ascontiguousarray(v), t)\n" +
      "v, t = cache[fn]\n" +
      "_ct.c_int64.from_address(" + Addr(&ptr_slot) +
      ").value = v.ctypes.data\n" +
      "_ct.c_int32.from_address(" + Addr(&len_slot) +
      ").value = v.size\n" +
      "_ct.c_int32.from_address(" + Addr(&type_slot) + ").value = t\n";
  if (RunGuarded(body, h) != 0) return -1;
  *out_ptr = reinterpret_cast<const void*>(
      static_cast<uintptr_t>(ptr_slot));
  *out_len = len_slot;
  *out_type = type_slot;
  return 0;
}

int LGBM_DatasetSetFeatureNames(void* handle, const char** feature_names,
                                int num_feature_names) {
  TrainHandle* h = AsTrainHandle(handle);
  if (!h || h->is_booster || !feature_names) {
    LgbmTrainSetError("DatasetSetFeatureNames: bad handle");
    return -1;
  }
  std::string names = "[";
  for (int i = 0; i < num_feature_names; ++i)
    names += PyStr(feature_names[i]) + ",";
  names += "]";
  std::string body =
      "_lgbt_capi['obj'][" + std::to_string(h->id) +
      "]['feature_names'] = " + names + "\n";
  return RunGuarded(body, h);
}

namespace {

// two-call sizing protocol shared by the *NameLists (ref: c_api.cpp
// LGBM_DatasetGetFeatureNames / BoosterGetFeatureNames). One interpreter
// pass gathers all names into a scratch blob (the GetEvalNames pattern);
// the C side copies into the caller's string array.
int CopyNameList(const std::string& names_expr, uint64_t obj_id,
                 const int len, int* out_len, const size_t buffer_len,
                 size_t* out_buffer_len, char** out_strs) {
  // Two interpreter passes with PER-CALL slots (no static scratch, no
  // size cap): pass 1 builds the blob, stashes it under a key unique to
  // this call frame and reports its size; pass 2 copies it into a
  // right-sized heap buffer and drops the stash. Concurrent callers
  // write distinct stack slots / stash keys, so the post-guard reads
  // race with nothing.
  int64_t blob_len = 0;
  int32_t n_slot = 0;
  const std::string key = "'nameblob_" + Addr(&blob_len) + "'";
  std::string body1 =
      "o = _lgbt_capi['obj'][" + std::to_string(obj_id) + "]\n" +
      "names = " + names_expr + "\n" +
      "blob = b'\\0'.join(n.encode() for n in names) + b'\\0\\0'\n" +
      "_lgbt_capi[" + key + "] = blob\n" +
      "_ct.c_int64.from_address(" + Addr(&blob_len) +
      ").value = len(blob)\n" +
      "_ct.c_int32.from_address(" + Addr(&n_slot) +
      ").value = len(names)\n";
  if (RunGuarded(body1) != 0) return -1;
  std::vector<char> scratch(static_cast<size_t>(blob_len) + 2, '\0');
  std::string body2 =
      "blob = _lgbt_capi.pop(" + key + ")\n" +
      "_ct.memmove(" + Addr(scratch.data()) + ", blob, len(blob))\n";
  if (RunGuarded(body2) != 0) return -1;
  *out_len = n_slot;
  size_t max_needed = 1;
  const char* p = scratch.data();
  for (int i = 0; i < n_slot; ++i) {
    size_t l = std::strlen(p);
    if (l + 1 > max_needed) max_needed = l + 1;
    if (out_strs && i < len && out_strs[i])
      std::snprintf(out_strs[i], buffer_len, "%s", p);
    p += l + 1;
  }
  *out_buffer_len = max_needed;
  return 0;
}

}  // namespace

int LGBM_DatasetGetFeatureNames(void* handle, const int len,
                                int* out_len, const size_t buffer_len,
                                size_t* out_buffer_len, char** out_strs) {
  TrainHandle* h = AsTrainHandle(handle);
  if (!h || h->is_booster || !out_len || !out_buffer_len) {
    LgbmTrainSetError("DatasetGetFeatureNames: bad handle");
    return -1;
  }
  return CopyNameList(
      "o.get('feature_names') or ['Column_' + str(i) for i in "
      "range(o['X'].shape[1])]",
      h->id, len, out_len, buffer_len, out_buffer_len, out_strs);
}

int LgbmTrainBoosterGetFeatureNames(void* handle, const int len,
                                    int* out_len,
                                    const size_t buffer_len,
                                    size_t* out_buffer_len,
                                    char** out_strs) {
  TrainHandle* h = AsTrainHandle(handle);
  if (!h || !h->is_booster || !out_len || !out_buffer_len) {
    LgbmTrainSetError("BoosterGetFeatureNames: not a training Booster");
    return -1;
  }
  return CopyNameList("list(o['booster'].feature_name())", h->id, len,
                      out_len, buffer_len, out_buffer_len, out_strs);
}

int LGBM_DatasetSaveBinary(void* handle, const char* filename) {
  TrainHandle* h = AsTrainHandle(handle);
  if (!h || h->is_booster || !filename) {
    LgbmTrainSetError("DatasetSaveBinary: bad handle");
    return -1;
  }
  std::string body =
      "d = _lgbt_capi['obj'][" + std::to_string(h->id) + "]\n" +
      "fl = d['fields']\n" +
      "grp = fl.get('group')\n" +
      "if grp is not None and grp.dtype != _np.int32:\n" +
      "    grp = grp.astype(_np.int32)\n" +
      "ds = _lgbt.Dataset(d['X'], label=fl.get('label'), "
      "weight=fl.get('weight'), group=grp, "
      "init_score=fl.get('init_score'), "
      "feature_name=d.get('feature_names', 'auto'), "
      "params=dict(d['params']))\n" +
      "ds.save_binary(" + PyStr(filename) + ")\n";
  return RunGuarded(body, h);
}

int LGBM_BoosterUpdateOneIterCustom(void* handle, const float* grad,
                                    const float* hess, int* is_finished) {
  // ref: c_api.h:823 — one boosting step from caller-supplied
  // gradients/hessians (size num_data * num_models_per_iteration)
  TrainHandle* h = AsTrainHandle(handle);
  if (!h || !h->is_booster || !grad || !hess || !is_finished) {
    LgbmTrainSetError("BoosterUpdateOneIterCustom: bad argument(s)");
    return -1;
  }
  std::string body =
      "b = _lgbt_capi['obj'][" + std::to_string(h->id) + "]\n" +
      "eng = b['booster']._engine\n" +
      "n = eng.num_data * eng.num_tree_per_iteration\n" +
      "g = _np.ctypeslib.as_array((_ct.c_float * n).from_address(" +
      Addr(grad) + ")).copy()\n" +
      "hs = _np.ctypeslib.as_array((_ct.c_float * n).from_address(" +
      Addr(hess) + ")).copy()\n" +
      "fin = eng.train_one_iter(g, hs)\n" +
      "b['finished'] = bool(fin)\n" +
      "_ct.c_int.from_address(" + Addr(is_finished) +
      ").value = 1 if fin else 0\n";
  return RunGuarded(body, h);
}

int LGBM_BoosterResetParameter(void* handle, const char* parameters) {
  TrainHandle* h = AsTrainHandle(handle);
  if (!h || !h->is_booster) {
    LgbmTrainSetError("BoosterResetParameter: not a training Booster");
    return -1;
  }
  std::string body =
      "b = _lgbt_capi['obj'][" + std::to_string(h->id) + "]\n" +
      ParamsDict(parameters) +
      "b['booster'].reset_parameter(p)\n";
  return RunGuarded(body, h);
}

int LgbmTrainBoosterCalcNumPredict(void* handle, int num_row,
                                   int predict_type, int start_iteration,
                                   int num_iteration, int64_t* out_len) {
  // ref: c_api.cpp LGBM_BoosterCalcNumPredict — result buffer size for
  // a PredictForMat call with these settings
  TrainHandle* h = AsTrainHandle(handle);
  if (!h || !h->is_booster || !out_len) {
    LgbmTrainSetError("BoosterCalcNumPredict: not a training Booster");
    return -1;
  }
  std::string body =
      "b = _lgbt_capi['obj'][" + std::to_string(h->id) + "]['booster']\n" +
      "K = max(b._engine.num_tree_per_iteration, 1)\n" +
      "n_it = b.current_iteration()\n" +
      "si = min(max(" + std::to_string(start_iteration) +
      ", 0), n_it)\n" +
      "ni = " + std::to_string(num_iteration) + "\n" +
      "ni = n_it - si if ni <= 0 else min(ni, n_it - si)\n" +
      "ni = max(ni, 0)\n" +
      "nf = b.num_feature()\n" +
      "pt = " + std::to_string(predict_type) + "\n" +
      "per_row = (K * ni if pt == 2 else (nf + 1) * K if pt == 3 "
      "else K)\n" +
      "_ct.c_int64.from_address(" + Addr(out_len) + ").value = " +
      std::to_string(num_row) + " * per_row\n";
  return RunGuarded(body, h);
}

int LgbmTrainBoosterPredictForFile(void* handle,
                                   const char* data_filename,
                                   int data_has_header, int predict_type,
                                   int start_iteration, int num_iteration,
                                   const char* parameter,
                                   const char* result_filename) {
  // ref: c_api.cpp LGBM_BoosterPredictForFile — tab-separated rows,
  // matching the reference's Predictor output convention
  TrainHandle* h = AsTrainHandle(handle);
  if (!h || !h->is_booster || !data_filename || !result_filename) {
    LgbmTrainSetError("BoosterPredictForFile: bad argument(s)");
    return -1;
  }
  std::string kw = predict_type == 1   ? ", raw_score=True"
                   : predict_type == 2 ? ", pred_leaf=True"
                   : predict_type == 3 ? ", pred_contrib=True"
                                       : "";
  std::string body =
      "b = _lgbt_capi['obj'][" + std::to_string(h->id) + "]['booster']\n" +
      // prediction parameters (e.g. predict_disable_shape_check) flow
      // through predict's **kwargs like the reference's config string
      ParamsDict(parameter) +
      (data_has_header ? "p['data_has_header'] = True\n" : "") +
      "pred = b.predict(" + PyStr(data_filename) +
      ", start_iteration=" +
      std::to_string(start_iteration > 0 ? start_iteration : 0) +
      (num_iteration > 0
           ? ", num_iteration=" + std::to_string(num_iteration)
           : "") +
      kw + ", **p)\n" +
      // one output line per INPUT row: 1-D predictions become a column;
      // 2-D (multiclass / leaf / contrib) keep their row structure
      "pred = _np.asarray(pred)\n" +
      "pred = (pred.reshape(pred.shape[0], -1) if pred.ndim > 1 "
      "else pred.reshape(-1, 1))\n" +
      "with open(" + PyStr(result_filename) + ", 'w') as f:\n" +
      "    for row in pred:\n" +
      "        f.write('\\t'.join(repr(float(v)) for v in row) + "
      "'\\n')\n";
  return RunGuarded(body, h);
}

}  // extern "C"

// ===================================================================
// Wave 2: dataset creation (CSC / mats / streaming), dataset ops,
// booster introspection, network init (ref: c_api.h:154-332, :394,
// :440, :491-686, :731-779, :1655-1682).
// ===================================================================

namespace {

// C-side byte buffer (ref: ByteBufferHandle, utils/byte_buffer.h)
struct ByteBuf {
  std::vector<uint8_t> data;
};

// emit python that binds a C buffer as a numpy array named `var`
std::string NpFromBuf(const std::string& var, const void* ptr,
                      const char* ct, int64_t n) {
  return var + " = _np.ctypeslib.as_array((" + ct + " * " +
         std::to_string(n) + ").from_address(" + Addr(ptr) + ")).copy()\n";
}

const char* CtOf(int data_type) {
  return data_type == 0   ? "_ct.c_float"
         : data_type == 1 ? "_ct.c_double"
         : data_type == 2 ? "_ct.c_int32"
                          : "_ct.c_int64";
}

}  // namespace

extern "C" {

int LGBM_DatasetCreateFromCSC(const void* col_ptr, int col_ptr_type,
                              const int32_t* indices, const void* data,
                              int data_type, int64_t ncol_ptr,
                              int64_t nelem, int64_t num_row,
                              const char* parameters,
                              const void* reference, void** out) {
  // ref: c_api.h:394 — the column-compressed ingestion path. The
  // matrix stays SPARSE (scipy csc) so wide-sparse data can engage
  // multi-value storage exactly like the Python API's scipy path.
  (void)reference;
  if (!col_ptr || !indices || !out) {
    LgbmTrainSetError("DatasetCreateFromCSC: null argument");
    return -1;
  }
  if ((data_type != 0 && data_type != 1) ||
      (col_ptr_type != 2 && col_ptr_type != 3)) {
    LgbmTrainSetError("DatasetCreateFromCSC: bad dtype codes");
    return -1;
  }
  TrainHandle* h = NewHandle(false);
  std::string body =
      NpFromBuf("cp", col_ptr, CtOf(col_ptr_type), ncol_ptr) +
      NpFromBuf("ci", indices, "_ct.c_int32", nelem) +
      NpFromBuf("cd", data, CtOf(data_type), nelem) +
      "import scipy.sparse as _sp\n" +
      "m = _sp.csc_matrix((cd.astype(_np.float64), ci, cp), shape=(" +
      std::to_string(num_row) + ", " + std::to_string(ncol_ptr - 1) +
      "))\n" +
      ParamsDict(parameters) +
      "_lgbt_capi['obj'][" + std::to_string(h->id) +
      "] = {'X': m.tocsr(), 'params': p, 'fields': {}}\n";
  if (RunGuarded(body) != 0) {
    DropHandle(h);
    return -1;
  }
  *out = h;
  return 0;
}

int LGBM_DatasetCreateFromMats(int32_t nmat, const void** data,
                               int data_type, int32_t* nrow,
                               int32_t ncol, int* is_row_major,
                               const char* parameters,
                               const void* reference, void** out) {
  // ref: c_api.h:440 — vertically stacked dense blocks
  (void)reference;
  if (!data || !nrow || !is_row_major || !out || nmat <= 0) {
    LgbmTrainSetError("DatasetCreateFromMats: null argument");
    return -1;
  }
  if (data_type != 0 && data_type != 1) {
    LgbmTrainSetError("DatasetCreateFromMats: bad dtype");
    return -1;
  }
  TrainHandle* h = NewHandle(false);
  std::string body = "blocks = []\n";
  for (int32_t i = 0; i < nmat; ++i) {
    body += NpFromBuf("b", data[i], CtOf(data_type),
                      static_cast<int64_t>(nrow[i]) * ncol) +
            (is_row_major[i]
                 ? "b = b.reshape(" + std::to_string(nrow[i]) + ", " +
                       std::to_string(ncol) + ")\n"
                 : "b = b.reshape(" + std::to_string(ncol) + ", " +
                       std::to_string(nrow[i]) + ").T.copy()\n") +
            "blocks.append(b.astype(_np.float64))\n";
  }
  body += ParamsDict(parameters) +
          "_lgbt_capi['obj'][" + std::to_string(h->id) +
          "] = {'X': _np.concatenate(blocks, axis=0), 'params': p, "
          "'fields': {}}\n";
  if (RunGuarded(body) != 0) {
    DropHandle(h);
    return -1;
  }
  *out = h;
  return 0;
}

// ---- streaming creation (ref: c_api.h:154-332; the SynapseML path) ----
// A streaming dataset preallocates its row buffer; PushRows* fill row
// ranges (metadata rides along); MarkFinished seals it. Binning then
// happens at training time over the FULL pushed data — a superset of
// the reference's sample-based binning (bin boundaries come from all
// rows instead of the sample, every other semantic identical).

int LGBM_DatasetCreateFromSampledColumn(double** sample_data,
                                        int** sample_indices,
                                        int32_t ncol,
                                        const int* num_per_col,
                                        int32_t num_sample_row,
                                        int32_t num_local_row,
                                        int64_t num_dist_row,
                                        const char* parameters,
                                        void** out) {
  // the sample defines the SCHEMA (ncol); rows arrive via PushRows
  (void)sample_data;
  (void)sample_indices;
  (void)num_per_col;
  (void)num_sample_row;
  (void)num_dist_row;
  if (!out || ncol <= 0 || num_local_row < 0) {
    LgbmTrainSetError("DatasetCreateFromSampledColumn: bad arguments");
    return -1;
  }
  TrainHandle* h = NewHandle(false);
  std::string body =
      ParamsDict(parameters) +
      "_lgbt_capi['obj'][" + std::to_string(h->id) +
      "] = {'X': _np.zeros((" + std::to_string(num_local_row) + ", " +
      std::to_string(ncol) + ")), 'params': p, 'fields': {}, "
      "'stream': {'total': " + std::to_string(num_local_row) +
      ", 'pushed': 0, 'finished': False, 'manual_finish': False, "
      "'nclasses': 1}}\n";
  if (RunGuarded(body) != 0) {
    DropHandle(h);
    return -1;
  }
  *out = h;
  return 0;
}

int LGBM_DatasetCreateByReference(const void* reference,
                                  int64_t num_total_row, void** out) {
  TrainHandle* r = AsTrainHandle(const_cast<void*>(reference));
  if (!r || r->is_booster || !out) {
    LgbmTrainSetError("DatasetCreateByReference: bad reference handle");
    return -1;
  }
  TrainHandle* h = NewHandle(false);
  std::string body =
      "ref = _lgbt_capi['obj'][" + std::to_string(r->id) + "]\n" +
      "f = ref['X'].shape[1]\n" +
      "_lgbt_capi['obj'][" + std::to_string(h->id) +
      "] = {'X': _np.zeros((" + std::to_string(num_total_row) +
      ", f)), 'params': dict(ref['params']), 'fields': {}, "
      "'stream': {'total': " + std::to_string(num_total_row) +
      ", 'pushed': 0, 'finished': False, 'manual_finish': False, "
      "'nclasses': 1}}\n";
  if (RunGuarded(body, r) != 0) {
    DropHandle(h);
    return -1;
  }
  *out = h;
  return 0;
}

int LGBM_DatasetInitStreaming(void* dataset, int32_t has_weights,
                              int32_t has_init_scores,
                              int32_t has_queries, int32_t nclasses,
                              int32_t nthreads,
                              int32_t omp_max_threads) {
  (void)nthreads;
  (void)omp_max_threads;
  TrainHandle* h = AsTrainHandle(dataset);
  if (!h || h->is_booster) {
    LgbmTrainSetError("DatasetInitStreaming: bad handle");
    return -1;
  }
  std::string body =
      "d = _lgbt_capi['obj'][" + std::to_string(h->id) + "]\n" +
      "st = d.setdefault('stream', {'total': d['X'].shape[0], "
      "'pushed': 0, 'finished': False, 'manual_finish': False})\n" +
      "st['nclasses'] = max(" + std::to_string(nclasses) + ", 1)\n" +
      "n = st['total']\n" +
      "d['fields']['label'] = _np.zeros(n, _np.float32)\n" +
      (has_weights ? "d['fields']['weight'] = _np.zeros(n, _np.float32)\n"
                   : "") +
      (has_init_scores
           ? "d['fields']['init_score'] = _np.zeros(n * st['nclasses'])\n"
           : "") +
      (has_queries
           ? "d['fields']['qid_raw'] = _np.zeros(n, _np.int32)\n"
           : "");
  return RunGuarded(body, h);
}

int LGBM_DatasetPushRows(void* dataset, const void* data, int data_type,
                         int32_t nrow, int32_t ncol, int32_t start_row) {
  TrainHandle* h = AsTrainHandle(dataset);
  if (!h || h->is_booster || !data) {
    LgbmTrainSetError("DatasetPushRows: bad handle");
    return -1;
  }
  if (data_type != 0 && data_type != 1) {
    LgbmTrainSetError("DatasetPushRows: bad dtype");
    return -1;
  }
  std::string body =
      "d = _lgbt_capi['obj'][" + std::to_string(h->id) + "]\n" +
      NpFromBuf("b", data, CtOf(data_type),
                static_cast<int64_t>(nrow) * ncol) +
      "s = " + std::to_string(start_row) + "\n" +
      "d['X'][s:s + " + std::to_string(nrow) + "] = b.reshape(" +
      std::to_string(nrow) + ", " + std::to_string(ncol) + ")\n" +
      "st = d.get('stream')\n" +
      "if st is not None:\n" +
      "    st['pushed'] += " + std::to_string(nrow) + "\n" +
      "    if (st['pushed'] >= st['total'] and not "
      "st['manual_finish']):\n" +
      "        st['finished'] = True\n";
  return RunGuarded(body, h);
}

int LGBM_DatasetPushRowsWithMetadata(void* dataset, const void* data,
                                     int data_type, int32_t nrow,
                                     int32_t ncol, int32_t start_row,
                                     const float* label,
                                     const float* weight,
                                     const double* init_score,
                                     const int32_t* query, int32_t tid) {
  (void)tid;
  TrainHandle* h = AsTrainHandle(dataset);
  if (!h || h->is_booster || !data || !label) {
    LgbmTrainSetError("DatasetPushRowsWithMetadata: bad handle");
    return -1;
  }
  if (LGBM_DatasetPushRows(dataset, data, data_type, nrow, ncol,
                           start_row) != 0)
    return -1;
  std::string body =
      "d = _lgbt_capi['obj'][" + std::to_string(h->id) + "]\n" +
      "s = " + std::to_string(start_row) + "\n" +
      "e = s + " + std::to_string(nrow) + "\n" +
      NpFromBuf("lb", label, "_ct.c_float", nrow) +
      "d['fields'].setdefault('label', _np.zeros(d['X'].shape[0], "
      "_np.float32))[s:e] = lb\n";
  if (weight)
    body += NpFromBuf("wt", weight, "_ct.c_float", nrow) +
            "d['fields'].setdefault('weight', "
            "_np.zeros(d['X'].shape[0], _np.float32))[s:e] = wt\n";
  if (init_score)
    body += std::string(
        "ncl = max(d.get('stream', {}).get('nclasses', 1), 1)\n"
        "nrw = e - s\n"
        "isc = _np.ctypeslib.as_array((_ct.c_double * (nrw * ncl))"
        ".from_address(") + Addr(init_score) + ")).copy()\n"
        "tot = d['X'].shape[0]\n"
        // reference column format: init_score[class * num_total_row + row]
        "dst = d['fields'].setdefault('init_score', "
        "_np.zeros(tot * ncl))\n"
        "for c in range(ncl):\n"
        "    dst[c * tot + s:c * tot + e] = "
        "isc[c * nrw:(c + 1) * nrw]\n";
  if (query)
    body += NpFromBuf("q", query, "_ct.c_int32", nrow) +
            "d['fields'].setdefault('qid_raw', "
            "_np.zeros(d['X'].shape[0], _np.int32))[s:e] = q\n";
  return RunGuarded(body, h);
}

int LGBM_DatasetPushRowsByCSR(void* dataset, const void* indptr,
                              int indptr_type, const int32_t* indices,
                              const void* data, int data_type,
                              int64_t nindptr, int64_t nelem,
                              int64_t num_col, int64_t start_row) {
  TrainHandle* h = AsTrainHandle(dataset);
  if (!h || h->is_booster || !indptr) {
    LgbmTrainSetError("DatasetPushRowsByCSR: bad handle");
    return -1;
  }
  if ((data_type != 0 && data_type != 1) ||
      (indptr_type != 2 && indptr_type != 3)) {
    LgbmTrainSetError("DatasetPushRowsByCSR: bad dtype codes");
    return -1;
  }
  int64_t nrow = nindptr - 1;
  std::string body =
      "d = _lgbt_capi['obj'][" + std::to_string(h->id) + "]\n" +
      NpFromBuf("ip", indptr, CtOf(indptr_type), nindptr) +
      NpFromBuf("ci", indices, "_ct.c_int32", nelem) +
      NpFromBuf("cd", data, CtOf(data_type), nelem) +
      "import scipy.sparse as _sp\n" +
      "blk = _sp.csr_matrix((cd.astype(_np.float64), ci, ip), shape=(" +
      std::to_string(nrow) + ", " + std::to_string(num_col) +
      ")).toarray()\n" +
      "s = " + std::to_string(start_row) + "\n" +
      "d['X'][s:s + " + std::to_string(nrow) + ", :blk.shape[1]] = blk\n" +
      "st = d.get('stream')\n" +
      "if st is not None:\n" +
      "    st['pushed'] += " + std::to_string(nrow) + "\n" +
      "    if (st['pushed'] >= st['total'] and not "
      "st['manual_finish']):\n" +
      "        st['finished'] = True\n";
  return RunGuarded(body, h);
}

int LGBM_DatasetPushRowsByCSRWithMetadata(
    void* dataset, const void* indptr, int indptr_type,
    const int32_t* indices, const void* data, int data_type,
    int64_t nindptr, int64_t nelem, int64_t start_row,
    const float* label, const float* weight, const double* init_score,
    const int32_t* query, int32_t tid) {
  (void)tid;
  TrainHandle* h = AsTrainHandle(dataset);
  if (!h || h->is_booster || !indptr || !label) {
    LgbmTrainSetError("DatasetPushRowsByCSRWithMetadata: bad handle");
    return -1;
  }
  int64_t nrow = nindptr - 1;
  // push with the dataset's own width; metadata mirrors
  // PushRowsWithMetadata
  std::string body =
      "d = _lgbt_capi['obj'][" + std::to_string(h->id) + "]\n" +
      NpFromBuf("ip", indptr, CtOf(indptr_type), nindptr) +
      NpFromBuf("ci", indices, "_ct.c_int32", nelem) +
      NpFromBuf("cd", data, CtOf(data_type), nelem) +
      "import scipy.sparse as _sp\n" +
      "blk = _sp.csr_matrix((cd.astype(_np.float64), ci, ip), shape=(" +
      std::to_string(nrow) + ", d['X'].shape[1])).toarray()\n" +
      "s = " + std::to_string(start_row) + "\n" +
      "e = s + " + std::to_string(nrow) + "\n" +
      "d['X'][s:e] = blk\n" +
      NpFromBuf("lb", label, "_ct.c_float", nrow) +
      "d['fields'].setdefault('label', _np.zeros(d['X'].shape[0], "
      "_np.float32))[s:e] = lb\n" +
      "st = d.get('stream')\n" +
      "if st is not None:\n" +
      "    st['pushed'] += " + std::to_string(nrow) + "\n" +
      "    if (st['pushed'] >= st['total'] and not "
      "st['manual_finish']):\n" +
      "        st['finished'] = True\n";
  if (weight)
    body += NpFromBuf("wt", weight, "_ct.c_float", nrow) +
            "d['fields'].setdefault('weight', "
            "_np.zeros(d['X'].shape[0], _np.float32))[s:e] = wt\n";
  if (init_score)
    body += std::string(
        "ncl = max(d.get('stream', {}).get('nclasses', 1), 1)\n"
        "nrw = e - s\n"
        "isc = _np.ctypeslib.as_array((_ct.c_double * (nrw * ncl))"
        ".from_address(") + Addr(init_score) + ")).copy()\n"
        "tot = d['X'].shape[0]\n"
        // reference column format: init_score[class * num_total_row + row]
        "dst = d['fields'].setdefault('init_score', "
        "_np.zeros(tot * ncl))\n"
        "for c in range(ncl):\n"
        "    dst[c * tot + s:c * tot + e] = "
        "isc[c * nrw:(c + 1) * nrw]\n";
  if (query)
    body += NpFromBuf("q", query, "_ct.c_int32", nrow) +
            "d['fields'].setdefault('qid_raw', "
            "_np.zeros(d['X'].shape[0], _np.int32))[s:e] = q\n";
  return RunGuarded(body, h);
}

int LGBM_DatasetSetWaitForManualFinish(void* dataset, int wait) {
  TrainHandle* h = AsTrainHandle(dataset);
  if (!h || h->is_booster) {
    LgbmTrainSetError("DatasetSetWaitForManualFinish: bad handle");
    return -1;
  }
  return RunGuarded(
      "d = _lgbt_capi['obj'][" + std::to_string(h->id) + "]\n"
      "d.setdefault('stream', {'total': d['X'].shape[0], 'pushed': 0, "
      "'finished': False, 'manual_finish': False})['manual_finish'] = " +
      std::string(wait ? "True" : "False") + "\n");
}

int LGBM_DatasetMarkFinished(void* dataset) {
  TrainHandle* h = AsTrainHandle(dataset);
  if (!h || h->is_booster) {
    LgbmTrainSetError("DatasetMarkFinished: bad handle");
    return -1;
  }
  return RunGuarded(
      "d = _lgbt_capi['obj'][" + std::to_string(h->id) + "]\n"
      "st = d.get('stream')\n"
      "if st is not None:\n"
      "    st['finished'] = True\n"
      // ranking metadata: raw per-row qids convert to group sizes IN
      // ROW ORDER (run-length encoding — np.unique would reorder by
      // qid value and scramble non-ascending query ids)
      "q = d['fields'].pop('qid_raw', None)\n"
      "if q is not None and len(q):\n"
      "    brk = _np.flatnonzero(_np.concatenate((\n"
      "        [True], q[1:] != q[:-1], [True])))\n"
      "    d['fields']['group'] = _np.diff(brk).astype(_np.int32)\n");
}

}  // extern "C"

// ---- dataset ops / serialization / booster introspection ---------------

extern "C" {

int LGBM_DatasetGetSubset(const void* handle,
                          const int32_t* used_row_indices,
                          int32_t num_used_row_indices,
                          const char* parameters, void** out) {
  // ref: c_api.h:491 (Dataset::CopySubrow); python Dataset.subset is
  // the same operation — here the raw dict is sliced directly
  TrainHandle* h = AsTrainHandle(const_cast<void*>(handle));
  if (!h || h->is_booster || !used_row_indices || !out) {
    LgbmTrainSetError("DatasetGetSubset: bad arguments");
    return -1;
  }
  TrainHandle* nh = NewHandle(false);
  std::string body =
      "d = _lgbt_capi['obj'][" + std::to_string(h->id) + "]\n" +
      NpFromBuf("ri", used_row_indices, "_ct.c_int32",
                num_used_row_indices) +
      ParamsDict(parameters) +
      "np2 = dict(d['params']); np2.update(p)\n" +
      "X2 = d['X'][ri]\n" +
      // group is dropped (a row subset breaks query boundaries, like
      // the reference's CopySubrow for ranking); init_score slices per
      // class when stored in the nclasses>1 column format
      "tot = d['X'].shape[0]\n" +
      "f2 = {}\n" +
      "for k, v in d['fields'].items():\n" +
      "    if k == 'group':\n" +
      "        continue\n" +
      "    if k == 'init_score' and len(v) != tot:\n" +
      "        f2[k] = v.reshape(-1, tot)[:, ri].ravel()\n" +
      "    else:\n" +
      "        f2[k] = v[ri]\n" +
      "_lgbt_capi['obj'][" + std::to_string(nh->id) +
      "] = {'X': X2, 'params': np2, 'fields': f2}\n";
  if (RunGuarded(body, h) != 0) {
    DropHandle(nh);
    return -1;
  }
  *out = nh;
  return 0;
}

int LGBM_DatasetAddFeaturesFrom(void* target, void* source) {
  // ref: c_api.h:677 (Dataset::AddFeaturesFrom — horizontal merge)
  TrainHandle* t = AsTrainHandle(target);
  TrainHandle* s = AsTrainHandle(source);
  if (!t || t->is_booster || !s || s->is_booster) {
    LgbmTrainSetError("DatasetAddFeaturesFrom: bad handles");
    return -1;
  }
  return RunGuarded(
      "a = _lgbt_capi['obj'][" + std::to_string(t->id) + "]\n"
      "b = _lgbt_capi['obj'][" + std::to_string(s->id) + "]\n"
      "import scipy.sparse as _sp\n"
      "if _sp.issparse(a['X']) or _sp.issparse(b['X']):\n"
      "    a['X'] = _sp.hstack([_sp.csr_matrix(a['X']), "
      "_sp.csr_matrix(b['X'])]).tocsr()\n"
      "else:\n"
      "    a['X'] = _np.concatenate([a['X'], b['X']], axis=1)\n"
      "fa = a.get('feature_names'); fb = b.get('feature_names')\n"
      "if fa and fb:\n"
      "    a['feature_names'] = list(fa) + list(fb)\n");
}

int LGBM_DatasetDumpText(void* handle, const char* filename) {
  TrainHandle* h = AsTrainHandle(handle);
  if (!h || h->is_booster || !filename) {
    LgbmTrainSetError("DatasetDumpText: bad arguments");
    return -1;
  }
  return RunGuarded(
      "d = _lgbt_capi['obj'][" + std::to_string(h->id) + "]\n"
      "import scipy.sparse as _sp\n"
      "X = d['X'].toarray() if _sp.issparse(d['X']) else d['X']\n"
      "lb = d['fields'].get('label')\n"
      "cols = [lb.reshape(-1, 1)] if lb is not None else []\n"
      "_np.savetxt(" + PyStr(filename) + ", "
      "_np.concatenate(cols + [X], axis=1), delimiter='\\t', "
      "fmt='%.10g')\n");
}

int LGBM_DatasetGetFeatureNumBin(void* handle, int feature_idx,
                                 int* out) {
  // ref: c_api.h:667 — bins are found on demand with the dataset's own
  // params (binning is lazy here; training re-derives the same bins)
  TrainHandle* h = AsTrainHandle(handle);
  if (!h || h->is_booster || !out) {
    LgbmTrainSetError("DatasetGetFeatureNumBin: bad arguments");
    return -1;
  }
  int32_t slot = 0;
  std::string body =
      "d = _lgbt_capi['obj'][" + std::to_string(h->id) + "]\n"
      "import scipy.sparse as _sp\n"
      "X = d['X']\n"
      "col = (_np.asarray(X[:, " + std::to_string(feature_idx) +
      "].todense()).ravel() if _sp.issparse(X) else "
      "_np.asarray(X[:, " + std::to_string(feature_idx) + "], "
      "_np.float64))\n"
      "from lightgbm_tpu_torch.io.binning import BinMapper\n"
      "pp = d['params']\n"
      "m = BinMapper.find_bin(col, len(col), "
      "int(pp.get('max_bin', 255)), int(pp.get('min_data_in_bin', 3)), "
      "int(pp.get('min_data_in_leaf', 20)))\n"
      "_ct.c_int32.from_address(" + Addr(&slot) +
      ").value = int(m.num_bin)\n";
  if (RunGuarded(body, h) != 0) return -1;
  *out = slot;
  return 0;
}

int LGBM_DatasetUpdateParamChecking(const char* old_parameters,
                                    const char* new_parameters) {
  // ref: c_api.h:639 — dataset-shaping params must not change between
  // construction and training
  static const char* kFrozen[] = {
      "max_bin", "min_data_in_bin", "bin_construct_sample_cnt",
      "use_missing", "zero_as_missing", "categorical_feature",
      "feature_pre_filter", "enable_bundle", "data_random_seed",
      nullptr};
  auto get = [](const char* params, const char* key) -> std::string {
    if (!params) return "";
    std::string ps(params);
    std::string k = std::string(key) + "=";
    auto pos = ps.find(k);
    if (pos != std::string::npos && pos > 0 &&
        ps[pos - 1] != ' ' && ps[pos - 1] != ',')
      pos = std::string::npos;
    if (pos == std::string::npos && ps.rfind(k, 0) != 0) return "";
    if (pos == std::string::npos) pos = 0;
    auto end = ps.find_first_of(", ", pos);
    return ps.substr(pos + k.size(),
                     end == std::string::npos ? end
                                              : end - pos - k.size());
  };
  for (int i = 0; kFrozen[i]; ++i) {
    std::string a = get(old_parameters, kFrozen[i]);
    std::string b = get(new_parameters, kFrozen[i]);
    // omission means "keep the dataset's value" (the reference compares
    // effective configs, so a key absent on one side never errors)
    if (a.empty() || b.empty()) continue;
    if (a != b) {
      LgbmTrainSetError((std::string("Cannot change ") + kFrozen[i] +
                         " after Dataset construction (was '" + a +
                         "', now '" + b + "')").c_str());
      return -1;
    }
  }
  return 0;
}

int LGBM_BoosterDumpModel(void* handle, int start_iteration,
                          int num_iteration,
                          int feature_importance_type,
                          int64_t buffer_len, int64_t* out_len,
                          char* out_str) {
  (void)feature_importance_type;
  TrainHandle* h = AsTrainHandle(handle);
  if (!h || !h->is_booster || !out_len) {
    LgbmTrainSetError("BoosterDumpModel: bad arguments");
    return -1;
  }
  int64_t len_slot = 0;
  const std::string key = "'dump_" + Addr(&len_slot) + "'";
  std::string body =
      "import json\n"
      "b = _lgbt_capi['obj'][" + std::to_string(h->id) + "]['booster']\n"
      "js = json.dumps(b.dump_model(" +
      (num_iteration > 0 ? "num_iteration=" +
                               std::to_string(num_iteration) + ", "
                         : "") +
      "start_iteration=" + std::to_string(std::max(start_iteration, 0)) +
      ")).encode() + b'\\0'\n" +
      "_lgbt_capi[" + key + "] = js\n" +
      "_ct.c_int64.from_address(" + Addr(&len_slot) +
      ").value = len(js)\n";
  if (RunGuarded(body, h) != 0) return -1;
  *out_len = len_slot;
  if (out_str && buffer_len > 0) {
    int64_t n = std::min<int64_t>(buffer_len, len_slot);
    std::string copy_body =
        "js = _lgbt_capi.pop(" + key + ")\n" +
        "_ct.memmove(" + Addr(out_str) + ", js, " + std::to_string(n) +
        ")\n";
    if (RunGuarded(copy_body) != 0) return -1;
  } else {
    RunGuarded("_lgbt_capi.pop(" + key + ", None)\n");
  }
  return 0;
}

int LGBM_BoosterGetLoadedParam(void* handle, int64_t buffer_len,
                               int64_t* out_len, char* out_str) {
  TrainHandle* h = AsTrainHandle(handle);
  if (!h || !h->is_booster || !out_len) {
    LgbmTrainSetError("BoosterGetLoadedParam: bad arguments");
    return -1;
  }
  int64_t len_slot = 0;
  const std::string key = "'param_" + Addr(&len_slot) + "'";
  std::string body =
      "import json\n"
      "b = _lgbt_capi['obj'][" + std::to_string(h->id) + "]['booster']\n"
      "js = json.dumps({k: v for k, v in b.params.items()}, "
      "default=str).encode() + b'\\0'\n" +
      "_lgbt_capi[" + key + "] = js\n" +
      "_ct.c_int64.from_address(" + Addr(&len_slot) +
      ").value = len(js)\n";
  if (RunGuarded(body, h) != 0) return -1;
  *out_len = len_slot;
  if (out_str && buffer_len > 0) {
    int64_t n = std::min<int64_t>(buffer_len, len_slot);
    if (RunGuarded("js = _lgbt_capi.pop(" + key + ")\n" +
                   "_ct.memmove(" + Addr(out_str) + ", js, " +
                   std::to_string(n) + ")\n") != 0)
      return -1;
  } else {
    RunGuarded("_lgbt_capi.pop(" + key + ", None)\n");
  }
  return 0;
}

int LGBM_BoosterFeatureImportance(void* handle, int num_iteration,
                                  int importance_type,
                                  double* out_results) {
  TrainHandle* h = AsTrainHandle(handle);
  if (!h || !h->is_booster || !out_results) {
    LgbmTrainSetError("BoosterFeatureImportance: bad arguments");
    return -1;
  }
  std::string body =
      "b = _lgbt_capi['obj'][" + std::to_string(h->id) + "]['booster']\n"
      "imp = b.feature_importance(importance_type=" +
      std::string(importance_type == 1 ? "'gain'" : "'split'") +
      (num_iteration > 0
           ? ", iteration=" + std::to_string(num_iteration)
           : "") +
      ").astype(_np.float64)\n" +
      "_ct.memmove(" + Addr(out_results) +
      ", imp.ctypes.data, imp.nbytes)\n";
  return RunGuarded(body, h);
}

int LGBM_BoosterMerge(void* handle, void* other_handle) {
  // ref: c_api.h:761 (GBDT::MergeFrom — append the other's trees)
  TrainHandle* a = AsTrainHandle(handle);
  TrainHandle* b = AsTrainHandle(other_handle);
  if (!a || !a->is_booster || !b || !b->is_booster) {
    LgbmTrainSetError("BoosterMerge: bad handles");
    return -1;
  }
  return RunGuarded(
      "ea = _lgbt_capi['obj'][" + std::to_string(a->id) +
      "]['booster']._engine\n"
      "eb = _lgbt_capi['obj'][" + std::to_string(b->id) +
      "]['booster']._engine\n"
      "ea.models.extend(eb.models)\n"
      "ea.iter += eb.iter\n");
}

int LGBM_BoosterResetTrainingData(void* handle, const void* train_data) {
  // ref: c_api.h:779 (GBDT::ResetTrainingData — keep the trees, swap
  // the data): a fresh engine over the new dataset continues from the
  // existing model (init_from_model is the same mechanism continued
  // training uses, engine.py)
  TrainHandle* h = AsTrainHandle(handle);
  TrainHandle* d = AsTrainHandle(const_cast<void*>(train_data));
  if (!h || !h->is_booster || !d || d->is_booster) {
    LgbmTrainSetError("BoosterResetTrainingData: bad handles");
    return -1;
  }
  return RunGuarded(
      "o = _lgbt_capi['obj'][" + std::to_string(h->id) + "]\n"
      "d = _lgbt_capi['obj'][" + std::to_string(d->id) + "]\n"
      "old = o['booster']\n"
      "fl = d['fields']\n"
      "grp = fl.get('group')\n"
      "if grp is not None and grp.dtype != _np.int32:\n"
      "    grp = grp.astype(_np.int32)\n"
      "ds = _lgbt.Dataset(d['X'], label=fl.get('label'), "
      "weight=fl.get('weight'), group=grp, "
      "init_score=fl.get('init_score'), "
      "feature_name=d.get('feature_names', 'auto'), "
      "params=dict(old.params))\n"
      "nb = _lgbt.Booster(dict(old.params), ds)\n"
      "nb._engine.init_from_model(old._engine)\n"
      "o['booster'] = nb\n");
}

int LGBM_BoosterShuffleModels(void* handle, int start_iter,
                              int end_iter) {
  // ref: c_api.h:751 (GBDT::ShuffleModels)
  TrainHandle* h = AsTrainHandle(handle);
  if (!h || !h->is_booster) {
    LgbmTrainSetError("BoosterShuffleModels: bad handle");
    return -1;
  }
  return RunGuarded(
      "e = _lgbt_capi['obj'][" + std::to_string(h->id) +
      "]['booster']._engine\n"
      "K = max(e.num_tree_per_iteration, 1)\n"
      "s = max(" + std::to_string(start_iter) + ", 0) * K\n"
      "t = (" + std::to_string(end_iter) + " * K if " +
      std::to_string(end_iter) + " > 0 else len(e.models))\n"
      "seg = e.models[s:t]\n"
      "_np.random.default_rng(0).shuffle(seg)\n"
      "e.models[s:t] = seg\n");
}

int LgbmTrainBoosterGetLinear(void* handle, int* out) {
  TrainHandle* h = AsTrainHandle(handle);
  if (!h || !h->is_booster || !out) {
    LgbmTrainSetError("BoosterGetLinear: bad handle");
    return -1;
  }
  int32_t slot = 0;
  if (RunGuarded(
          "e = _lgbt_capi['obj'][" + std::to_string(h->id) +
          "]['booster']._engine\n"
          "lin = any(getattr(t, 'is_linear', False) "
          "for t in e.models)\n"
          "_ct.c_int32.from_address(" + Addr(&slot) +
          ").value = 1 if lin else 0\n") != 0)
    return -1;
  *out = slot;
  return 0;
}

// ---- reference-schema serialization + ByteBuffer -----------------------
// (ref: c_api.h:550 SerializeReferenceToBinary / :204
// CreateFromSerializedReference / :117-124 ByteBuffer). The schema blob
// is a pickled {ncol, params} — binning re-derives identically from the
// pushed rows, so the schema is what must travel.

int LGBM_DatasetSerializeReferenceToBinary(void* handle,
                                           void** out_buffer,
                                           int32_t* out_len) {
  TrainHandle* h = AsTrainHandle(handle);
  if (!h || h->is_booster || !out_buffer || !out_len) {
    LgbmTrainSetError("SerializeReferenceToBinary: bad arguments");
    return -1;
  }
  int64_t len_slot = 0;
  const std::string key = "'refblob_" + Addr(&len_slot) + "'";
  std::string body =
      "import pickle\n"
      "d = _lgbt_capi['obj'][" + std::to_string(h->id) + "]\n"
      "blob = pickle.dumps({'ncol': int(d['X'].shape[1]), "
      "'params': dict(d['params'])})\n" +
      "_lgbt_capi[" + key + "] = blob\n" +
      "_ct.c_int64.from_address(" + Addr(&len_slot) +
      ").value = len(blob)\n";
  if (RunGuarded(body, h) != 0) return -1;
  auto* bb = new ByteBuf();
  bb->data.resize(static_cast<size_t>(len_slot));
  if (RunGuarded("blob = _lgbt_capi.pop(" + key + ")\n" +
                 "_ct.memmove(" + Addr(bb->data.data()) + ", blob, " +
                 std::to_string(len_slot) + ")\n") != 0) {
    delete bb;
    return -1;
  }
  *out_buffer = bb;
  *out_len = static_cast<int32_t>(len_slot);
  return 0;
}

int LGBM_ByteBufferGetAt(void* handle, int32_t index, uint8_t* out_val) {
  auto* bb = static_cast<ByteBuf*>(handle);
  if (!bb || !out_val || index < 0 ||
      index >= static_cast<int32_t>(bb->data.size())) {
    LgbmTrainSetError("ByteBufferGetAt: bad arguments");
    return -1;
  }
  *out_val = bb->data[index];
  return 0;
}

int LGBM_ByteBufferFree(void* handle) {
  delete static_cast<ByteBuf*>(handle);
  return 0;
}

int LGBM_DatasetCreateFromSerializedReference(
    const void* ref_buffer, int32_t ref_buffer_size, int64_t num_row,
    int32_t num_classes, const char* parameters, void** out) {
  if (!ref_buffer || !out || ref_buffer_size <= 0) {
    LgbmTrainSetError("CreateFromSerializedReference: bad arguments");
    return -1;
  }
  TrainHandle* h = NewHandle(false);
  std::string body =
      "import pickle\n" +
      NpFromBuf("raw", ref_buffer, "_ct.c_uint8", ref_buffer_size) +
      "ref = pickle.loads(raw.tobytes())\n" +
      ParamsDict(parameters) +
      "np2 = dict(ref['params']); np2.update(p)\n" +
      "_lgbt_capi['obj'][" + std::to_string(h->id) +
      "] = {'X': _np.zeros((" + std::to_string(num_row) +
      ", ref['ncol'])), 'params': np2, 'fields': {}, "
      "'stream': {'total': " + std::to_string(num_row) +
      ", 'pushed': 0, 'finished': False, 'manual_finish': False, "
      "'nclasses': " + std::to_string(std::max(num_classes, 1)) +
      "}}\n";
  if (RunGuarded(body) != 0) {
    DropHandle(h);
    return -1;
  }
  *out = h;
  return 0;
}

// ---- network (ref: c_api.h:1655-1682) ----------------------------------

int LGBM_NetworkInit(const char* machines, int local_listen_port,
                     int listen_time_out, int num_machines) {
  // ref: c_api.h:1655. machines = 'ip1:port1,ip2:port2,...'; the SPMD
  // translation: entry 0 is the torch.distributed coordinator and this
  // process' rank is its position in the list (matched by the
  // reference's own local-address rule).
  (void)listen_time_out;
  if (num_machines <= 1) return 0;  // single machine: nothing to join
  if (!machines) {
    LgbmTrainSetError("NetworkInit: machines list required");
    return -1;
  }
  std::string body =
      "import socket as _s\n"
      "machines = " + PyStr(machines) + ".split(',')\n"
      "coord = machines[0].strip()\n"
      "local = {_s.gethostbyname(_s.gethostname()), '127.0.0.1', "
      "_s.gethostname()}\n"
      "rank = next((i for i, m in enumerate(machines) if "
      "m.split(':')[0].strip() in local and "
      "int(m.split(':')[1]) == " + std::to_string(local_listen_port) +
      "), None)\n"
      "if rank is None:\n"
      "    raise ValueError('local machine not found in machines list "
      "(match by address and local_listen_port)')\n"
      "from lightgbm_tpu_torch.distributed import init_distributed\n"
      "init_distributed(coordinator_address=coord, num_processes=" +
      std::to_string(num_machines) + ", process_id=rank)\n";
  return RunGuarded(body);
}

int LGBM_NetworkFree() {
  return RunGuarded(
      "from lightgbm_tpu_torch.distributed import shutdown_distributed, "
      "clear_collectives\n"
      "clear_collectives()\n"
      "try:\n"
      "    shutdown_distributed()\n"
      "except Exception:\n"
      "    pass\n");
}

}  // extern "C"

// external collective plumbing for LGBM_NetworkInitWithFunctions
namespace {

typedef void (*ExtReduceFn)(const char*, char*, int, int32_t);
typedef void (*ExtReduceScatterFn)(char*, int32_t, int,
                                   const int32_t*, const int32_t*, int,
                                   char*, int32_t, const ExtReduceFn&);
typedef void (*ExtAllgatherFn)(char*, int32_t, const int32_t*,
                               const int32_t*, int, char*, int32_t);

ExtReduceScatterFn g_ext_rs = nullptr;
ExtAllgatherFn g_ext_ag = nullptr;
int g_ext_world = 1;

template <typename T>
void SumReduce(const char* src, char* dst, int type_size,
               int32_t nbytes) {
  (void)type_size;
  const T* s = reinterpret_cast<const T*>(src);
  T* d = reinterpret_cast<T*>(dst);
  for (int32_t i = 0; i < nbytes / static_cast<int32_t>(sizeof(T)); ++i)
    d[i] += s[i];
}

template <typename T>
void MaxReduce(const char* src, char* dst, int type_size,
               int32_t nbytes) {
  (void)type_size;
  const T* s = reinterpret_cast<const T*>(src);
  T* d = reinterpret_cast<T*>(dst);
  for (int32_t i = 0; i < nbytes / static_cast<int32_t>(sizeof(T)); ++i)
    d[i] = d[i] > s[i] ? d[i] : s[i];
}

}  // namespace

extern "C" {

// allreduce over the injected external functions — the exact
// ReduceScatter + Allgather block recipe of Network::Allreduce
// (ref: src/network/network.cpp:72-98). Called from the embedded
// interpreter's injected reduce callables via ctypes.
// dtype: 0=f32 1=f64 2=i32; op: 0=sum 1=max. Returns 0 on success.
int lgbm_ext_allreduce(char* buf, int64_t n_elems, int dtype, int op) {
  if (!g_ext_rs || !g_ext_ag) return -1;
  const int ts = dtype == 1 ? 8 : 4;
  const int32_t input_size = static_cast<int32_t>(n_elems) * ts;
  const int world = g_ext_world;
  std::vector<int32_t> bstart(world), blen(world);
  int32_t count = static_cast<int32_t>(n_elems);
  int32_t step = (count + world - 1) / world;
  if (step < 1) step = 1;
  bstart[0] = 0;
  for (int i = 0; i < world - 1; ++i) {
    blen[i] = std::min<int32_t>(step * ts, input_size - bstart[i]);
    bstart[i + 1] = bstart[i] + blen[i];
  }
  blen[world - 1] = input_size - bstart[world - 1];
  ExtReduceFn red =
      op == 0 ? (dtype == 0   ? &SumReduce<float>
                 : dtype == 1 ? &SumReduce<double>
                              : &SumReduce<int32_t>)
              : (dtype == 0   ? &MaxReduce<float>
                 : dtype == 1 ? &MaxReduce<double>
                              : &MaxReduce<int32_t>);
  std::vector<char> out(static_cast<size_t>(input_size));
  g_ext_rs(buf, input_size, ts, bstart.data(), blen.data(), world,
           out.data(), input_size, red);
  g_ext_ag(out.data(), input_size, bstart.data(), blen.data(), world,
           out.data(), input_size);
  std::memcpy(buf, out.data(), input_size);
  return 0;
}

int LGBM_NetworkInitWithFunctions(int num_machines, int rank,
                                  void* reduce_scatter_ext_fun,
                                  void* allgather_ext_fun) {
  // ref: c_api.h:1674 / network.cpp:49-62. The injected function
  // pointers become the transport of lightgbm_tpu_torch.distributed's
  // collective-injection mode: every histogram/root reduction routes
  // host-side through lgbm_ext_allreduce above.
  if (num_machines <= 1) return 0;
  if (!reduce_scatter_ext_fun || !allgather_ext_fun) {
    LgbmTrainSetError("NetworkInitWithFunctions: null function");
    return -1;
  }
  g_ext_rs = reinterpret_cast<ExtReduceScatterFn>(reduce_scatter_ext_fun);
  g_ext_ag = reinterpret_cast<ExtAllgatherFn>(allgather_ext_fun);
  g_ext_world = num_machines;
  std::string body =
      "import ctypes as _ct2\n"
      "_ar = _ct2.CFUNCTYPE(_ct2.c_int, _ct2.c_void_p, "
      "_ct2.c_longlong, _ct2.c_int, _ct2.c_int)(" +
      Addr(reinterpret_cast<const void*>(&lgbm_ext_allreduce)) + ")\n"
      "def _code(a):\n"
      "    if a.dtype == _np.float32: return 0\n"
      "    if a.dtype == _np.float64: return 1\n"
      "    if a.dtype == _np.int32: return 2\n"
      "    raise TypeError(f'unsupported dtype {a.dtype}')\n"
      "def _mk(op):\n"
      "    def red(a):\n"
      "        a = _np.ascontiguousarray(a)\n"
      "        rc = _ar(a.ctypes.data, a.size, _code(a), op)\n"
      "        if rc != 0:\n"
      "            raise RuntimeError('external allreduce failed')\n"
      "        return a\n"
      "    return red\n"
      "from lightgbm_tpu_torch.distributed import inject_collectives\n"
      "inject_collectives(_mk(0), reduce_max=_mk(1), rank=" +
      std::to_string(rank) + ", num_machines=" +
      std::to_string(num_machines) + ")\n";
  return RunGuarded(body);
}

int LGBM_DumpParamAliases(int64_t buffer_len, int64_t* out_len,
                          char* out_str) {
  // ref: c_api.h:73 — JSON map of parameter -> aliases from the single
  // config registry (the reference generates it from config_auto)
  if (!out_len) {
    LgbmTrainSetError("DumpParamAliases: null out_len");
    return -1;
  }
  int64_t len_slot = 0;
  const std::string key = "'aliases_" + Addr(&len_slot) + "'";
  std::string body =
      std::string(
          "import json\n"
          "from lightgbm_tpu_torch import config as _cfgmod\n"
          "amap = {}\n"
          "for alias, canon in _cfgmod._ALIAS_TO_NAME.items():\n"
          "    amap.setdefault(canon, []).append(alias)\n"
          "js = json.dumps(amap, sort_keys=True).encode() + b'\\0'\n") +
      "_lgbt_capi[" + key + "] = js\n" +
      "_ct.c_int64.from_address(" + Addr(&len_slot) +
      ").value = len(js)\n";
  if (RunGuarded(body) != 0) return -1;
  *out_len = len_slot;
  if (out_str && buffer_len > 0) {
    int64_t n = std::min<int64_t>(buffer_len, len_slot);
    if (RunGuarded("js = _lgbt_capi.pop(" + key + ")\n" +
                   "_ct.memmove(" + Addr(out_str) + ", js, " +
                   std::to_string(n) + ")\n") != 0)
      return -1;
  } else {
    RunGuarded("_lgbt_capi.pop(" + key + ", None)\n");
  }
  return 0;
}

}  // extern "C"

namespace {
void SetTrainError(const std::string& msg) {
  LgbmTrainSetError(msg.c_str());
}
}  // namespace
