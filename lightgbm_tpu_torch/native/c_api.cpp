// Native C API: model loading + prediction without Python.
//
// Serving-side counterpart of the reference's C ABI
// (ref: include/LightGBM/c_api.h, src/c_api.cpp:170 Booster wrapper,
// src/io/tree.cpp:761 Tree::Split decision semantics). The training path
// in this framework is PyTorch and is reached through the Python API; the
// C API covers the deployment surface — load a saved model.txt and predict
// from C/C++/any FFI with no interpreter in the process.
//
// ABI compatibility: the exported LGBM_* signatures match the reference's
// c_api.h for the implemented subset (Createfromodelfile / LoadModelFromString
// / Free / GetNumClasses / GetNumFeature / GetCurrentIteration /
// NumModelPerIteration / PredictForMat / GetLastError), so FFI callers can
// switch by swapping the shared library. Unimplemented entry points
// (training, SHAP) return -1 with a descriptive LGBM_GetLastError message.
#include <algorithm>
#include <cctype>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <fstream>
#include <map>
#include <memory>
#include <sstream>
#include <string>
#include <thread>
#include <vector>

namespace {

thread_local std::string g_last_error = "everything is fine";

void SetError(const std::string& msg) { g_last_error = msg; }

struct Tree {
  int num_leaves = 1;
  int num_cat = 0;
  bool is_linear = false;
  std::vector<int> split_feature;
  std::vector<double> threshold;
  std::vector<int8_t> decision_type;
  std::vector<int> left_child, right_child;
  std::vector<double> leaf_value;
  // cover weights (needed by SHAP's zero fractions; optional in the
  // model text — contrib prediction errors without them)
  std::vector<double> leaf_count;
  std::vector<double> internal_count;
  std::vector<int64_t> cat_boundaries;
  std::vector<uint32_t> cat_threshold;
  // linear trees (ref: tree.cpp:385 linear block)
  std::vector<double> leaf_const;
  std::vector<std::vector<int>> leaf_features;
  std::vector<std::vector<double>> leaf_coeff;

  bool CatInBitset(int cat_idx, double x) const {
    if (std::isnan(x) || x < 0) return false;
    int64_t v = static_cast<int64_t>(std::floor(x));
    int64_t lo = cat_boundaries[cat_idx];
    int64_t hi = cat_boundaries[cat_idx + 1];
    int64_t word = lo + (v / 32);
    if (word >= hi ||
        word >= static_cast<int64_t>(cat_threshold.size()))
      return false;
    return (cat_threshold[word] >> (v % 32)) & 1u;
  }

  int PredictLeaf(const double* row) const {
    if (num_leaves <= 1) return 0;
    int node = 0;
    while (true) {
      int8_t dt = decision_type[node];
      double x = row[split_feature[node]];
      bool go_left;
      if (dt & 1) {  // categorical (bitset membership; NaN/unseen right)
        go_left = CatInBitset(static_cast<int>(threshold[node]), x);
      } else {
        // numerical: bit1 default_left, bits2-3 missing type
        // (semantics mirror core/tree.py predict_leaf exactly)
        bool dl = dt & 2;
        int mtype = (dt >> 2) & 3;
        bool is_nan = std::isnan(x);
        double x0 = is_nan ? 0.0 : x;
        bool miss = (mtype == 2) ? is_nan
                                 : (mtype == 1 && std::fabs(x0) <= 1e-35);
        go_left = miss ? dl : (x0 <= threshold[node]);
      }
      int child = go_left ? left_child[node] : right_child[node];
      if (child < 0) return ~child;
      node = child;
    }
  }

  double Predict(const double* row) const {
    int leaf = PredictLeaf(row);
    if (!is_linear) return leaf_value[leaf];
    // linear leaf: const + <coeff, x>; NaN in any used feature falls
    // back to the constant (ref: tree.cpp PredictionFunLinear)
    double out = leaf_const[leaf];
    const auto& feats = leaf_features[leaf];
    const auto& coef = leaf_coeff[leaf];
    double lin = 0.0;
    bool has_nan = false;
    for (size_t i = 0; i < feats.size(); ++i) {
      double x = row[feats[i]];
      if (std::isnan(x)) { has_nan = true; break; }
      lin += coef[i] * x;
    }
    return has_nan ? out : out + lin;
  }
};

enum class Transform { kNone, kSigmoid, kExp, kSoftmax, kSigmoidPerClass,
                       kLog1pExp, kSqrtSquare };

struct Model {
  int num_class = 1;
  int num_tree_per_iteration = 1;
  int max_feature_idx = 0;
  double sigmoid = 1.0;
  bool average_output = false;
  Transform transform = Transform::kNone;
  std::string objective;
  std::vector<std::string> feature_names;  // model-text feature_names=
  std::vector<Tree> trees;

  int NumIterations() const {
    return num_tree_per_iteration > 0
               ? static_cast<int>(trees.size()) / num_tree_per_iteration
               : 0;
  }
};

// ---- parsing --------------------------------------------------------------

std::vector<double> ParseDoubles(const std::string& s) {
  std::vector<double> out;
  const char* p = s.c_str();
  char* e = nullptr;
  while (*p) {
    while (*p == ' ' || *p == '\t') ++p;
    if (!*p) break;
    double v = std::strtod(p, &e);
    if (e == p) break;
    out.push_back(v);
    p = e;
  }
  return out;
}

std::vector<int64_t> ParseInts(const std::string& s) {
  std::vector<int64_t> out;
  for (double v : ParseDoubles(s)) out.push_back(static_cast<int64_t>(v));
  return out;
}

bool ParseTreeBlock(const std::map<std::string, std::string>& kv, Tree* t) {
  auto get = [&](const char* k) -> const std::string& {
    static const std::string kEmpty;
    auto it = kv.find(k);
    return it == kv.end() ? kEmpty : it->second;
  };
  t->num_leaves = static_cast<int>(std::atoll(get("num_leaves").c_str()));
  t->num_cat = static_cast<int>(std::atoll(get("num_cat").c_str()));
  int n = t->num_leaves, ni = n - 1;
  if (n < 1) return false;  // an empty/garbled block must not parse
  t->leaf_value = ParseDoubles(get("leaf_value"));
  if (static_cast<int>(t->leaf_value.size()) != n) return false;
  t->leaf_count = ParseDoubles(get("leaf_count"));
  t->internal_count = ParseDoubles(get("internal_count"));
  if (ni > 0) {
    auto sf = ParseInts(get("split_feature"));
    t->threshold = ParseDoubles(get("threshold"));
    auto dt = ParseInts(get("decision_type"));
    auto lc = ParseInts(get("left_child"));
    auto rc = ParseInts(get("right_child"));
    if (static_cast<int>(sf.size()) != ni ||
        static_cast<int>(t->threshold.size()) != ni ||
        static_cast<int>(lc.size()) != ni ||
        static_cast<int>(rc.size()) != ni)
      return false;
    t->split_feature.assign(sf.begin(), sf.end());
    t->decision_type.resize(ni);
    for (int i = 0; i < ni; ++i)
      t->decision_type[i] =
          static_cast<int8_t>(i < static_cast<int>(dt.size()) ? dt[i] : 0);
    t->left_child.assign(lc.begin(), lc.end());
    t->right_child.assign(rc.begin(), rc.end());
    // children indices must stay in range (leaf refs are ~idx < 0)
    for (int i = 0; i < ni; ++i) {
      if (t->left_child[i] >= ni || t->left_child[i] < -n ||
          t->right_child[i] >= ni || t->right_child[i] < -n)
        return false;
    }
  }
  if (t->num_cat > 0) {
    t->cat_boundaries = ParseInts(get("cat_boundaries"));
    auto ct = ParseInts(get("cat_threshold"));
    t->cat_threshold.assign(ct.begin(), ct.end());
  }
  // every categorical node's threshold is an index into cat_boundaries;
  // a node with the categorical bit but NO cat tables (num_cat=0 —
  // e.g. a corrupted decision_type in an all-numerical tree) would
  // index an empty vector in CatInBitset, so it must not parse
  for (int i = 0; i < ni; ++i) {
    if (!(t->decision_type[i] & 1)) continue;
    int64_t ci = static_cast<int64_t>(t->threshold[i]);
    if (t->num_cat <= 0 || ci < 0 ||
        ci + 1 >= static_cast<int64_t>(t->cat_boundaries.size()))
      return false;
  }
  if (t->num_cat > 0) {
    // categorical tables must be self-consistent or traversal would read
    // out of bounds (CatInBitset indexes by node threshold)
    if (t->cat_boundaries.size() < 2 ||
        t->cat_boundaries.front() != 0 ||
        static_cast<int64_t>(t->cat_threshold.size()) !=
            t->cat_boundaries.back())
      return false;
    for (size_t i = 1; i < t->cat_boundaries.size(); ++i)
      if (t->cat_boundaries[i] < t->cat_boundaries[i - 1]) return false;
  }
  t->is_linear = std::atoi(get("is_linear").c_str()) != 0;
  if (t->is_linear) {
    t->leaf_const = ParseDoubles(get("leaf_const"));
    auto nf = ParseInts(get("num_features"));
    auto ff = ParseInts(get("leaf_features"));
    auto cc = ParseDoubles(get("leaf_coeff"));
    if (static_cast<int>(t->leaf_const.size()) != n ||
        static_cast<int>(nf.size()) != n || ff.size() != cc.size())
      return false;
    int64_t total = 0;
    for (auto k : nf) total += k;
    if (total != static_cast<int64_t>(ff.size())) return false;
    t->leaf_features.resize(n);
    t->leaf_coeff.resize(n);
    size_t pos = 0;
    for (int i = 0; i < n; ++i) {
      size_t k = static_cast<size_t>(nf[i]);
      for (size_t j = 0; j < k; ++j) {
        t->leaf_features[i].push_back(static_cast<int>(ff[pos + j]));
        t->leaf_coeff[i].push_back(cc[pos + j]);
      }
      pos += k;
    }
  }
  return true;
}

Model* ParseModelString(const std::string& text) {
  auto model = std::make_unique<Model>();
  std::istringstream in(text);
  std::string line;
  std::map<std::string, std::string> kv;
  bool in_tree = false;
  bool saw_magic = false;

  auto flush_tree = [&]() -> bool {
    if (!in_tree) return true;
    Tree t;
    if (!ParseTreeBlock(kv, &t)) return false;
    model->trees.push_back(std::move(t));
    kv.clear();
    return true;
  };

  while (std::getline(in, line)) {
    if (!line.empty() && line.back() == '\r') line.pop_back();
    if (line.empty()) continue;
    if (!saw_magic) {
      // the format begins with the literal magic line "tree"
      // (ref: gbdt_model_text.cpp SaveModelToString header)
      if (line != "tree") return nullptr;
      saw_magic = true;
      continue;
    }
    if (line == "average_output") {
      model->average_output = true;
      continue;
    }
    if (line.rfind("Tree=", 0) == 0) {
      if (!flush_tree()) return nullptr;
      in_tree = true;
      continue;
    }
    if (line == "end of trees") {
      if (!flush_tree()) return nullptr;
      in_tree = false;
      continue;
    }
    auto eq = line.find('=');
    if (eq == std::string::npos) continue;
    std::string key = line.substr(0, eq);
    std::string val = line.substr(eq + 1);
    if (in_tree) {
      kv[key] = val;
    } else if (key == "num_class") {
      model->num_class = std::atoi(val.c_str());
    } else if (key == "num_tree_per_iteration") {
      model->num_tree_per_iteration = std::atoi(val.c_str());
    } else if (key == "max_feature_idx") {
      model->max_feature_idx = std::atoi(val.c_str());
    } else if (key == "feature_names") {
      model->feature_names.clear();
      size_t start = 0;
      while (start < val.size()) {
        size_t sp = val.find(' ', start);
        if (sp == std::string::npos) sp = val.size();
        if (sp > start)
          model->feature_names.push_back(val.substr(start, sp - start));
        start = sp + 1;
      }
    } else if (key == "objective") {
      model->objective = val;
      std::string name = val.substr(0, val.find(' '));
      auto sp = val.find("sigmoid:");
      if (sp != std::string::npos)
        model->sigmoid = std::atof(val.c_str() + sp + 8);
      if (name == "binary" || name == "cross_entropy") {
        model->transform = Transform::kSigmoid;
      } else if (name == "cross_entropy_lambda") {
        // ref: CrossEntropyLambda::ConvertOutput = log1p(exp(raw))
        model->transform = Transform::kLog1pExp;
      } else if (name == "poisson" || name == "gamma" ||
                 name == "tweedie") {
        model->transform = Transform::kExp;
      } else if (name == "multiclass" || name == "softmax") {
        model->transform = Transform::kSoftmax;
      } else if (name == "multiclassova" || name == "multiclass_ova") {
        model->transform = Transform::kSigmoidPerClass;
      } else if (name == "regression" &&
                 val.find(" sqrt") != std::string::npos) {
        // reg_sqrt: labels trained in sqrt space
        model->transform = Transform::kSqrtSquare;
      }
    }
  }
  if (!flush_tree()) return nullptr;
  if (!saw_magic) return nullptr;
  // every split feature must stay inside the declared feature range —
  // traversal reads row[split_feature[node]] from a caller buffer of
  // max_feature_idx+1 doubles, so an out-of-range id in a corrupted
  // file would read (or crash) outside it
  for (const Tree& t : model->trees) {
    for (int f : t.split_feature) {
      if (f < 0 || f > model->max_feature_idx) return nullptr;
    }
    for (const auto& feats : t.leaf_features) {
      for (int f : feats) {
        if (f < 0 || f > model->max_feature_idx) return nullptr;
      }
    }
  }
  return model.release();
}

void TransformRow(const Model& m, double* scores) {
  switch (m.transform) {
    case Transform::kNone:
      break;
    case Transform::kSigmoid:
      scores[0] = 1.0 / (1.0 + std::exp(-m.sigmoid * scores[0]));
      break;
    case Transform::kExp:
      scores[0] = std::exp(scores[0]);
      break;
    case Transform::kSigmoidPerClass:
      for (int k = 0; k < m.num_class; ++k)
        scores[k] = 1.0 / (1.0 + std::exp(-m.sigmoid * scores[k]));
      break;
    case Transform::kLog1pExp:
      scores[0] = std::log1p(std::exp(scores[0]));
      break;
    case Transform::kSqrtSquare:
      scores[0] = std::copysign(scores[0] * scores[0], scores[0]);
      break;
    case Transform::kSoftmax: {
      double mx = scores[0];
      for (int k = 1; k < m.num_class; ++k)
        if (scores[k] > mx) mx = scores[k];
      double sum = 0.0;
      for (int k = 0; k < m.num_class; ++k) {
        scores[k] = std::exp(scores[k] - mx);
        sum += scores[k];
      }
      for (int k = 0; k < m.num_class; ++k) scores[k] /= sum;
      break;
    }
  }
}

int PredictContribDense(Model* m, const double* X, int64_t nrow,
                        int32_t ncol, int start_iteration,
                        int num_iteration, double* out);  // defined below

extern int g_max_threads;  // defined below (LGBM_SetMaxThreads)

// Row-parallel driver for the serving loops. Rows are independent and
// write disjoint output regions, so a plain chunked std::thread pool
// mirrors the reference's `#pragma omp parallel for` over rows
// (ref: src/application/predictor.hpp:31 OMP per-row predict).
// Honors LGBM_SetMaxThreads (g_max_threads; -1 = hardware default) and
// stays single-threaded below min_rows_per_thread to avoid spawn cost
// on small/single-row requests.
template <typename BodyFn>
void ParallelRows(int64_t nrow, int64_t min_rows_per_thread, BodyFn body) {
  int hw = static_cast<int>(std::thread::hardware_concurrency());
  int maxt = g_max_threads > 0 ? g_max_threads : (hw > 0 ? hw : 1);
  int64_t want = (nrow + min_rows_per_thread - 1) / min_rows_per_thread;
  int t = static_cast<int>(
      std::min<int64_t>(maxt, std::max<int64_t>(want, 1)));
  if (t <= 1) {
    body(static_cast<int64_t>(0), nrow);
    return;
  }
  std::vector<std::thread> threads;
  threads.reserve(t);
  int64_t chunk = (nrow + t - 1) / t;
  for (int i = 0; i < t; ++i) {
    int64_t lo = i * chunk;
    int64_t hi = std::min<int64_t>(nrow, lo + chunk);
    if (lo >= hi) break;
    threads.emplace_back([&body, lo, hi]() { body(lo, hi); });
  }
  for (auto& th : threads) th.join();
}

template <typename FillFn>
int PredictRows(Model* m, FillFn fill, int64_t nrow, int64_t ncol,
                int predict_type, int start_iteration, int num_iteration,
                int64_t* out_len, double* out_result) {
  int total_iter = m->NumIterations();
  int end_iter = (num_iteration <= 0)
                     ? total_iter
                     : std::min(total_iter, start_iteration + num_iteration);
  int K = m->num_tree_per_iteration;

  if (predict_type == 2) {  // leaf indices, [nrow, num_trees_used]
    int n_used = (end_iter - start_iteration) * K;
    ParallelRows(nrow, 256, [&](int64_t lo, int64_t hi) {
      std::vector<double> row(ncol);
      for (int64_t r = lo; r < hi; ++r) {
        fill(r, row.data());
        double* out = out_result + r * n_used;
        int j = 0;
        for (int it = start_iteration; it < end_iter; ++it)
          for (int k = 0; k < K; ++k)
            out[j++] = m->trees[it * K + k].PredictLeaf(row.data());
      }
    });
    *out_len = static_cast<int64_t>(nrow) * n_used;
    return 0;
  }
  if (predict_type == 3) {  // C_API_PREDICT_CONTRIB
    std::vector<double> X(static_cast<size_t>(nrow) * ncol);
    ParallelRows(nrow, 1024, [&](int64_t lo, int64_t hi) {
      for (int64_t r = lo; r < hi; ++r) fill(r, X.data() + r * ncol);
    });
    if (PredictContribDense(m, X.data(), nrow,
                            static_cast<int32_t>(ncol),
                            start_iteration, num_iteration,
                            out_result) != 0)
      return -1;
    *out_len = nrow * static_cast<int64_t>(m->max_feature_idx + 2) * K;
    return 0;
  }
  if (predict_type != 0 && predict_type != 1) {
    SetError("predict_type must be 0 (normal), 1 (raw), 2 (leaf index) "
             "or 3 (contrib)");
    return -1;
  }
  int n_iter_used = end_iter - start_iteration;
  ParallelRows(nrow, 256, [&](int64_t lo, int64_t hi) {
    std::vector<double> row(ncol);
    for (int64_t r = lo; r < hi; ++r) {
      fill(r, row.data());
      double* out = out_result + r * K;
      for (int k = 0; k < K; ++k) out[k] = 0.0;
      for (int it = start_iteration; it < end_iter; ++it)
        for (int k = 0; k < K; ++k)
          out[k] += m->trees[it * K + k].Predict(row.data());
      if (m->average_output && n_iter_used > 0)
        for (int k = 0; k < K; ++k) out[k] /= n_iter_used;  // rf averaging
      if (predict_type == 0) TransformRow(*m, out);
    }
  });
  *out_len = static_cast<int64_t>(nrow) * K;
  return 0;
}

inline void FillRow(const void* data, int data_type, int64_t r, int32_t ncol,
                    int is_row_major, int64_t nrow, double* row) {
  if (data_type == 0) {  // C_API_DTYPE_FLOAT32
    const float* d = static_cast<const float*>(data);
    for (int32_t c = 0; c < ncol; ++c)
      row[c] = is_row_major ? d[r * ncol + c] : d[c * nrow + r];
  } else {  // C_API_DTYPE_FLOAT64
    const double* d = static_cast<const double*>(data);
    for (int32_t c = 0; c < ncol; ++c)
      row[c] = is_row_major ? d[r * ncol + c] : d[c * nrow + r];
  }
}

int g_max_threads = -1;  // LGBM_SetMaxThreads; -1 = hardware default
void (*g_log_callback)(const char*) = nullptr;

// frozen single-row prediction setup (ref: c_api.h FastConfigHandle)
struct FastConfig {
  Model* model;
  int predict_type;
  int start_iteration;
  int num_iteration;
  int data_type;
  int64_t ncol;
};

// ---- SHAP contributions (predict_type 3) --------------------------------
// Bridges the serving trees to the native TreeSHAP kernel
// (native/shap.cpp — the reference's kPredictContrib path,
// src/application/predictor.hpp:31).

double SubtreeW(const Tree& t, int node) {
  if (node < 0) {
    size_t i = static_cast<size_t>(~node);
    return i < t.leaf_count.size() ? t.leaf_count[i] : 0.0;
  }
  size_t i = static_cast<size_t>(node);
  return i < t.internal_count.size() ? t.internal_count[i] : 0.0;
}

double ExpectedValue(const Tree& t, int node) {
  if (node < 0) return t.leaf_value[~node];
  double lw = SubtreeW(t, t.left_child[node]);
  double rw = SubtreeW(t, t.right_child[node]);
  double tot = lw + rw;
  if (tot <= 0) return 0.0;
  return (lw * ExpectedValue(t, t.left_child[node]) +
          rw * ExpectedValue(t, t.right_child[node])) / tot;
}

struct ShapTreeArrays {
  std::vector<int32_t> split_feature, decision_type, left_child,
      right_child, cat_boundaries;
  std::vector<double> threshold, leaf_value, leaf_count, internal_count;
  std::vector<uint32_t> cat_threshold;
};

void ToShapArrays(const Tree& t, ShapTreeArrays* a) {
  int ni = t.num_leaves - 1;
  a->split_feature.assign(t.split_feature.begin(), t.split_feature.end());
  a->decision_type.resize(ni);
  for (int i = 0; i < ni; ++i)
    a->decision_type[i] = static_cast<int32_t>(t.decision_type[i]);
  a->left_child.assign(t.left_child.begin(), t.left_child.end());
  a->right_child.assign(t.right_child.begin(), t.right_child.end());
  a->threshold = t.threshold;
  a->leaf_value = t.leaf_value;
  a->leaf_count = t.leaf_count;
  a->internal_count = t.internal_count;
  a->cat_boundaries.assign(t.cat_boundaries.begin(),
                           t.cat_boundaries.end());
  a->cat_threshold = t.cat_threshold;
}

}  // namespace

// native/shap.cpp kernel (same shared library)
extern "C" int lgbm_tree_shap_batch(
    const int32_t* split_feature, const double* threshold_real,
    const int32_t* decision_type, const int32_t* left_child,
    const int32_t* right_child, const double* leaf_value,
    const double* leaf_count, const double* internal_count,
    int32_t n_int, const int32_t* cat_boundaries,
    const uint32_t* cat_threshold, int32_t num_cat, int32_t n_cat_words,
    const double* X, int64_t nrow, int32_t ncol, double* out,
    int64_t out_stride, int32_t nthreads);

namespace {

// dense SHAP contributions over pre-materialized f64 rows:
// out[r, k*(F+1) + f], bias column gets the per-tree expected value
int PredictContribDense(Model* m, const double* X, int64_t nrow,
                        int32_t ncol, int start_iteration,
                        int num_iteration, double* out) {
  int total_iter = m->NumIterations();
  int end_iter = (num_iteration <= 0)
                     ? total_iter
                     : std::min(total_iter,
                                start_iteration + num_iteration);
  int K = m->num_tree_per_iteration;
  int F = m->max_feature_idx + 1;
  if (ncol < F) {
    SetError("pred_contrib: input has fewer columns than the model");
    return -1;
  }
  int64_t stride = static_cast<int64_t>(F + 1) * K;
  std::memset(out, 0, sizeof(double) * nrow * stride);
  ShapTreeArrays a;
  for (int it = start_iteration; it < end_iter; ++it) {
    for (int k = 0; k < K; ++k) {
      const Tree& t = m->trees[it * K + k];
      int ni = t.num_leaves - 1;
      double* base = out + static_cast<int64_t>(k) * (F + 1);
      if (t.num_leaves <= 1) {
        for (int64_t r = 0; r < nrow; ++r)
          base[r * stride + F] += t.leaf_value.empty()
                                      ? 0.0 : t.leaf_value[0];
        continue;
      }
      if (static_cast<int>(t.leaf_count.size()) < t.num_leaves ||
          static_cast<int>(t.internal_count.size()) < ni) {
        SetError("pred_contrib needs leaf_count/internal_count in the "
                 "model text (absent in this model)");
        return -1;
      }
      ToShapArrays(t, &a);
      int rc = lgbm_tree_shap_batch(
          a.split_feature.data(), a.threshold.data(),
          a.decision_type.data(), a.left_child.data(),
          a.right_child.data(), a.leaf_value.data(),
          a.leaf_count.data(), a.internal_count.data(), ni,
          t.num_cat > 0 ? a.cat_boundaries.data() : nullptr,
          t.num_cat > 0 ? a.cat_threshold.data() : nullptr,
          t.num_cat, static_cast<int32_t>(a.cat_threshold.size()), X,
          nrow, ncol, base, stride, g_max_threads);
      if (rc != 0) {
        SetError("tree SHAP kernel failed");
        return -1;
      }
      double ev = ExpectedValue(t, 0);
      for (int64_t r = 0; r < nrow; ++r) base[r * stride + F] += ev;
    }
  }
  return 0;
}

}  // namespace

extern "C" {

typedef void* BoosterHandle;

const char* LGBM_GetLastError() { return g_last_error.c_str(); }

// training side (c_api_train.cpp) shares the error slot and owns its
// handle registry; serving entry points route training handles there
void LgbmTrainSetError(const char* msg) { SetError(msg ? msg : ""); }
int LgbmTrainOwns(void* handle);
int LgbmTrainBoosterFree(void* handle);
int LgbmTrainBoosterIntProp(void* handle, const char* prop, int* out);
int LgbmTrainBoosterPredictForMat(void* handle, const void* data,
                                  int data_type, int32_t nrow,
                                  int32_t ncol, int is_row_major,
                                  int predict_type, int start_iteration,
                                  int num_iteration, int64_t* out_len,
                                  double* out_result);
int LgbmTrainBoosterPredictForCSR(void* handle, const void* indptr,
                                  int indptr_type, const int32_t* indices,
                                  const void* data, int data_type,
                                  int64_t nindptr, int64_t nelem,
                                  int64_t num_col, int predict_type,
                                  int start_iteration, int num_iteration,
                                  int64_t* out_len, double* out_result);
int LgbmTrainBoosterCalcNumPredict(void* handle, int num_row,
                                   int predict_type, int start_iteration,
                                   int num_iteration, int64_t* out_len);
int LgbmTrainBoosterGetFeatureNames(void* handle, const int len,
                                    int* out_len, const size_t buffer_len,
                                    size_t* out_buffer_len,
                                    char** out_strs);
int LgbmTrainBoosterPredictForFile(void* handle,
                                   const char* data_filename,
                                   int data_has_header, int predict_type,
                                   int start_iteration, int num_iteration,
                                   const char* parameter,
                                   const char* result_filename);

int LGBM_BoosterCreateFromModelfile(const char* filename,
                                    int* out_num_iterations,
                                    BoosterHandle* out) {
  std::ifstream f(filename);
  if (!f) {
    SetError(std::string("could not open model file ") + filename);
    return -1;
  }
  std::stringstream ss;
  ss << f.rdbuf();
  Model* m = ParseModelString(ss.str());
  if (!m) {
    SetError(std::string("could not parse model file ") + filename);
    return -1;
  }
  *out_num_iterations = m->NumIterations();
  *out = m;
  return 0;
}

int LGBM_BoosterLoadModelFromString(const char* model_str,
                                    int* out_num_iterations,
                                    BoosterHandle* out) {
  Model* m = ParseModelString(model_str);
  if (!m) {
    SetError("could not parse model string");
    return -1;
  }
  *out_num_iterations = m->NumIterations();
  *out = m;
  return 0;
}

int LGBM_BoosterFree(BoosterHandle handle) {
  if (LgbmTrainOwns(handle)) return LgbmTrainBoosterFree(handle);
  delete static_cast<Model*>(handle);
  return 0;
}

int LGBM_BoosterGetNumClasses(BoosterHandle handle, int* out_len) {
  if (LgbmTrainOwns(handle))
    return LgbmTrainBoosterIntProp(
        handle, "b.num_model_per_iteration()", out_len);
  *out_len = static_cast<Model*>(handle)->num_class;
  return 0;
}

int LGBM_BoosterGetNumFeature(BoosterHandle handle, int* out_len) {
  if (LgbmTrainOwns(handle))
    return LgbmTrainBoosterIntProp(handle, "b.num_feature()", out_len);
  *out_len = static_cast<Model*>(handle)->max_feature_idx + 1;
  return 0;
}

int LGBM_BoosterGetCurrentIteration(BoosterHandle handle, int* out) {
  if (LgbmTrainOwns(handle))
    return LgbmTrainBoosterIntProp(handle, "b.current_iteration()", out);
  *out = static_cast<Model*>(handle)->NumIterations();
  return 0;
}

int LGBM_BoosterNumModelPerIteration(BoosterHandle handle, int* out) {
  if (LgbmTrainOwns(handle))
    return LgbmTrainBoosterIntProp(
        handle, "b.num_model_per_iteration()", out);
  *out = static_cast<Model*>(handle)->num_tree_per_iteration;
  return 0;
}

// predict_type: 0 normal, 1 raw score, 2 leaf index (contrib is served by
// the Python API's pred_contrib; returns -1 here).
int LGBM_BoosterPredictForMat(BoosterHandle handle, const void* data,
                              int data_type, int32_t nrow, int32_t ncol,
                              int is_row_major, int predict_type,
                              int start_iteration, int num_iteration,
                              const char* /*parameter*/, int64_t* out_len,
                              double* out_result) {
  if (LgbmTrainOwns(handle))
    return LgbmTrainBoosterPredictForMat(handle, data, data_type, nrow,
                                         ncol, is_row_major, predict_type,
                                         start_iteration, num_iteration,
                                         out_len, out_result);
  Model* m = static_cast<Model*>(handle);
  if (data_type != 0 && data_type != 1) {
    SetError("only float32 (0) / float64 (1) data are supported");
    return -1;
  }
  if (ncol < m->max_feature_idx + 1) {
    SetError("input has fewer columns than the model's features");
    return -1;
  }
  auto fill = [&](int64_t r, double* row) {
    FillRow(data, data_type, r, ncol, is_row_major, nrow, row);
  };
  return PredictRows(m, fill, nrow, ncol, predict_type, start_iteration,
                     num_iteration, out_len, out_result);
}

int LGBM_BoosterPredictForMatSingleRow(
    BoosterHandle handle, const void* data, int data_type, int ncol,
    int is_row_major, int predict_type, int start_iteration,
    int num_iteration, const char* parameter, int64_t* out_len,
    double* out_result) {
  // ref: c_api.cpp LGBM_BoosterPredictForMatSingleRow — the one-row
  // serving hot path; identical semantics to PredictForMat with nrow=1
  return LGBM_BoosterPredictForMat(handle, data, data_type, 1, ncol,
                                   is_row_major, predict_type,
                                   start_iteration, num_iteration,
                                   parameter, out_len, out_result);
}

int LGBM_BoosterCalcNumPredict(BoosterHandle handle, int num_row,
                               int predict_type, int start_iteration,
                               int num_iteration, int64_t* out_len) {
  // ref: c_api.cpp LGBM_BoosterCalcNumPredict
  if (LgbmTrainOwns(handle))
    return LgbmTrainBoosterCalcNumPredict(handle, num_row, predict_type,
                                          start_iteration, num_iteration,
                                          out_len);
  Model* m = static_cast<Model*>(handle);
  if (!out_len) {
    SetError("CalcNumPredict: null out_len");
    return -1;
  }
  int n_it = m->NumIterations();
  int si = std::min(std::max(start_iteration, 0), n_it);
  int ni = num_iteration <= 0 ? n_it - si
                              : std::min(num_iteration, n_it - si);
  if (ni < 0) ni = 0;
  int K = std::max(m->num_tree_per_iteration, 1);
  int64_t per_row = predict_type == 2   ? int64_t(K) * ni
                    : predict_type == 3 ? int64_t(m->max_feature_idx + 2) * K
                                        : K;
  *out_len = int64_t(num_row) * per_row;
  return 0;
}

int LGBM_BoosterGetFeatureNames(BoosterHandle handle, const int len,
                                int* out_len, const size_t buffer_len,
                                size_t* out_buffer_len, char** out_strs) {
  // ref: c_api.cpp LGBM_BoosterGetFeatureNames (two-call sizing)
  if (LgbmTrainOwns(handle))
    return LgbmTrainBoosterGetFeatureNames(handle, len, out_len,
                                           buffer_len, out_buffer_len,
                                           out_strs);
  Model* m = static_cast<Model*>(handle);
  if (!out_len || !out_buffer_len) {
    SetError("GetFeatureNames: null output argument");
    return -1;
  }
  int nf = m->max_feature_idx + 1;
  *out_len = nf;
  size_t max_needed = 1;
  for (int i = 0; i < nf; ++i) {
    std::string name = i < static_cast<int>(m->feature_names.size())
                           ? m->feature_names[i]
                           : "Column_" + std::to_string(i);
    if (name.size() + 1 > max_needed) max_needed = name.size() + 1;
    if (out_strs && i < len && out_strs[i])
      std::snprintf(out_strs[i], buffer_len, "%s", name.c_str());
  }
  *out_buffer_len = max_needed;
  return 0;
}

int LGBM_BoosterPredictForFile(BoosterHandle handle,
                               const char* data_filename,
                               int data_has_header, int predict_type,
                               int start_iteration, int num_iteration,
                               const char* parameter,
                               const char* result_filename) {
  // ref: c_api.cpp LGBM_BoosterPredictForFile. Serving handles parse a
  // simple numeric CSV/TSV themselves (interpreter-free): one prediction
  // line per data row, tab-separated; a leading extra column (the CLI's
  // label-first layout) is skipped when the file has exactly
  // num_features+1 columns.
  if (LgbmTrainOwns(handle))
    return LgbmTrainBoosterPredictForFile(
        handle, data_filename, data_has_header, predict_type,
        start_iteration, num_iteration, parameter, result_filename);
  Model* m = static_cast<Model*>(handle);
  if (!data_filename || !result_filename) {
    SetError("PredictForFile: null filename");
    return -1;
  }
  std::ifstream in(data_filename);
  if (!in) {
    SetError(std::string("could not open data file ") + data_filename);
    return -1;
  }
  std::ofstream outf(result_filename);
  if (!outf) {
    SetError(std::string("could not open result file ") +
             result_filename);
    return -1;
  }
  int nf = m->max_feature_idx + 1;
  // prediction parameters (ref: c_api.cpp applies Config to the
  // Predictor): the shape check is the one that changes file-predict
  // semantics — short/long rows are an error unless
  // predict_disable_shape_check=true (ref: config.h
  // predict_disable_shape_check)
  bool disable_shape_check = false;
  if (parameter) {
    std::string ps(parameter);
    for (const char* key : {"predict_disable_shape_check=true",
                            "predict_disable_shape_check=True",
                            "predict_disable_shape_check=1"})
      if (ps.find(key) != std::string::npos) disable_shape_check = true;
  }
  std::string line;
  bool first = true;
  int64_t line_no = 0;
  std::vector<double> row;
  while (std::getline(in, line)) {
    ++line_no;
    if (first && data_has_header) {
      first = false;
      continue;
    }
    first = false;
    if (line.empty()) continue;
    row.clear();
    const char* p = line.c_str();
    char* e = nullptr;
    while (*p) {
      while (*p == ',' || *p == '\t' || *p == ' ') ++p;
      if (!*p) break;
      double v = std::strtod(p, &e);
      if (e == p) break;  // non-numeric tail
      row.push_back(v);
      p = e;
    }
    size_t off = row.size() == static_cast<size_t>(nf) + 1 ? 1 : 0;
    if (!disable_shape_check && row.size() != static_cast<size_t>(nf) &&
        row.size() != static_cast<size_t>(nf) + 1) {
      SetError("data line " + std::to_string(line_no) + " has " +
               std::to_string(row.size()) + " columns, but the model "
               "needs " + std::to_string(nf) + " features (set "
               "predict_disable_shape_check=true to zero-fill instead)");
      return -1;
    }
    std::vector<double> feats(nf, 0.0);
    for (int j = 0; j < nf && off + j < row.size(); ++j)
      feats[j] = row[off + j];
    auto fill = [&](int64_t, double* dst) {
      for (int j = 0; j < nf; ++j) dst[j] = feats[j];
    };
    int64_t out_len = 0;
    std::vector<double> pred(
        static_cast<size_t>(std::max(m->num_tree_per_iteration, 1)) *
        std::max(m->NumIterations(), 1) *
        static_cast<size_t>(m->max_feature_idx + 2));
    if (PredictRows(m, fill, 1, nf, predict_type, start_iteration,
                    num_iteration, &out_len, pred.data()) != 0)
      return -1;
    for (int64_t j = 0; j < out_len; ++j) {
      if (j) outf << '\t';
      char buf[32];
      std::snprintf(buf, sizeof(buf), "%.17g", pred[j]);
      outf << buf;
    }
    outf << '\n';
  }
  return 0;
}

// CSR prediction without densifying the matrix (≡ the reference's
// PredictForCSR row iteration, src/c_api.cpp RowFunctionFromCSR): each
// row's dense buffer is filled from its index slice only.
int LGBM_BoosterPredictForCSR(BoosterHandle handle, const void* indptr,
                              int indptr_type, const int32_t* indices,
                              const void* data, int data_type,
                              int64_t nindptr, int64_t nelem,
                              int64_t num_col, int predict_type,
                              int start_iteration, int num_iteration,
                              const char* /*parameter*/, int64_t* out_len,
                              double* out_result) {
  (void)nelem;
  if (LgbmTrainOwns(handle))
    return LgbmTrainBoosterPredictForCSR(
        handle, indptr, indptr_type, indices, data, data_type, nindptr,
        nelem, num_col, predict_type, start_iteration, num_iteration,
        out_len, out_result);
  Model* m = static_cast<Model*>(handle);
  if (data_type != 0 && data_type != 1) {
    SetError("only float32 (0) / float64 (1) data are supported");
    return -1;
  }
  if (indptr_type != 2 && indptr_type != 3) {
    SetError("indptr_type must be int32 (2) or int64 (3)");
    return -1;
  }
  if (num_col < m->max_feature_idx + 1) {
    SetError("input has fewer columns than the model's features");
    return -1;
  }
  int64_t nrow = nindptr - 1;
  auto ptr_at = [&](int64_t i) -> int64_t {
    return indptr_type == 2
               ? static_cast<const int32_t*>(indptr)[i]
               : static_cast<const int64_t*>(indptr)[i];
  };
  auto fill = [&](int64_t r, double* row) {
    for (int64_t c = 0; c < num_col; ++c) row[c] = 0.0;
    for (int64_t k = ptr_at(r); k < ptr_at(r + 1); ++k) {
      double v = data_type == 0 ? static_cast<const float*>(data)[k]
                                : static_cast<const double*>(data)[k];
      if (indices[k] >= 0 && indices[k] < num_col) row[indices[k]] = v;
    }
  };
  return PredictRows(m, fill, nrow, num_col, predict_type,
                     start_iteration, num_iteration, out_len, out_result);
}

// ---- CSC / multi-matrix prediction -------------------------------------

int LGBM_BoosterPredictForCSC(BoosterHandle handle, const void* col_ptr,
                              int col_ptr_type, const int32_t* indices,
                              const void* data, int data_type,
                              int64_t ncol_ptr, int64_t nelem,
                              int64_t num_row, int predict_type,
                              int start_iteration, int num_iteration,
                              const char* parameter, int64_t* out_len,
                              double* out_result) {
  // ref: c_api.h:394 family — column-compressed input; transposed once
  // into per-row (col, value) lists, then the shared row predictor
  (void)parameter;
  if (LgbmTrainOwns(handle)) {
    SetError("PredictForCSC on a training handle: save the model and "
             "load it through a serving handle");
    return -1;
  }
  Model* m = static_cast<Model*>(handle);
  if (data_type != 0 && data_type != 1) {
    SetError("only float32 (0) / float64 (1) data are supported");
    return -1;
  }
  if (col_ptr_type != 2 && col_ptr_type != 3) {
    SetError("col_ptr_type must be int32 (2) or int64 (3)");
    return -1;
  }
  int64_t ncol = ncol_ptr - 1;
  if (ncol < m->max_feature_idx + 1) {
    SetError("input has fewer columns than the model's features");
    return -1;
  }
  auto ptr_at = [&](int64_t i) -> int64_t {
    return col_ptr_type == 2
               ? static_cast<const int32_t*>(col_ptr)[i]
               : static_cast<const int64_t*>(col_ptr)[i];
  };
  // CSC -> CSR transpose (counts, prefix, scatter)
  std::vector<int64_t> rptr(num_row + 1, 0);
  for (int64_t k = 0; k < nelem; ++k)
    if (indices[k] >= 0 && indices[k] < num_row) ++rptr[indices[k] + 1];
  for (int64_t r = 0; r < num_row; ++r) rptr[r + 1] += rptr[r];
  std::vector<int32_t> rcol(static_cast<size_t>(nelem));
  std::vector<double> rval(static_cast<size_t>(nelem));
  std::vector<int64_t> cur(rptr.begin(), rptr.end() - 1);
  for (int64_t c = 0; c < ncol; ++c) {
    for (int64_t k = ptr_at(c); k < ptr_at(c + 1); ++k) {
      int64_t r = indices[k];
      if (r < 0 || r >= num_row) continue;
      double v = data_type == 0 ? static_cast<const float*>(data)[k]
                                : static_cast<const double*>(data)[k];
      rcol[cur[r]] = static_cast<int32_t>(c);
      rval[cur[r]] = v;
      ++cur[r];
    }
  }
  auto fill = [&](int64_t r, double* row) {
    for (int64_t c = 0; c < ncol; ++c) row[c] = 0.0;
    for (int64_t k = rptr[r]; k < rptr[r + 1]; ++k) row[rcol[k]] = rval[k];
  };
  return PredictRows(m, fill, num_row, ncol, predict_type,
                     start_iteration, num_iteration, out_len, out_result);
}

int LGBM_BoosterPredictForMats(BoosterHandle handle, const void** data,
                               int data_type, int32_t nrow, int32_t ncol,
                               int predict_type, int start_iteration,
                               int num_iteration, const char* parameter,
                               int64_t* out_len, double* out_result) {
  // ref: c_api.h PredictForMats — array of row pointers
  (void)parameter;
  if (LgbmTrainOwns(handle)) {
    SetError("PredictForMats on a training handle: save the model and "
             "load it through a serving handle");
    return -1;
  }
  Model* m = static_cast<Model*>(handle);
  if (data_type != 0 && data_type != 1) {
    SetError("only float32 (0) / float64 (1) data are supported");
    return -1;
  }
  if (ncol < m->max_feature_idx + 1) {
    SetError("input has fewer columns than the model's features");
    return -1;
  }
  auto fill = [&](int64_t r, double* row) {
    if (data_type == 0) {
      const float* d = static_cast<const float*>(data[r]);
      for (int32_t c = 0; c < ncol; ++c) row[c] = d[c];
    } else {
      const double* d = static_cast<const double*>(data[r]);
      for (int32_t c = 0; c < ncol; ++c) row[c] = d[c];
    }
  };
  return PredictRows(m, fill, nrow, ncol, predict_type, start_iteration,
                     num_iteration, out_len, out_result);
}

// ---- single-row fast paths (ref: c_api.h:1211-1428) --------------------
// A FastConfig freezes (model, predict type, iteration range, layout) so
// per-row calls skip all setup. Prediction state is call-local, so Fast
// calls are thread-safe (ref precedent: tests/cpp_tests/test_single_row
// .cpp exercises concurrent single-row prediction).

typedef void* FastConfigHandle;

int LGBM_BoosterPredictForMatSingleRowFastInit(
    BoosterHandle handle, const int predict_type,
    const int start_iteration, const int num_iteration,
    const int data_type, const int32_t ncol, const char* parameter,
    FastConfigHandle* out_fastConfig) {
  (void)parameter;
  if (LgbmTrainOwns(handle)) {
    SetError("SingleRowFastInit on a training handle: save the model "
             "and load it through a serving handle");
    return -1;
  }
  if (!out_fastConfig || (data_type != 0 && data_type != 1)) {
    SetError("SingleRowFastInit: bad arguments");
    return -1;
  }
  Model* fm = static_cast<Model*>(handle);
  if (ncol < fm->max_feature_idx + 1) {
    SetError("input has fewer columns than the model's features");
    return -1;
  }
  auto* fc = new FastConfig{fm, predict_type, start_iteration,
                            num_iteration, data_type, ncol};
  *out_fastConfig = fc;
  return 0;
}

int LGBM_BoosterPredictForMatSingleRowFast(FastConfigHandle fastConfig,
                                           const void* data,
                                           int64_t* out_len,
                                           double* out_result) {
  auto* fc = static_cast<FastConfig*>(fastConfig);
  if (!fc || !data || !out_len || !out_result) {
    SetError("SingleRowFast: bad arguments");
    return -1;
  }
  auto fill = [&](int64_t, double* row) {
    FillRow(data, fc->data_type, 0, static_cast<int32_t>(fc->ncol), 1, 1,
            row);
  };
  return PredictRows(fc->model, fill, 1, fc->ncol, fc->predict_type,
                     fc->start_iteration, fc->num_iteration, out_len,
                     out_result);
}

int LGBM_BoosterPredictForCSRSingleRow(
    BoosterHandle handle, const void* indptr, int indptr_type,
    const int32_t* indices, const void* data, int data_type,
    int64_t nindptr, int64_t nelem, int64_t num_col, int predict_type,
    int start_iteration, int num_iteration, const char* parameter,
    int64_t* out_len, double* out_result) {
  return LGBM_BoosterPredictForCSR(handle, indptr, indptr_type, indices,
                                   data, data_type, nindptr, nelem,
                                   num_col, predict_type,
                                   start_iteration, num_iteration,
                                   parameter, out_len, out_result);
}

int LGBM_BoosterPredictForCSRSingleRowFastInit(
    BoosterHandle handle, const int predict_type,
    const int start_iteration, const int num_iteration,
    const int data_type, const int64_t num_col, const char* parameter,
    FastConfigHandle* out_fastConfig) {
  return LGBM_BoosterPredictForMatSingleRowFastInit(
      handle, predict_type, start_iteration, num_iteration, data_type,
      static_cast<int32_t>(num_col), parameter, out_fastConfig);
}

int LGBM_BoosterPredictForCSRSingleRowFast(
    FastConfigHandle fastConfig, const void* indptr,
    const int indptr_type, const int32_t* indices, const void* data,
    const int64_t nindptr, const int64_t nelem, int64_t* out_len,
    double* out_result) {
  auto* fc = static_cast<FastConfig*>(fastConfig);
  if (!fc || !indptr || !out_len || !out_result) {
    SetError("CSRSingleRowFast: bad arguments");
    return -1;
  }
  return LGBM_BoosterPredictForCSR(
      fc->model, indptr, indptr_type, indices, data, fc->data_type,
      nindptr, nelem, fc->ncol, fc->predict_type, fc->start_iteration,
      fc->num_iteration, "", out_len, out_result);
}

int LGBM_FastConfigFree(FastConfigHandle fastConfig) {
  delete static_cast<FastConfig*>(fastConfig);
  return 0;
}

// ---- sparse-output contrib (ref: c_api.h:1117) -------------------------

int LGBM_BoosterPredictSparseOutput(
    BoosterHandle handle, const void* indptr, int indptr_type,
    const int32_t* indices, const void* data, int data_type,
    int64_t nindptr, int64_t nelem, int64_t num_col_or_row,
    int predict_type, int start_iteration, int num_iteration,
    const char* parameter, int matrix_type, int64_t* out_len,
    void** out_indptr, int32_t** out_indices, void** out_data) {
  (void)parameter;
  (void)nelem;
  if (LgbmTrainOwns(handle)) {
    SetError("PredictSparseOutput on a training handle: save the model "
             "and load it through a serving handle");
    return -1;
  }
  if (predict_type != 3) {
    SetError("PredictSparseOutput supports only feature contributions "
             "(predict_type=3)");
    return -1;
  }
  if (matrix_type != 0) {  // C_API_MATRIX_TYPE_CSR
    SetError("PredictSparseOutput: only CSR matrix_type (0) is "
             "supported");
    return -1;
  }
  if (indptr_type != 2 && indptr_type != 3) {
    SetError("indptr_type must be int32 (2) or int64 (3)");
    return -1;
  }
  Model* m = static_cast<Model*>(handle);
  int64_t nrow = nindptr - 1;
  int64_t ncol = num_col_or_row;
  int K = m->num_tree_per_iteration;
  int F = m->max_feature_idx + 1;
  auto ptr_at = [&](int64_t i) -> int64_t {
    return indptr_type == 2
               ? static_cast<const int32_t*>(indptr)[i]
               : static_cast<const int64_t*>(indptr)[i];
  };
  std::vector<double> X(static_cast<size_t>(nrow) * ncol, 0.0);
  for (int64_t r = 0; r < nrow; ++r)
    for (int64_t k = ptr_at(r); k < ptr_at(r + 1); ++k)
      if (indices[k] >= 0 && indices[k] < ncol) {
        double v = data_type == 0 ? static_cast<const float*>(data)[k]
                                  : static_cast<const double*>(data)[k];
        X[r * ncol + indices[k]] = v;
      }
  int64_t stride = static_cast<int64_t>(F + 1) * K;
  std::vector<double> dense(static_cast<size_t>(nrow) * stride);
  if (PredictContribDense(m, X.data(), nrow, static_cast<int32_t>(ncol),
                          start_iteration, num_iteration,
                          dense.data()) != 0)
    return -1;
  // compress nonzeros row-wise; output rows are nrow*K "class rows" of
  // width F+1 (reference sparse-contrib layout)
  int64_t out_rows = nrow * K;
  std::vector<int64_t> iptr(out_rows + 1, 0);
  int64_t nnz = 0;
  for (int64_t r = 0; r < nrow; ++r)
    for (int k = 0; k < K; ++k) {
      const double* row = dense.data() + r * stride +
                          static_cast<int64_t>(k) * (F + 1);
      for (int f = 0; f <= F; ++f)
        if (row[f] != 0.0) ++nnz;
      iptr[r * K + k + 1] = nnz;
    }
  // output indptr matches the INPUT indptr type (reference ABI)
  void* o_iptr = nullptr;
  if (indptr_type == 2) {
    auto* p32 = static_cast<int32_t*>(
        std::malloc(sizeof(int32_t) * (out_rows + 1)));
    if (p32)
      for (int64_t i = 0; i <= out_rows; ++i)
        p32[i] = static_cast<int32_t>(iptr[i]);
    o_iptr = p32;
  } else {
    auto* p64 = static_cast<int64_t*>(
        std::malloc(sizeof(int64_t) * (out_rows + 1)));
    if (p64)
      std::memcpy(p64, iptr.data(), sizeof(int64_t) * (out_rows + 1));
    o_iptr = p64;
  }
  auto* o_idx = static_cast<int32_t*>(
      std::malloc(sizeof(int32_t) * std::max<int64_t>(nnz, 1)));
  auto* o_val = static_cast<double*>(
      std::malloc(sizeof(double) * std::max<int64_t>(nnz, 1)));
  if (!o_iptr || !o_idx || !o_val) {
    std::free(o_iptr);
    std::free(o_idx);
    std::free(o_val);
    SetError("PredictSparseOutput: allocation failed");
    return -1;
  }
  int64_t w = 0;
  for (int64_t r = 0; r < nrow; ++r)
    for (int k = 0; k < K; ++k) {
      const double* row = dense.data() + r * stride +
                          static_cast<int64_t>(k) * (F + 1);
      for (int f = 0; f <= F; ++f)
        if (row[f] != 0.0) {
          o_idx[w] = f;
          o_val[w] = row[f];
          ++w;
        }
    }
  out_len[0] = nnz;            // data / indices length
  out_len[1] = out_rows + 1;   // indptr length
  *out_indptr = o_iptr;
  *out_indices = o_idx;
  *out_data = o_val;
  return 0;
}

int LGBM_BoosterFreePredictSparse(void* indptr, int32_t* indices,
                                  void* data, int indptr_type,
                                  int data_type) {
  (void)indptr_type;
  (void)data_type;
  std::free(indptr);
  std::free(indices);
  std::free(data);
  return 0;
}

// ---- model bounds / introspection --------------------------------------

int LGBM_BoosterGetLowerBoundValue(BoosterHandle handle,
                                   double* out_results) {
  // ref: gbdt.h GetLowerBoundValue — sum of per-tree minimum leaf
  if (LgbmTrainOwns(handle)) {
    SetError("GetLowerBoundValue: use a serving handle");
    return -1;
  }
  Model* m = static_cast<Model*>(handle);
  double s = 0.0;
  for (const Tree& t : m->trees) {
    double mn = t.leaf_value.empty() ? 0.0 : t.leaf_value[0];
    for (double v : t.leaf_value) mn = std::min(mn, v);
    s += mn;
  }
  *out_results = s;
  return 0;
}

int LGBM_BoosterGetUpperBoundValue(BoosterHandle handle,
                                   double* out_results) {
  if (LgbmTrainOwns(handle)) {
    SetError("GetUpperBoundValue: use a serving handle");
    return -1;
  }
  Model* m = static_cast<Model*>(handle);
  double s = 0.0;
  for (const Tree& t : m->trees) {
    double mx = t.leaf_value.empty() ? 0.0 : t.leaf_value[0];
    for (double v : t.leaf_value) mx = std::max(mx, v);
    s += mx;
  }
  *out_results = s;
  return 0;
}

int LgbmTrainBoosterGetLinear(void* handle, int* out);

int LGBM_BoosterGetLinear(BoosterHandle handle, int* out) {
  if (LgbmTrainOwns(handle))
    return LgbmTrainBoosterGetLinear(handle, out);
  Model* m = static_cast<Model*>(handle);
  int lin = 0;
  for (const Tree& t : m->trees)
    if (t.is_linear) lin = 1;
  *out = lin;
  return 0;
}

int LGBM_BoosterValidateFeatureNames(BoosterHandle handle,
                                     const char** data_names,
                                     int data_num_features) {
  // ref: c_api.h:935 — error when names don't match the training names
  if (LgbmTrainOwns(handle)) {
    SetError("ValidateFeatureNames: use a serving handle");
    return -1;
  }
  Model* m = static_cast<Model*>(handle);
  int n_model = static_cast<int>(m->feature_names.size());
  if (n_model && data_num_features != n_model) {
    SetError("feature count mismatch: model has " +
             std::to_string(n_model) + ", data has " +
             std::to_string(data_num_features));
    return -1;
  }
  for (int i = 0; i < n_model && data_names; ++i) {
    if (!data_names[i] || m->feature_names[i] != data_names[i]) {
      SetError("feature name mismatch at index " + std::to_string(i) +
               ": model '" + m->feature_names[i] + "' vs data '" +
               (data_names[i] ? data_names[i] : "<null>") + "'");
      return -1;
    }
  }
  return 0;
}

// ---- process-level utilities -------------------------------------------

int LGBM_SetLastError(const char* msg) {
  SetError(msg ? msg : "");
  return 0;
}

int LGBM_SetMaxThreads(int num_threads) {
  g_max_threads = num_threads;
  return 0;
}

int LGBM_GetMaxThreads(int* out) {
  if (!out) return -1;
  *out = g_max_threads;
  return 0;
}

int LGBM_RegisterLogCallback(void (*callback)(const char*)) {
  // ref: c_api.h:82 — the training backend also routes the embedded
  // interpreter's logger into this callback (c_api_train.cpp)
  g_log_callback = callback;
  return 0;
}

// internal accessor for the training backend's logger bridge
void* LgbmGetLogCallback() {
  return reinterpret_cast<void*>(g_log_callback);
}

int LGBM_GetSampleCount(int32_t num_total_row, const char* parameters,
                        int* out) {
  // ref: c_api.cpp LGBM_GetSampleCount — min(bin_construct_sample_cnt,
  // num_total_row)
  if (!out) {
    SetError("GetSampleCount: null out");
    return -1;
  }
  int cnt = 200000;  // config.h bin_construct_sample_cnt default
  if (parameters) {
    std::string ps(parameters);
    auto pos = ps.find("bin_construct_sample_cnt=");
    if (pos != std::string::npos)
      cnt = std::atoi(ps.c_str() + pos + 25);
  }
  if (cnt <= 0) {  // reference config validation: must be positive
    SetError("bin_construct_sample_cnt must be positive");
    return -1;
  }
  *out = std::min<int32_t>(cnt, std::max<int32_t>(num_total_row, 0));
  return 0;
}

int LGBM_SampleIndices(int32_t num_total_row, const char* parameters,
                       void* out, int32_t* out_len) {
  // ref: c_api.cpp LGBM_SampleIndices — Random(seed).Sample sorted
  // unique indices
  if (!out || !out_len) {
    SetError("SampleIndices: null out");
    return -1;
  }
  int cnt = 0;
  if (LGBM_GetSampleCount(num_total_row, parameters, &cnt) != 0)
    return -1;
  int seed = 1;  // config.h data_random_seed default
  if (parameters) {
    std::string ps(parameters);
    auto pos = ps.find("data_random_seed=");
    if (pos != std::string::npos)
      seed = std::atoi(ps.c_str() + pos + 17);
  }
  // reservoir-free uniform sample without replacement, then sort —
  // selection probability matches the reference's Random::Sample
  std::vector<int32_t> idx(num_total_row);
  for (int32_t i = 0; i < num_total_row; ++i) idx[i] = i;
  uint64_t st = static_cast<uint64_t>(seed) * 6364136223846793005ULL + 1;
  for (int32_t i = 0; i < cnt && i < num_total_row; ++i) {
    st = st * 6364136223846793005ULL + 1442695040888963407ULL;
    int32_t j = i + static_cast<int32_t>((st >> 33) %
                                         (num_total_row - i));
    std::swap(idx[i], idx[j]);
  }
  std::sort(idx.begin(), idx.begin() + cnt);
  std::memcpy(out, idx.data(), sizeof(int32_t) * cnt);
  *out_len = cnt;
  return 0;
}

}  // extern "C"
