// Native TreeSHAP (pred_contrib) batch kernel.
//
// Row-parallel exact TreeSHAP over structure-of-arrays host trees — the
// framework's equivalent of the reference's OMP per-row predictor
// (ref: src/application/predictor.hpp:31 kPredictContrib dispatch,
// src/io/tree.cpp Tree::TreeSHAP recursion / EXTEND-UNWIND algebra,
// Lundberg & Lee). The algebra matches core/shap.py's scalar recursion
// operation-for-operation in double precision, so the Python batch path
// and this kernel agree to rounding.
//
// Rows are independent: a std::thread pool walks disjoint row blocks
// (the reference's `#pragma omp parallel for` over rows).

#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct Tree {
  const int32_t* split_feature;   // [n_int]
  const double* threshold_real;   // [n_int]
  const int32_t* decision_type;   // [n_int]
  const int32_t* left_child;      // [n_int]
  const int32_t* right_child;     // [n_int]
  const double* leaf_value;       // [n_int + 1]
  const double* leaf_count;       // [n_int + 1]
  const double* internal_count;   // [n_int]
  int32_t n_int;
  const int32_t* cat_boundaries;  // [num_cat + 1] or null
  const uint32_t* cat_threshold;  // words or null
  int32_t num_cat;
  int32_t n_cat_words;
};

struct PathEl {
  int feature;
  double zero, one, pweight;
};

double SubtreeWeight(const Tree& t, int node) {
  return node < 0 ? t.leaf_count[~node] : t.internal_count[node];
}

// which child does row x take at internal node? (mirrors
// core/tree.py HostTree traversal + core/shap.py _decision_path)
bool DecideLeft(const Tree& t, int node, const double* x) {
  const int f = t.split_feature[node];
  const int dt = t.decision_type[node];
  const double v = x[f];
  const bool is_nan = std::isnan(v);
  const bool dl = (dt & 2) != 0;
  const int mtype = (dt >> 2) & 3;
  const double v0 = is_nan ? 0.0 : v;
  if (dt & 1) {  // categorical: bitset membership on the raw value
    long cat_idx = static_cast<long>(t.threshold_real[node]);
    const long max_idx = t.num_cat > 0 ? t.num_cat - 1 : 0;
    if (cat_idx < 0) cat_idx = 0;
    if (cat_idx > max_idx) cat_idx = max_idx;
    const long vv = (is_nan || v0 < 0) ? -1
                    : static_cast<long>(std::floor(v0));
    if (vv < 0 || t.cat_boundaries == nullptr) return false;
    const long lo = t.cat_boundaries[cat_idx];
    const long hi = t.cat_boundaries[cat_idx + 1];
    const long word = lo + (vv >> 5);
    if (word >= hi || word >= t.n_cat_words) return false;
    return ((t.cat_threshold[word] >> (vv & 31)) & 1u) != 0;
  }
  if (mtype == 2 && is_nan) return dl;
  if (mtype == 1 && std::fabs(v0) <= 1e-35) return dl;
  return v0 <= t.threshold_real[node];
}

// ref: core/shap.py _extend (tree.cpp TreeSHAP EXTEND)
void Extend(PathEl* path, int d, double pz, double po, int pf) {
  path[d].feature = pf;
  path[d].zero = pz;
  path[d].one = po;
  path[d].pweight = d == 0 ? 1.0 : 0.0;
  for (int i = d - 1; i >= 0; --i) {
    path[i + 1].pweight +=
        po * path[i].pweight * (i + 1) / static_cast<double>(d + 1);
    path[i].pweight =
        pz * path[i].pweight * (d - i) / static_cast<double>(d + 1);
  }
}

// ref: core/shap.py _unwind
void Unwind(PathEl* path, int d, int pi) {
  const double one = path[pi].one;
  const double zero = path[pi].zero;
  double next_one = path[d].pweight;
  for (int i = d - 1; i >= 0; --i) {
    if (one != 0) {
      const double tmp = path[i].pweight;
      path[i].pweight = next_one * (d + 1) / ((i + 1) * one);
      next_one = tmp - path[i].pweight * zero * (d - i) /
                           static_cast<double>(d + 1);
    } else {
      path[i].pweight =
          path[i].pweight * (d + 1) / (zero * (d - i));
    }
  }
  for (int i = pi; i < d; ++i) {
    path[i].feature = path[i + 1].feature;
    path[i].zero = path[i + 1].zero;
    path[i].one = path[i + 1].one;
  }
}

// ref: core/shap.py _unwound_path_sum
double UnwoundSum(const PathEl* path, int d, int pi) {
  const double one = path[pi].one;
  const double zero = path[pi].zero;
  double next_one = path[d].pweight;
  double total = 0.0;
  for (int i = d - 1; i >= 0; --i) {
    if (one != 0) {
      const double tmp = next_one * (d + 1) / ((i + 1) * one);
      total += tmp;
      next_one = path[i].pweight -
                 tmp * zero * ((d - i) / static_cast<double>(d + 1));
    } else {
      total += (path[i].pweight / zero) /
               ((d - i) / static_cast<double>(d + 1));
    }
  }
  return total;
}

// ref: core/shap.py _tree_shap (tree.cpp Tree::TreeSHAP)
void TreeShap(const Tree& t, const double* x, double* phi, int node,
              int d, const PathEl* parent, double pz, double po, int pf,
              PathEl* arena) {
  PathEl* path = arena;
  for (int i = 0; i < d; ++i) path[i] = parent[i];
  Extend(path, d, pz, po, pf);

  if (node < 0) {
    const double leaf_val = t.leaf_value[~node];
    for (int i = 1; i <= d; ++i) {
      const double w = UnwoundSum(path, d, i);
      phi[path[i].feature] +=
          w * (path[i].one - path[i].zero) * leaf_val;
    }
    return;
  }

  const bool left_hot = DecideLeft(t, node, x);
  const int hot = left_hot ? t.left_child[node] : t.right_child[node];
  const int cold = left_hot ? t.right_child[node] : t.left_child[node];
  const double wn = SubtreeWeight(t, node);
  const double hz = wn != 0 ? SubtreeWeight(t, hot) / wn : 0.0;
  const double cz = wn != 0 ? SubtreeWeight(t, cold) / wn : 0.0;
  double iz = 1.0, io = 1.0;
  const int f = t.split_feature[node];
  int pi = d + 1;
  for (int i = 0; i <= d; ++i) {
    if (path[i].feature == f) {
      pi = i;
      break;
    }
  }
  if (pi <= d) {
    iz = path[pi].zero;
    io = path[pi].one;
    Unwind(path, d, pi);
    --d;
  }
  PathEl* child_arena = arena + d + 2;
  TreeShap(t, x, phi, hot, d + 1, path, hz * iz, io, f, child_arena);
  TreeShap(t, x, phi, cold, d + 1, path, cz * iz, 0.0, f, child_arena);
}

}  // namespace

extern "C" {

// Accumulates exact TreeSHAP contributions of one tree into
// out[row * out_stride + feature] for every row; the bias column
// (expected value) is the caller's job. Returns 0 on success.
int lgbm_tree_shap_batch(
    const int32_t* split_feature, const double* threshold_real,
    const int32_t* decision_type, const int32_t* left_child,
    const int32_t* right_child, const double* leaf_value,
    const double* leaf_count, const double* internal_count,
    int32_t n_int, const int32_t* cat_boundaries,
    const uint32_t* cat_threshold, int32_t num_cat,
    int32_t n_cat_words, const double* X, int64_t nrow, int32_t ncol,
    double* out, int64_t out_stride, int32_t nthreads) {
  if (n_int <= 0) return 0;
  Tree t{split_feature, threshold_real, decision_type, left_child,
         right_child,   leaf_value,     leaf_count,    internal_count,
         n_int,         cat_boundaries, cat_threshold, num_cat,
         n_cat_words};
  // arena size: level l's path slice needs <= l + 2 slots, and the
  // recursion depth is the tree's REAL max depth (a path-shaped
  // 4096-leaf tree would need gigabytes if sized by n_int^2)
  std::vector<int32_t> depth(static_cast<size_t>(n_int), 0);
  int32_t max_d = 0;
  for (int32_t nd = 0; nd < n_int; ++nd) {  // parents precede children
    const int32_t d = depth[nd];
    if (d > max_d) max_d = d;
    const int32_t lc = left_child[nd], rc = right_child[nd];
    if (lc >= 0 && lc < n_int) depth[lc] = d + 1;
    if (rc >= 0 && rc < n_int) depth[rc] = d + 1;
  }
  // levels 0..max_d+1 (leaf extend adds one), each <= level + 2 slots
  const size_t levels = static_cast<size_t>(max_d) + 3;
  const size_t arena_elems = levels * (levels + 3) / 2 + 4;
  if (nthreads <= 0) {
    unsigned hw = std::thread::hardware_concurrency();
    nthreads = hw ? static_cast<int32_t>(hw) : 1;
  }
  if (nthreads > nrow) nthreads = static_cast<int32_t>(nrow ? nrow : 1);

  auto worker = [&](int64_t lo, int64_t hi) {
    std::vector<PathEl> arena(arena_elems);
    for (int64_t r = lo; r < hi; ++r) {
      TreeShap(t, X + r * ncol, out + r * out_stride, 0, 0, nullptr,
               1.0, 1.0, -1, arena.data());
    }
  };
  if (nthreads <= 1) {
    worker(0, nrow);
    return 0;
  }
  std::vector<std::thread> threads;
  const int64_t block = (nrow + nthreads - 1) / nthreads;
  for (int32_t i = 0; i < nthreads; ++i) {
    const int64_t lo = i * block;
    const int64_t hi = lo + block < nrow ? lo + block : nrow;
    if (lo >= hi) break;
    threads.emplace_back(worker, lo, hi);
  }
  for (auto& th : threads) th.join();
  return 0;
}

}  // extern "C"
